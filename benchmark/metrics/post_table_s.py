"""post_table_s: the window's seconds over the post-processing tables
completed in it."""


def read(run):
    return run.window_s / run.n_jobs
