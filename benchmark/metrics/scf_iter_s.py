"""scf_iter_s: the window's seconds over the SCF iterations completed in it."""


def read(run):
    return run.window_s / run.n_jobs
