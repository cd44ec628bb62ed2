"""intersite_gf_ms.post: milliseconds a job of the window spent in the program's timer
section(s) intersite-gf (``g_timer``); none where they did not run."""


def read(run):
    return run.section_ms("intersite-gf")
