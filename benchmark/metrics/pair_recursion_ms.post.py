"""pair_recursion_ms.post: milliseconds a job of the window spent in the program's timer
section(s) pair-recursion (``g_timer``); none where they did not run."""


def read(run):
    return run.section_ms("pair-recursion")
