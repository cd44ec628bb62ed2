"""recursion_ms.scf: milliseconds a job of the window spent in the program's timer
section(s) block-recursion, chebyshev-recursion (``g_timer``); none where they did not run."""


def read(run):
    return run.section_ms("block-recursion", "chebyshev-recursion")
