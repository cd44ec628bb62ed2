"""atomic_scf_ms.scf: milliseconds a job of the window spent in the program's timer
section(s) atomic-scf (``g_timer``); none where they did not run."""


def read(run):
    return run.section_ms("atomic-scf")
