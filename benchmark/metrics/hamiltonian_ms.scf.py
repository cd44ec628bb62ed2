"""hamiltonian_ms.scf: milliseconds a job of the window spent in the program's timer
section(s) build-bulkham (``g_timer``); none where they did not run."""


def read(run):
    return run.section_ms("build-bulkham")
