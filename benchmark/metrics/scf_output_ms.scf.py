"""scf_output_ms.scf: milliseconds a job of the window spent in the program's
timer section(s) scf-output (``g_timer``: totaldos.out and the per-atom DOS
files, the input's Fermi line, the checkpoints); none where they did not
run."""


def read(run):
    return run.section_ms("scf-output")
