"""bands_ms.scf: milliseconds a job of the window spent in the program's timer
section(s) bands (``g_timer``: the Bands construction, the Fermi search, the
moments, the mixing and the electrostatics); none where they did not run."""


def read(run):
    return run.section_ms("bands")
