"""wavefront_plan_ms.scf: milliseconds a job of the window spent in the
program's timer section(s) wavefront-plan (``g_timer``: the host's active-set
plan of the wavefront); none where they did not run."""


def read(run):
    return run.section_ms("wavefront-plan")
