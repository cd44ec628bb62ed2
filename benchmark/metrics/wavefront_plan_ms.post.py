"""wavefront_plan_ms.post: milliseconds a post-processing table of the
window spent in the program's timer section(s) wavefront-plan (``g_timer``:
the host's active-set plan of the pair recursion's wavefront, its BFS over
the whole cluster); none where they did not run."""


def read(run):
    return run.section_ms("wavefront-plan")
