"""terminators_ms.post: milliseconds a job of the window spent in the
program's timer section(s) terminators (``g_timer``: the host's zsqr and
terminator fits of the pair chains); none where they did not run."""


def read(run):
    return run.section_ms("terminators")
