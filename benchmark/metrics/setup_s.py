"""setup_s: seconds from the process's start to the end of the warm-up job."""


def read(run):
    return run.setup_s
