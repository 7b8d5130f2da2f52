"""From the process's start to the first timed request or step, s (host clock)."""


def read(run):
    return run.setup_s
