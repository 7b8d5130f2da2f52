"""The window over the steps completed in it, ms a step (host clock)."""


def read(run):
    if run.kind != "train" or run.units == 0:
        return None
    return 1e3 * run.window_s / run.units
