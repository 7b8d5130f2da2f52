"""UQ-32 pairs completed over the window, a second (host clock)."""


def read(run):
    if run.kind != "uq" or run.units == 0:
        return None
    return run.units / run.window_s
