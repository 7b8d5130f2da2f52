"""The 90th percentile of the window's request latencies, ms (host clock)."""

from portbench.readers import percentile


def read(run):
    if run.kind != "uq" or not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 90)
