"""Percent of the configuration's peak FLOP/s: the network's conv FLOPs of the
untraced window's requests (work/flops.py) over its length."""

from portbench.readers import mfu


def read(run):
    return mfu(run, "uq")
