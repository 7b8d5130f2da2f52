"""Percent of the configuration's peak FLOP/s: 3 times the forward's conv
FLOPs of the untraced window's steps (work/flops.py) over its length."""

from portbench.readers import mfu


def read(run):
    return mfu(run, "train")
