"""Device ms a step in the library (cuDNN) convs, forward and backward, by name
group (work/groups.py)."""

from portbench.readers import group_ms


def read(run):
    return group_ms(run, "train", "conv")
