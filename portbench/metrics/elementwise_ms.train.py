"""Device ms a step in elementwise kernels (the train BatchNorm passes, the
epilogues, Adam), by name group (work/groups.py)."""

from portbench.readers import group_ms


def read(run):
    return group_ms(run, "train", "elementwise")
