"""Device ms a request in elementwise kernels (BatchNorm-free eval glue: casts,
concats, adds, the statistics), by name group (work/groups.py)."""

from portbench.readers import group_ms


def read(run):
    return group_ms(run, "uq", "elementwise")
