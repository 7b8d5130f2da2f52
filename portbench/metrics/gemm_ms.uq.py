"""Device ms a request in GEMMs (the float32 resize matmuls, the 1x1 heads), by
name group (work/groups.py)."""

from portbench.readers import group_ms


def read(run):
    return group_ms(run, "uq", "gemm")
