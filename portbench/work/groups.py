"""Device operations grouped by kernel name, and the arithmetic of a
traced window: the busy union, the idle gaps, the time by group.

The groups are those of the port's profile scripts, the port's own
kernels first: the first group whose pattern (a substring of the
lower-cased name) matches takes an operation.
"""

from __future__ import annotations

OWN = ("conv_unit_kernel", "conv_unit_tc", "vel_head_tc", "vel_head_f32", "warp_kernel",
       "warp_channels_kernel", "squaring_kernel", "squaring_bwd_kernel", "dfgrad_kernel",
       "mgrad_kernel", "box_sum_kernel", "conv_narrow_kernel", "conv_narrow_tc",
       "fixed::max_abs_bits", "fixed::convert")

GROUPS = (
    ("own", OWN),
    ("conv", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad", "nchw", "nhwc",
              "transpose")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas", "splitk")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "catarray", "copy", "fill",
                     "index")),
)


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, pats in GROUPS if any(p in low for p in pats)), "other")


def union(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi)."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
