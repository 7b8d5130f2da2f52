"""The gaps that decide `correct`, between the program's outputs and the
reference's.

- `rel_gap`: the L2 norm of the difference over the reference's norm.
- `leaf_gaps`: for each leaf, the gap between the program's norm of the
  leaf and the reference's (not the norm of their difference), over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; a cell compares a quantile of them (`quantile`; 1: the worst
  leaf's).
- `moving_leaves`: the leaves whose reference gradient is at least
  `MOVING` of the median leaf's; the others (a conv bias in front of a
  train BatchNorm, whose exact gradient is 0) move under Adam by
  round-off alone, and are left out by this rule.
"""

from __future__ import annotations

import statistics

import torch

MOVING = 1e-3


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    if tuple(p.shape) != tuple(r.shape):
        return float("inf")
    p, r = p.double(), r.double().to(p.device)
    return float((p - r).norm() / r.norm().clamp_min(1e-300))


def norms(d: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def moving_leaves(ref_grads: dict[str, torch.Tensor]) -> set[str]:
    n = norms(ref_grads)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= MOVING * med}


def leaf_gaps(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
              leaves) -> dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's (not
    the norm of their difference), over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = statistics.median(rn.values())
    out = {}
    for k in sorted(leaves):
        gap = abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-300)
        out[k] = gap if gap == gap else float("inf")  # NaN reads as the worst
    return out


def quantile(gaps: dict[str, float], q: float) -> float:
    """The q-quantile of the leaves' gaps, linear between ranks."""
    xs = sorted(gaps.values())
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
