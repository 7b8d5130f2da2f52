"""The network's conv FLOPs, counted from a configuration's `model` dict.

A conv of kernel size k from Cin to Cout channels costs 2 * k**nd *
Cin * Cout FLOPs per output voxel and row. Counted: every conv of the
down path (3 units a level), and per posterior sample and latent level
the feedback up-block (2 units), the merge block (2 units), the mu and
sigma 1x1 heads and the velocity head (cp_depth layers); not counted:
resizes, warps, integration, BatchNorm and the losses.

A UQ request encodes each pair once and decodes N samples. The merge
block's first conv reads concat(feedback, down activation); its
activation half is the same for every sample of a pair, and so are the
coarsest level's heads, so both count once a pair (what the request
needs); the feedback half and every other conv count once a sample. A
training step counts 3 times its forward (one sample a pair, every conv
once), the forward and a backward of twice its cost.
"""

from __future__ import annotations

import math

from portbench.reference.pulpo_ref import Arch


def conv(cin: int, cout: int, k: int, voxels: int, nd: int) -> int:
    return 2 * k ** nd * cin * cout * voxels


def encode(m: dict, pairs: int = 1) -> int:
    """The down path over `pairs` pairs."""
    a = Arch(m)
    cin = [2] + a.channels[:-1]
    total = 0
    for k in range(a.total_levels):
        v = math.prod(a.global_sizes[k]) * pairs
        total += conv(cin[k], a.channels[k], 3, v, a.ndims)
        total += 2 * conv(a.channels[k], a.channels[k], 3, v, a.ndims)
    return total


def _velocity(a: Arch, v: int) -> int:
    d, nd = a.cp_depth, a.ndims
    if d == 0:
        return 0
    if d == 1:
        return conv(a.zdim, nd, 3, v, nd)
    return (conv(a.zdim, a.n0, 3, v, nd) + (d - 2) * conv(a.n0, a.n0, 3, v, nd)
            + conv(a.n0, nd, 1, v, nd))


def decode_parts(m: dict) -> tuple[int, int]:
    """(FLOPs a sample, FLOPs a pair) of one decode: the per-pair part is
    the merge convs' activation halves and the coarsest level's heads."""
    a = Arch(m)
    nd, fbc, up = a.ndims, a.feedback_channels(), a.n0 * a.zdim
    per_sample = per_pair = 0
    for l in range(a.latent_levels):
        c = a.channels[l + a.lk]
        v = math.prod(a.level_size(l))
        heads = 2 * conv(c, a.zdim, 1, v, nd)
        if l == a.latent_levels - 1:
            per_pair += heads
        else:
            per_sample += conv(fbc, up, 3, v, nd) + conv(up, up, 3, v, nd)
            per_sample += conv(up, c, 3, v, nd) + conv(c, c, 3, v, nd) + heads
            per_pair += conv(c, c, 3, v, nd)
        per_sample += _velocity(a, v)
    return per_sample, per_pair


def uq_request(m: dict, n_samples: int, pairs: int = 1) -> int:
    """One N-sample request on `pairs` pairs."""
    per_sample, per_pair = decode_parts(m)
    return encode(m, pairs) + pairs * (per_pair + n_samples * per_sample)


def train_step(m: dict, pairs: int) -> int:
    """One training step on a batch of `pairs` pairs."""
    per_sample, per_pair = decode_parts(m)
    return 3 * (encode(m, pairs) + pairs * (per_pair + per_sample))
