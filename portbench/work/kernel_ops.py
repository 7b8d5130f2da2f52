"""The operations that the port's hand-written kernels implement on a
cell's path, with the FLOPs and bytes each launch needs.

Each function lists one unit of work (a UQ request, a training step) as
launches `(kernel, flops, bytes, arithmetic)`, from the shapes that the
configuration's `model` dict fixes. Bytes count each input byte read
once and each output byte written once (weights included); FLOPs count
the convs' 2 * k**nd * Cin * Cout a voxel and row. The warps, the
integration and the box sums are counted by their bytes alone. The
kernel ids are the program's launch counters' (`COUNTERS` in
portbench/harness.py). `least_by_kernel` folds a list into each
kernel's launches and least seconds (`peaks.least_seconds`).
"""

from __future__ import annotations

import math

from portbench.reference.pulpo_ref import Arch
from portbench.work import peaks
from portbench.work.flops import conv

F32 = 4
NARROW_MAX_CIN = 4  # a k = 3 conv input the narrow-conv kernel takes


def _ds(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def _unit(kernel, cin, cout, rows, v, nd, dtype, k=3, extra_in=0):
    """A conv unit (its epilogue fused): activations in and out, weights."""
    ds = _ds(dtype)
    flops = conv(cin, cout, k, rows * v, nd)
    nbytes = rows * v * (cin + cout) * ds + k ** nd * cin * cout * ds + extra_in
    return (kernel, flops, nbytes, dtype)


def _integration(kernel, rows, v, nsteps):
    return [(kernel, 0, 2 * rows * v * 3 * F32, "float32")] * nsteps


def _warp(kernel, moving_rows, moving_v, rows, out_v, c=1):
    return (kernel, 0, (moving_rows * moving_v * c + rows * out_v * (3 + c)) * F32, "float32")


def _level_moving(a: Arch, l: int) -> tuple[int, ...]:
    """The size of the image a level's decode warps (the moving pyramid)."""
    if a.full_res or l == 0:
        return a.input_size
    return a.level_size(l)


def uq_request(m: dict, n_samples: int, chunk: int, pairs: int = 1) -> list[tuple]:
    """One N-sample request decoded `chunk` samples at a time, and its
    mean-SVF tail, in the eval dtype `m["compute_dtype"]`."""
    a = Arch(m)
    dt, nd, ds = m["compute_dtype"], a.ndims, _ds(m["compute_dtype"])
    cf = a.full_res and "transformed" not in a.feedback and nd == 3
    sq, wp = ("squaring_cf", "warp_cf") if cf else ("squaring", "warp")
    ops = []
    v0 = math.prod(a.input_size)
    if nd == 3:  # down_block_0 reads the pair's 2 channels: the conv-chain kernel's
        ops += [_unit("conv_chain", 2 if i == 0 else a.n0, a.n0, pairs, v0, nd, dt)
                for i in range(3)]
    fbc, up, zd = a.feedback_channels(), a.n0 * a.zdim, a.zdim
    rows = chunk * pairs
    for _ in range(n_samples // chunk):
        for l in range(a.latent_levels):
            v = math.prod(a.level_size(l))
            c = a.channels[l + a.lk]
            if l < a.latent_levels - 1 and nd == 3:
                ops += [_unit("pos_head", fbc, up, rows, v, nd, dt),
                        _unit("pos_head", up, up, rows, v, nd, dt),
                        _unit("pos_head", up, c, rows, v, nd, dt, extra_in=pairs * v * c * ds)]
                last = _unit("pos_head", c, c, rows, v, nd, dt)
                ops.append(("pos_head", last[1] + 2 * conv(c, zd, 1, rows * v, nd),
                            last[2] + rows * v * (2 * zd - c) * ds + 2 * c * zd * ds, dt))
            if a.cp_depth == 3 and nd == 3:
                ops.append(("vel_head",
                            conv(zd, a.n0, 3, rows * v, nd) + conv(a.n0, a.n0, 3, rows * v, nd)
                            + conv(a.n0, nd, 1, rows * v, nd),
                            rows * v * (zd + nd) * ds
                            + (27 * (zd * a.n0 + a.n0 * a.n0) + a.n0 * nd) * ds, dt))
            ops += _integration(sq, rows, v, a.nsteps)
            if not cf:
                ops.append(_warp(wp, pairs, math.prod(_level_moving(a, l)), rows,
                                 math.prod(a.df_size(l))))
        if cf:
            ops.append(_warp(wp, pairs, v0, a.latent_levels * rows, v0))
    for l in range(a.latent_levels):
        ops += _integration(sq, pairs, math.prod(a.level_size(l)), a.nsteps)
        if not cf:
            ops.append(_warp(wp, pairs, v0, pairs, math.prod(a.df_size(l))))
    if cf:
        ops.append(_warp(wp, pairs, v0, a.latent_levels * pairs, v0))
    return ops


def train_step(m: dict, pairs: int) -> list[tuple]:
    """One training step on `pairs` pairs (the channels-last train path:
    the narrow convs, each level's integration, warp and NCC box sums,
    forward and backward)."""
    a = Arch(m)
    dt, nd = m["compute_dtype"], a.ndims
    if nd != 3:
        return []
    ops = []
    narrow = "bfloat16" if dt == "bfloat16" else "float32"
    v0 = math.prod(a.input_size)
    # down_block_0's first conv reads the pair's 2 channels: the narrow conv's
    ops.append(_unit("conv_narrow", 2, a.n0, pairs, v0, nd, narrow))
    for l in range(a.latent_levels):
        v = math.prod(a.level_size(l))
        vo = math.prod(a.df_size(l))
        vm = math.prod(_level_moving(a, l))
        if a.cp_depth >= 2 and a.zdim <= NARROW_MAX_CIN:
            ops.append(_unit("conv_narrow", a.zdim, a.n0, pairs, v, nd, narrow))
        ops += _integration("squaring", pairs, v, a.nsteps)
        ops += [("squaring_bwd", 0, 3 * pairs * v * 3 * F32, "float32")] * a.nsteps
        ops.append(_warp("warp", pairs, vm, pairs, vo))
        ops.append(("warp_dfgrad", 0, (pairs * vm + pairs * vo * (3 + 1 + 3)) * F32, "float32"))
        if "ncc" in m["recon_loss"]:
            ops += [("box_sum", 0, 2 * pairs * vo * F32, "float32")] * 8
    return ops


def least_by_kernel(ops: list[tuple]) -> dict[str, dict]:
    """{kernel: {"launches", "flops", "bytes", "least_s"}} of a list."""
    out: dict[str, dict] = {}
    for kernel, flops, nbytes, arith in ops:
        d = out.setdefault(kernel, {"launches": 0, "flops": 0, "bytes": 0, "least_s": 0.0})
        d["launches"] += 1
        d["flops"] += flops
        d["bytes"] += nbytes
        d["least_s"] += peaks.least_seconds(flops, nbytes, arith)
    return out
