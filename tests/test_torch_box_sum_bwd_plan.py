"""The box sum's and the squaring backward's launch plans, on the CPU.

`csrc/box_sum.cu` (#9) and `csrc/squaring_bwd.cu` (#2) walk exactly the
plans their wrappers compute (`kernels/box_sum.py:box_sum_plan`,
`kernels/gather.py:squaring_bwd_plan`). These tests walk the plans as
the kernels do:

- the box sum: a block's (H, W) tile and its chunk of D planes from
  blockIdx, the planes it reads, its march with the register ring of
  the last `win` planes' W-pass results: every output element is written
  exactly once, and when an output plane is written the ring holds
  every plane its D pass adds (the chunk's halo covers the ring), at
  ragged sizes (innermost 1, 13, 14), depths shorter than a chunk and
  than the window, windows 3 .. 9 and a wider one (11); the tile's
  shared-memory layout holds every read of the H and W passes;
- the squaring backward: a block's tile from blockIdx by shift and mask
  and its march through a chunk of planes, with the merges the kernel
  makes before it sends a term (a thread's upper-z corners held into the
  next plane's lower-z corners, the next lane's lower-x corners into a
  lane's upper-x ones): every source voxel is scattered exactly once,
  each of its 9 terms (8 corners and its own cell) is sent exactly once,
  in an entry whose cell is the term's own, at displacements under a
  voxel and past it and in a smooth field, where most terms merge;
- the plans of every shape the flagship, LungCT and 2D steps launch pass
  the checks the C entry points make.
No JAX and no card are needed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.kernels import box_sum, gather
from pulpo_tpu_torch.kernels.warp import _factor

# csrc/box_sum.cu's constants
TW, TH, NBUF, RH, MAX_P = 32, 32, 3, 4, 8
THREADS = (TW // 4) * TH


def _box_geometry(p):
    """csrc/box_sum.cu's tile layout for half window p."""
    p4 = (p + 3) // 4 * 4
    return {"p4": p4, "xs": TW + 2 * p4, "xr": TH + 2 * p, "hc": TW + 2 * p,
            "nq": (4 + 2 * p + 3) // 4, "hs": TW + (2 * p + 3) // 4 * 4}


@pytest.mark.parametrize("p", range(1, MAX_P + 1))
def test_box_sum_tile_holds_every_read(p):
    """The loaded tile (rows h0 - p .., columns w0 - p4 ..) holds the H
    pass's reads; the H pass's columns w0 - p .. w0 + TW + p hold the W
    pass's; a W-pass quad's 16-byte reads stay in the row and cover its
    window; the copies are whole 16-byte groups; the shared memory fits
    the 48 KB a block takes without opting in."""
    g = _box_geometry(p)
    # H pass: item (column c, group gr) reads loaded rows gr*RH .. gr*RH + RH + 2p - 1
    assert (TH // RH - 1) * RH + RH + 2 * p - 1 == g["xr"] - 1
    assert max(c + g["p4"] - p for c in range(g["hc"])) < g["xs"]
    assert g["p4"] >= p and g["xs"] % 4 == 0 and g["hs"] % 4 == 0
    # W pass: quad j reads H-pass columns 4j .. 4j + 4 nq - 1; adds columns 4j + e + p ± k
    for j in range(TW // 4):
        read = range(4 * j, 4 * j + 4 * g["nq"])
        assert read[-1] < g["hs"]
        used = {4 * j + e + p + k for e in range(4) for k in range(-p, p + 1)}
        assert used <= set(read) and max(used) < g["hc"]
    assert (NBUF * g["xr"] * g["xs"] + TH * g["hs"]) * 4 <= 48 * 1024


def _walk_box_sum(shape, win, plan):
    """How often csrc/box_sum.cu writes each output element of `shape`
    (B, D, H, W; D = 1 in 2D) under `plan`, checking at each write that
    the ring holds every in-volume plane the D pass adds."""
    b_, d_, h_, w_ = shape
    pd = win // 2 if d_ > 1 or plan.get("d3", True) else 0
    written = np.zeros(shape, np.int32)
    r, j = np.arange(THREADS) >> 3, np.arange(THREADS) & 7
    for bz in range(b_ * plan["chunks"]):
        b, c = divmod(bz, plan["chunks"])
        d0 = c * plan["chunk"]
        dend = min(d0 + plan["chunk"], d_)
        assert d0 < d_, "an empty chunk"
        lo, hi = max(d0 - pd, 0), min(dend + pd, d_)
        ring = [None] * (2 * pd + 1)
        for d in range(d0 - pd, dend + pd):
            ring = ring[1:] + [d if lo <= d < hi else None]
            dout = d - pd
            if dout < d0:
                continue
            for k in range(-pd, pd + 1):
                if 0 <= dout + k < d_:
                    assert ring[pd + k] == dout + k
            for by in range(plan["tiles_h"]):
                for bx in range(plan["tiles_w"]):
                    h = by * TH + r
                    for e in range(4):
                        w = bx * TW + 4 * j + e
                        ok = (h < h_) & (w < w_)
                        np.add.at(written, (b, dout, h[ok], w[ok]), 1)
    return written


RAGGED = [(1, 7, 37, 45), (2, 3, 33, 14), (1, 21, 13, 1), (1, 12, 12, 13), (1, 2, 40, 70)]


@pytest.mark.parametrize("blocks", [None, 1, 3])
@pytest.mark.parametrize("win", [3, 5, 7, 9, 11])
@pytest.mark.parametrize("shape", RAGGED)
def test_box_sum_writes_every_output_once(monkeypatch, shape, win, blocks):
    """At the plan's chunking, and with TARGET_BLOCKS set so that D is one
    chunk (`blocks` 1) or a few (3), shorter and longer than the window."""
    if blocks is not None:
        monkeypatch.setattr(box_sum, "TARGET_BLOCKS", blocks)
    plan = box_sum.box_sum_plan(*shape)
    assert plan["chunk"] * plan["chunks"] >= shape[1] > plan["chunk"] * (plan["chunks"] - 1)
    assert (_walk_box_sum(shape, win, plan) == 1).all()


@pytest.mark.parametrize("win", [3, 9])
@pytest.mark.parametrize("shape", [(2, 37, 45), (1, 13, 1), (3, 10, 12)])
def test_box_sum_2d_writes_every_output_once(shape, win):
    """The 2D entry: each of the B planes is a volume of depth 1, one
    chunk, no D ring."""
    plan = box_sum.box_sum_plan(shape[0], 1, *shape[1:])
    assert plan["chunk"] == plan["chunks"] == 1
    full = (shape[0], 1, *shape[1:])
    assert (_walk_box_sum(full, win, dict(plan, d3=False)) == 1).all()


def _box_admissible(plan, b, d, h, w):
    """The checks of csrc/box_sum.cu's `valid`."""
    return (plan["tw"] == TW and plan["th"] == TH and plan["tiles_w"] * TW >= w
            and plan["tiles_h"] * TH >= h and plan["chunk"] * plan["chunks"] >= d
            and plan["chunk"] * (plan["chunks"] - 1) < d and plan["tiles_h"] <= 65535
            and b * plan["chunks"] <= 65535 and h * w < 2**31)


def _step_configs():
    """The flagship, LungCT, flagship-2d and `train_cli --ndims 2` (64x64)
    configurations."""
    return [PULPoConfig(**chip_smoke.FLAGSHIP), PULPoConfig(**chip_smoke.LUNGCT),
            PULPoConfig(**chip_smoke.FLAGSHIP_2D),
            PULPoConfig(**dict(chip_smoke.FLAGSHIP_2D, input_size=(64, 64)))]


def _box_sum_launches():
    """(B, D, H, W, window) of every box sum the steps launch: each latent
    level's NCC at `df_size` with the level's window."""
    out = []
    for cfg in _step_configs():
        for l in range(cfg.latent_levels):
            size = cfg.df_size(l)
            out.append(((1, *size) if len(size) == 3 else (1, 1, *size), cfg.window_size[l]))
    return out


@pytest.mark.parametrize("shape,win", _box_sum_launches())
def test_box_sum_plans_at_the_steps_shapes(shape, win):
    """Each plan passes the entry's checks, has no tile wholly outside the
    volume, and gives the full-size launches at least one block per SM."""
    plan = box_sum.box_sum_plan(*shape)
    b, d, h, w = shape
    assert _box_admissible(plan, *shape) and 3 <= win <= box_sum.MAX_WINDOW
    assert (plan["tiles_w"] - 1) * TW < w and (plan["tiles_h"] - 1) * TH < h
    if d * h * w >= 2**22:
        assert plan["tiles_w"] * plan["tiles_h"] * b * plan["chunks"] >= 132


# ----------------------------------------------------------------------
# the squaring backward
# ----------------------------------------------------------------------

def _sources(v):
    """Each voxel's clamped source coordinate along each axis (float32, as
    the kernel rounds it) and its two corners."""
    _, *s, _ = v.shape
    src, i0, i1 = [], [], []
    for a, n in enumerate(s):
        p = np.arange(n, dtype=np.float32).reshape([n if i == a else 1 for i in range(3)])
        u = (p + v[..., a]) * np.float32(_factor(n, n)) - np.float32(0.5)
        c = np.minimum(np.maximum(u, np.float32(0.0)), np.float32(n - 1))
        src.append(c)
        i0.append(np.floor(c).astype(np.int64))
        i1.append(np.minimum(i0[-1] + 1, n - 1))
    return src, i0, i1


def _walk_bwd(v, plan):
    """Walk csrc/squaring_bwd.cu's launch on field v (B, S0, S1, S2, 3) with
    its merges, an entry being the list of terms (row, voxel, corner;
    corner 8: its own cell) it carries: returns how often each voxel is
    scattered, how often each term is sent, and the number of sends (an
    entry whose terms all have a zero weight, a corner past a clamped
    coordinate, is not sent, as the kernel sends no zeros), checking that
    every entry's terms are of the entry's cell."""
    b_, s0, s1, s2, _ = v.shape
    tx, ty, tz = plan["tx"], plan["ty"], plan["tz"]
    src, i0, i1 = _sources(v)
    w = [c - np.floor(c) for c in src]
    scattered = np.zeros((b_, s0, s1, s2), np.int32)
    sent = {}
    sends = 0

    def cell_of(term):
        r, z, y, x, corner = term
        if corner == 8:
            return (r, z, y, x)
        return (r,) + tuple(int((i1 if (corner >> a) & 1 else i0)[a][r, z, y, x])
                            for a in range(3))

    def zero(term):
        r, z, y, x, corner = term
        return corner != 8 and any((corner >> a) & 1 and w[a][r, z, y, x] == 0 for a in range(3))

    def send(entry, cell):
        nonlocal sends
        if entry:
            sends += not all(zero(term) for term in entry)
            for term in entry:
                assert cell_of(term) == cell, "a term sent to another cell"
                sent[term] = sent.get(term, 0) + 1

    strips = 1 << plan["log_strips"]
    n = tx * ty
    for r in range(b_):
        for by in range(plan["tiles_z"]):
            for bx in range(plan["tiles_y"] << plan["log_strips"]):
                x0, y0, z0 = (bx & (strips - 1)) * tx, (bx >> plan["log_strips"]) * ty, by * tz
                z1 = min(z0 + tz, s0)
                held = [None] * n  # per thread: (cells, entries) of its upper-z corners
                for z in range(z0, z1 + 1):
                    have, base = [False] * n, [None] * n
                    val = [[[] for _ in range(8)] for _ in range(n)]
                    for tid in range(n):
                        x, y = x0 + tid % tx, y0 + tid // tx
                        if z < z1 and x < s2 and y < s1:
                            have[tid] = True
                            scattered[r, z, y, x] += 1
                            base[tid] = [int(i0[a][r, z, y, x]) for a in range(3)]
                            val[tid] = [[(r, z, y, x, k)] for k in range(8)]
                            send([(r, z, y, x, 8)], (r, z, y, x))
                        if held[tid] is not None:
                            cells, entries = held[tid]
                            if have[tid] and list(cells[0][1:]) == base[tid]:
                                for k in range(4):
                                    val[tid][2 * k] += entries[k]
                            else:
                                for k in range(4):
                                    send(entries[k], cells[k])
                            held[tid] = None
                    # the x merge: lane i takes lane i + 1's lower-x corners
                    take = [have[t] and have[t + 1] and t % 32 < 31 and t % tx + 1 < tx
                            and base[t + 1][:2] == base[t][:2]
                            and base[t + 1][2] == min(base[t][2] + 1, s2 - 1)
                            for t in range(n - 1)] + [False]
                    for t in range(n - 1):
                        if take[t]:
                            for k in range(4):
                                val[t][4 + k] += val[t + 1][k]
                    for t in range(1, n):
                        if take[t - 1]:
                            for k in range(4):
                                val[t][k] = []
                    for t in range(n):
                        if have[t]:
                            x, y = x0 + t % tx, y0 + t // tx
                            for k in range(4):
                                send(val[t][2 * k], cell_of((r, z, y, x, 2 * k)))
                            held[t] = ([cell_of((r, z, y, x, 2 * k + 1)) for k in range(4)],
                                       [val[t][2 * k + 1] for k in range(4)])
                assert all(h is None for h in held)
    return scattered, sent, sends


def _bwd_fields():
    """(name, field): uniform noise under a voxel and past it, smooth
    fields of 1 and 3 voxels, the LungCT ramp."""
    rng = np.random.default_rng(80)
    noise = lambda shape, mag: (rng.uniform(-1, 1, (*shape, 3)) * mag).astype(np.float32)
    smooth = lambda size, mag: chip_smoke.smooth_field(1, size, mag, seed=81,
                                                       device="cpu").numpy()
    return [("noise 0.3", noise((1, 5, 7, 13), 0.3)), ("noise 0.3 B2", noise((2, 6, 9, 2), 0.3)),
            ("noise 3", noise((1, 9, 17, 14), 3.0)), ("noise 9", noise((1, 6, 11, 19), 9.0)),
            ("smooth 1", smooth((12, 20, 40), 1.0)), ("smooth 3", smooth((10, 24, 28), 3.0)),
            ("ramp 8", chip_smoke.respiratory_field((14, 12, 13), 8.0, 2.0, "cpu").numpy())]


@pytest.mark.parametrize("blocks", [None, 1, 10**6])
@pytest.mark.parametrize("name,v", _bwd_fields())
def test_squaring_bwd_walk(monkeypatch, name, v, blocks):
    """Every source voxel scattered once and each of its 9 terms sent once,
    to its own cell, with z in the plan's chunks, in one chunk (`blocks`
    1) and one plane a chunk (10**6); in the smooth fields, with more than
    one plane a chunk, the merges leave fewer than 5 sends a voxel (9
    without them)."""
    if blocks is not None:
        monkeypatch.setattr(gather, "BWD_TARGET_BLOCKS", blocks)
    plan = gather.squaring_bwd_plan(v.shape[1:4], v.shape[0])
    scattered, sent, sends = _walk_bwd(v, plan)
    assert (scattered == 1).all()
    assert len(sent) == 9 * scattered.size and set(sent.values()) == {1}
    if name.startswith("smooth") and plan["tz"] > 1:
        assert sends < 5 * scattered.size


def _bwd_admissible(plan, b, s0, s1, s2):
    """The checks of csrc/squaring_bwd.cu's `valid`."""
    strips = 1 << plan["log_strips"]
    return (plan["v"] == 1 and plan["groups"] == 1 and plan["rows"] == 1
            and plan["tx"] * plan["ty"] <= gather.THREADS and plan["tx"] * strips >= s2
            and plan["ty"] * plan["tiles_y"] >= s1 and plan["tz"] * plan["tiles_z"] >= s0
            and plan["tiles_z"] <= 65535 and b <= 65535 and s0 * s1 * s2 * 3 < 2**31)


@pytest.mark.parametrize("size", [s for cfg in _step_configs()[:2]
                                  for s in cfg.level_sizes.values()])
def test_squaring_bwd_plans_at_the_steps_shapes(size):
    """The squaring backward of the flagship and LungCT steps (B = 1, one
    per integration step at each latent level's size): each plan passes
    the entry's checks, its chunks are non-empty, and the level-0 launch
    has at least one block per SM."""
    plan = gather.squaring_bwd_plan(size, 1)
    assert _bwd_admissible(plan, 1, *size)
    assert (plan["tiles_z"] - 1) * plan["tz"] < size[0]
    assert ((plan["tiles_y"] - 1) * plan["ty"] < size[1]
            and ((1 << plan["log_strips"]) - 1) * plan["tx"] < size[2])
    if np.prod(size) >= 2**19:
        assert (plan["tiles_y"] << plan["log_strips"]) * plan["tiles_z"] >= 132
