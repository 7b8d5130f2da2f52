"""The gather kernels' tile plan and mapping, on the CPU.

The wrappers compute each launch's plan in `kernels/gather.py` and pass
it to `csrc/warp.cu` / `csrc/squaring.cu`, which walk exactly that
plan: a block's tile from blockIdx by shift and mask, its df rows from
one divide, each thread its own voxel or, in a large channels-first
warp, a quad of 4 moved with 16-byte accesses and 4 interleaved voxels
computed. These tests walk the plans as the kernels do (`_grid`,
`_tile`, `_block_rows` below are `gather::grid`, `gather::tile_of` and
warp.cu's row decode), for
ragged sizes (innermost 13, 14, 26 and 1; row counts that are not a
multiple of the row group; 2 moving rows read as r % B) at both V:
every output voxel of every row is loaded, computed and stored exactly
once; a 16-byte access is taken only at an aligned address, and on
every quad of the paths' aligned sizes; the plans of every shape the
paths launch pass the checks the C entry points make (`gather::valid`)
and take 4-voxel quads exactly on the large channels-first warps.
No JAX and no card are needed.
"""

import math

import numpy as np
import pytest

from pulpo_tpu_torch.kernels import gather, squaring, warp
from test_torch_threads import one_torch_thread  # noqa: F401

RAGGED = [(5, 7, 13), (3, 17, 14), (4, 6, 26), (6, 9, 1), (1, 17, 13), (1, 12, 64)]


def _grid(plan, movings):
    return (plan["tiles_y"] << plan["log_strips"], plan["tiles_z"], movings * plan["groups"])


def _tile(plan, bx, by):
    """(z0, y0, x0) of block (bx, by)'s tile."""
    strip = bx & ((1 << plan["log_strips"]) - 1)
    return by * plan["tz"], (bx >> plan["log_strips"]) * plan["ty"], strip * plan["tx"] * plan["v"]


def _block_rows(plan, bz, movings, b_df):
    """The moving row and the df rows, in order, of blocks with
    blockIdx.z = bz."""
    group, m = divmod(bz, movings)
    j0 = group * plan["rows"]
    n = min(plan["rows"], b_df // movings - j0)
    return m, [m + movings * (j0 + k) for k in range(n)]


def _valid(x, x0):
    """The voxels of a thread's quad at x0 that lie in a line of x."""
    return max(0, min(4, x - x0))


def _walk(plan, size, movings, b_df):
    """Per df row, how often each output voxel is stored (by a thread's
    V voxels from x0 + V i) and computed (V = 4: the interleaved voxels
    x0 + i + tx j; V = 1: its own), over every block and thread."""
    z_, y_, x_ = size
    v = plan["v"]
    stored = np.zeros((b_df, z_, y_, x_), np.int32)
    computed = np.zeros_like(stored)
    gx, gy, gz = _grid(plan, movings)
    lz, ly, i = np.meshgrid(np.arange(plan["tz"]), np.arange(plan["ty"]),
                            np.arange(plan["tx"]), indexing="ij")
    for bz in range(gz):
        m, rows = _block_rows(plan, bz, movings, b_df)
        assert rows and all(r % movings == m for r in rows)
        for by in range(gy):
            for bx in range(gx):
                z0, y0, x0 = _tile(plan, bx, by)
                z, y = z0 + lz, y0 + ly
                for j in range(v):
                    for what, lx in ((stored, v * i + j), (computed, i + plan["tx"] * j)):
                        x = x0 + lx
                        ok = (z < z_) & (y < y_) & (x < x_)
                        for r in rows:
                            np.add.at(what, (r, z[ok], y[ok], x[ok]), 1)
    return stored, computed


@pytest.mark.parametrize("v", [1, 4])
@pytest.mark.parametrize("size", RAGGED)
@pytest.mark.parametrize("movings,b_df,spread", [(1, 7, 2), (2, 10, 3), (1, 5, 1)])
def test_every_voxel_of_every_row_is_written_once(monkeypatch, size, movings, b_df, spread, v):
    """The warp's launch at `v` voxels a thread, its rows grouped
    `spread` ways (TARGET_BLOCKS set so that the groups do not divide the
    rows evenly where they can), and the squaring step's launch on the
    same size."""
    gx, gy, _ = _grid(gather.warp_plan(size, movings, movings, v=v), movings)
    monkeypatch.setattr(gather, "TARGET_BLOCKS", spread * gx * gy * movings)
    plan = gather.warp_plan(size, b_df, movings, v=v)
    assert plan["groups"] <= spread and plan["v"] == v
    assert plan["groups"] * plan["rows"] >= b_df // movings > (plan["groups"] - 1) * plan["rows"]
    for counts in _walk(plan, size, movings, b_df):
        assert (counts == 1).all()
    monkeypatch.undo()
    sq = gather.squaring_plan(size if size[0] > 1 else size[1:], 3)
    for counts in _walk(sq, size, 3, 3):
        assert (counts == 1).all()


def _path_shapes():
    """(moving shape, df shape, cf) of every warp the paths launch and of
    a field of each df's size (the squaring step): the flagship's and
    LungCT's input size and latent levels, 32 rows (the level_res
    decode) and 1 (the mean tail, a B = 1 step); the full_res batched CF
    warp and its mean tail; flagship-2d's and `train_cli --ndims 2`'s."""
    out = []
    for full, levels in (((160, 192, 224), [(80, 96, 112), (40, 48, 56), (20, 24, 28),
                                             (10, 12, 14)]),
                         ((192, 192, 208), [(96, 96, 104), (48, 48, 52), (24, 24, 26),
                                            (12, 12, 13)]),
                         ((160, 192), [(80, 96), (40, 48), (20, 24), (10, 12)]),
                         ((64, 64), [(32, 32), (16, 16)])):
        nd = len(full)
        for size in (full, *levels):
            for rows in (32, 1):
                out.append(((1, *size, 1), (rows, *size, nd), False))
    for rows in (128, 4):
        out.append(((1, 1, 160, 192, 224), (rows, 3, 160, 192, 224), True))
    out.append(((2, 13, 17, 19, 3), (6, 13, 17, 19, 3), False))
    return out


def _admissible(plan, size, rows_per_moving, movings, row_elements):
    """The checks `gather::valid` makes before a launch."""
    z_, y_, x_ = size
    strips = 1 << plan["log_strips"]
    return (plan["v"] in (1, 4) and plan["tx"] * plan["ty"] * plan["tz"] <= gather.THREADS
            and plan["tx"] * plan["v"] * strips >= x_ and plan["ty"] * plan["tiles_y"] >= y_
            and plan["tz"] * plan["tiles_z"] >= z_
            and plan["groups"] == gather.cdiv(rows_per_moving, plan["rows"])
            and plan["tiles_z"] <= 65535 and movings * plan["groups"] <= 65535
            and row_elements < 2**31)


@pytest.mark.parametrize("moving,df,cf", _path_shapes())
def test_plans_at_the_paths_shapes(moving, df, cf):
    """At the shapes the paths launch: each plan passes the entry points'
    checks, has no tile wholly outside the output, splits the df rows in
    order into groups that each read one moving row, and takes 4-voxel
    quads exactly on the channels-first warps of WARP_CF_QUADS_FROM
    voxels or more (both of the full_res request's)."""
    spatial = tuple(df[2:] if cf else df[1:-1])
    size = gather.axes(spatial)
    z_, y_, x_ = size
    n = math.prod(spatial)
    plan = warp.tile_plan(moving, df, cf)
    assert plan["v"] == (4 if cf and df[0] * n >= gather.WARP_CF_QUADS_FROM else 1)
    assert plan["v"] == (4 if cf else 1)
    assert _admissible(plan, size, df[0] // moving[0], moving[0], n * max(3, moving[-1]))
    w = plan["tx"] * plan["v"]
    strips = 1 << plan["log_strips"]
    assert w * strips >= x_ > w * (strips - 1) and w <= gather.STRIP
    assert plan["ty"] * plan["tiles_y"] >= y_ > plan["ty"] * (plan["tiles_y"] - 1)
    assert plan["tz"] * plan["tiles_z"] >= z_ > plan["tz"] * (plan["tiles_z"] - 1)
    grid = _grid(plan, moving[0])
    rows = [_block_rows(plan, bz, moving[0], df[0])[1] for bz in range(grid[2])]
    assert sorted(r for rs in rows for r in rs) == list(range(df[0]))
    field = df if not cf else (df[0], *spatial, 3)
    sq = squaring.tile_plan(df, cf) if cf else squaring.tile_plan(field)
    assert sq == squaring.tile_plan(field)
    assert sq["v"] == 1 and sq["rows"] == 1 and _admissible(sq, size, 1, df[0], n * len(spatial))


def _quad_addresses(plan, size, k, base):
    """Byte addresses and valid counts of every quad a launch moves, in
    each of k planes of a channels-first row at byte `base`."""
    z_, y_, x_ = size
    n = z_ * y_ * x_
    out = []
    gx, gy, _ = _grid(plan, 1)
    for by in range(gy):
        for bx in range(gx):
            z0, y0, x0 = _tile(plan, bx, by)
            for lz in range(plan["tz"]):
                for ly in range(plan["ty"]):
                    z, y = z0 + lz, y0 + ly
                    if z >= z_ or y >= y_:
                        continue
                    for i in range(plan["tx"]):
                        xq = x0 + 4 * i
                        nv = _valid(x_, xq)
                        if nv == 0:
                            continue
                        v = (z * y_ + y) * x_ + xq
                        out += [(base + 4 * (a * n + v), nv, xq) for a in range(k)]
    return out


def _vectorized(address, n_valid):
    """A quad takes the 16-byte path (gather::load_plane, store_plane):
    whole, and its first element's byte address aligned to 16."""
    return n_valid == 4 and address % 16 == 0


@pytest.mark.parametrize("size", RAGGED + [(2, 3, 28), (1, 5, 224)])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("base", [0, 4, 8, 12])
def test_16_byte_accesses_only_where_aligned(size, k, base):
    """In a channels-first warp at 4 voxels a thread (df: 3 planes;
    output: C), a quad takes the 16-byte path only where it is whole,
    inside one line, and its address is 16-byte aligned; on an aligned
    row whose innermost size is a multiple of 4 (224 on the path), every
    quad takes it."""
    plan = gather.warp_plan(size, 1, 1, cf=True, v=4)
    quads = _quad_addresses(plan, size, k, base)
    for addr, nv, xq in quads:
        if _vectorized(addr, nv):
            assert addr % 16 == 0 and nv == 4 and xq + 4 <= size[2]
    if base == 0 and size[2] % 4 == 0:
        assert all(_vectorized(a, nv) for a, nv, _ in quads)


def test_plan_arg_is_the_plan_in_the_kernels_order():
    """The 9 ints the C entry points read as gather::Plan."""
    plan = gather.warp_plan((20, 24, 28), 32, 1)
    assert list(gather.plan_arg(plan)) == [plan[k] for k in gather.KEYS]
    assert gather.KEYS == ("tx", "ty", "tz", "log_strips", "tiles_y", "tiles_z", "groups",
                           "rows", "v")


def _axis_counts(plan, size):
    """How often each voxel of each axis is reached by the kernel's decode
    (gather::tile_of at one voxel a thread: x = strip * tx + threadIdx.x,
    y = (blockIdx.x >> log_strips) * ty + threadIdx.y, z = blockIdx.y * tz
    + threadIdx.z), inside the volume; the walk is their product."""
    z_, y_, x_ = size
    strips = 1 << plan["log_strips"]
    x = (np.arange(strips)[:, None] * plan["tx"] + np.arange(plan["tx"])).ravel()
    y = (np.arange(plan["tiles_y"])[:, None] * plan["ty"] + np.arange(plan["ty"])).ravel()
    z = (np.arange(plan["tiles_z"])[:, None] * plan["tz"] + np.arange(plan["tz"])).ravel()
    return [np.bincount(a[a < n], minlength=n) for a, n in ((z, z_), (y, y_), (x, x_))]


def _dfgrad_launches():
    """(moving shape, df shape) of the df-cotangent's launches: each level
    of a B = 1 flagship and LungCT training step (each level's image by
    its df, level 0 at the input size), and the kernel checks' cases:
    2 df rows of one image, the full-size image under a level-0 df."""
    out = []
    for full, levels in (((160, 192, 224), [(40, 48, 56), (20, 24, 28), (10, 12, 14)]),
                         ((192, 192, 208), [(48, 48, 52), (24, 24, 26), (12, 12, 13)])):
        for size in (full, *levels):
            out.append(((1, *size, 1), (1, *size, 3)))
        out.append(((1, *full, 1), (2, *full, 3)))
    out.append(((1, 160, 192, 224, 1), (2, 80, 96, 112, 3)))
    return out


@pytest.mark.parametrize("moving,df", _dfgrad_launches())
def test_dfgrad_plan_at_the_training_shapes(moving, df):
    """The df-cotangent takes the forward warp's plan over the df's output
    space (kernels/warp.py:_launch): one voxel a thread, the entry's checks
    passed, every output voxel of every df row computed and written once."""
    plan = warp.tile_plan(moving, df)
    size = gather.axes(df[1:-1])
    n = math.prod(size)
    assert plan["v"] == 1
    assert _admissible(plan, size, df[0] // moving[0], moving[0], n * 3)
    for counts in _axis_counts(plan, size):
        assert (counts == 1).all()
    grid = _grid(plan, moving[0])
    rows = [_block_rows(plan, bz, moving[0], df[0])[1] for bz in range(grid[2])]
    assert sorted(r for rs in rows for r in rs) == list(range(df[0]))


@pytest.mark.parametrize("size", RAGGED)
def test_dfgrad_walk_matches_the_axis_decode(size):
    """On ragged sizes the block-by-block walk (`_walk`) and the per-axis
    decode above agree: the decode is the walk's product."""
    plan = warp.tile_plan((2, *size, 1), (6, *size, 3))
    stored, _ = _walk(plan, size, 2, 6)
    zc, yc, xc = _axis_counts(plan, size)
    assert (stored == 1).all()
    assert (zc[:, None, None] * yc[None, :, None] * xc[None, None, :] == stored[0]).all()
