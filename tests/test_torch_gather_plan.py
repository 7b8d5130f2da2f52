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
The warp's channel body (a channels-last launch of 5 channels or more:
`gather.channel_plan`) is walked the same way at the segmentation
paths' C = 36 shapes and at a ragged C = 5: every (row, voxel, channel)
written once, 16-byte chunks only where aligned; the df-cotangent keeps
the voxel plan at every C, walked at the same shapes.
A slab launch (the depth-sharded model: `gather.slab`, the plan's z0
and zg) is walked as the kernels map it: each local plane to its global
plane z + z0, every plane of the slab once and none outside; a 2D slab
runs along H, the plan's y, each local line to its global line y + z0
(the voxel body, the channel body at C = 36 and the step, at the
flagship-2d levels that split); and the
plain versions of the warp, its df-cotangent, the squaring step and its
backward at an offset are the matching slices of the whole (the step
backward's share: the whole backward of the slab's cotangent).
No JAX and no card are needed.
"""

import math

import numpy as np
import pytest
import torch

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


def _admissible(plan, size, rows_per_moving, movings, row_elements, flat=False):
    """The checks `gather::valid` and `gather::valid_slab` make before a
    launch (a whole launch: z0 = 0, zg = its depth); `flat`: a 2D launch,
    whose slab runs along y (zg = its lines)."""
    z_, y_, x_ = size
    strips = 1 << plan["log_strips"]
    e = y_ if flat else z_  # gather::slab_axis
    return (plan["z0"] >= 0 and plan["zg"] >= 1 and plan["z0"] + e <= plan["zg"]
            and plan["v"] in (1, 4) and plan["tx"] * plan["ty"] * plan["tz"] <= gather.THREADS
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
    flat = len(spatial) == 2
    plan = warp.tile_plan(moving, df, cf)
    assert plan["v"] == (4 if cf and df[0] * n >= gather.WARP_CF_QUADS_FROM else 1)
    assert plan["v"] == (4 if cf else 1)
    assert (plan["z0"], plan["zg"]) == (0, spatial[0])
    assert _admissible(plan, size, df[0] // moving[0], moving[0], n * max(3, moving[-1]), flat)
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
    assert sq["v"] == 1 and sq["rows"] == 1
    assert _admissible(sq, size, 1, df[0], n * len(spatial), flat)


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
    """The 12 ints the C entry points read as gather::Plan."""
    plan = gather.warp_plan((20, 24, 28), 32, 1)
    assert list(gather.plan_arg(plan)) == [plan[k] for k in gather.KEYS]
    assert gather.KEYS == ("tx", "ty", "tz", "log_strips", "tiles_y", "tiles_z", "groups",
                           "rows", "v", "ch", "z0", "zg")
    assert (plan["z0"], plan["zg"]) == (0, 20)


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
    2 df rows of one image, the full-size image under a level-0 df; the
    C = 36 segmentation maps at each flagship level, 1 and 10 df rows."""
    out = []
    for full, levels in (((160, 192, 224), [(40, 48, 56), (20, 24, 28), (10, 12, 14)]),
                         ((192, 192, 208), [(48, 48, 52), (24, 24, 26), (12, 12, 13)])):
        for size in (full, *levels):
            out.append(((1, *size, 1), (1, *size, 3)))
        out.append(((1, *full, 1), (2, *full, 3)))
    out.append(((1, 160, 192, 224, 1), (2, 80, 96, 112, 3)))
    for size in ((160, 192, 224), (40, 48, 56), (20, 24, 28), (10, 12, 14)):
        out += [((1, *size, 36), (rows, *size, 3)) for rows in (1, 10)]
    return out


@pytest.mark.parametrize("moving,df", _dfgrad_launches())
def test_dfgrad_plan_at_the_training_shapes(moving, df):
    """The df-cotangent takes the forward warp's voxel plan over the df's
    output space (kernels/warp.py:dfgrad_plan) at every C, the C = 36
    segmentation shapes too: one voxel a thread, the entry's checks
    passed, every output voxel of every df row computed and written once."""
    plan = warp.dfgrad_plan(moving, df)
    assert plan == warp.tile_plan(moving[:-1] + (1,), df)
    size = gather.axes(df[1:-1])
    n = math.prod(size)
    assert plan["v"] == 1 and plan["ch"] == 0
    assert _admissible(plan, size, df[0] // moving[0], moving[0], n * max(3, moving[-1]))
    for counts in _axis_counts(plan, size):
        assert (counts == 1).all()
    grid = _grid(plan, moving[0])
    rows = [_block_rows(plan, bz, moving[0], df[0])[1] for bz in range(grid[2])]
    assert sorted(r for rs in rows for r in rs) == list(range(df[0]))


@pytest.mark.parametrize("size", RAGGED)
def test_dfgrad_walk_matches_the_axis_decode(size):
    """On ragged sizes the block-by-block walk (`_walk`) and the per-axis
    decode above agree: the decode is the walk's product."""
    plan = warp.dfgrad_plan((2, *size, 1), (6, *size, 3))
    stored, _ = _walk(plan, size, 2, 6)
    zc, yc, xc = _axis_counts(plan, size)
    assert (stored == 1).all()
    assert (zc[:, None, None] * yc[None, :, None] * xc[None, None, :] == stored[0]).all()


# ----------------------------------------------------------------------
# the channel bodies (plan ch = 4 or 1): threads run across channels
# ----------------------------------------------------------------------

def _seg_launches():
    """(moving shape, df shape) of the C = 36 warps the paths launch:
    `transform_segmentation` at each flagship level (the OASIS step, 1
    row; the tables and figures, 1 row and N = 10 rows reading one map),
    and the 2D OASIS evaluation's 10 rows of 160x192."""
    out = []
    for size in ((160, 192, 224), (40, 48, 56), (20, 24, 28), (10, 12, 14)):
        for rows in (1, 10):
            out.append(((1, *size, 36), (rows, *size, 3)))
    for rows in (1, 10):
        out.append(((rows, 160, 192, 36), (rows, 160, 192, 2)))
    return out


def _forward_threads(plan, c):
    """(voxel j of the line's tx, lane) of each thread of a forward block
    (csrc/warp.cu:warp_channels_kernel: threadIdx.x = j * L + lane)."""
    lanes = gather.lanes(c, plan["ch"])
    t = np.arange(plan["tx"] * lanes)
    return t // lanes, t % lanes


def _channel_walk(plan, size, c, movings, b_df):
    """How often each (df row, z, y, x, channel) is written by a forward
    launch: block by block, the block's threads (j, lane) over the tile's
    lines and planes and the group's rows, a lane's chunks lane, lane + L,
    ... of plan["ch"] channels."""
    z_, y_, x_ = size
    ch, lanes = plan["ch"], gather.lanes(c, plan["ch"])
    j, lane = _forward_threads(plan, c)
    counts = np.zeros((b_df, z_, y_, x_, c), np.int32)
    gx, gy, gz = _grid(plan, movings)
    for bz in range(gz):
        _, rows = _block_rows(plan, bz, movings, b_df)
        for by in range(gy):
            for bx in range(gx):
                z0, y0, x0 = _tile(plan, bx, by)
                x = x0 + j
                for lz in range(plan["tz"]):
                    for ly in range(plan["ty"]):
                        z, y = z0 + lz, y0 + ly
                        if z >= z_ or y >= y_:
                            continue
                        for q0 in range(0, c // ch, lanes):
                            q = lane + q0
                            ok = (x < x_) & (q < c // ch)
                            for r in rows:
                                for e in range(ch):
                                    np.add.at(counts, (r, z, y, x[ok], q[ok] * ch + e), 1)
    return counts


def _admissible_channels(plan, size, c, rows_per_moving, movings):
    """The checks `gather::valid` makes before a channel body's launch."""
    z_, y_, x_ = size
    return (plan["ch"] in (1, 4) and c % plan["ch"] == 0 and plan["v"] == 1
            and plan["tx"] * gather.lanes(c, plan["ch"]) <= gather.THREADS
            and (plan["tx"] << plan["log_strips"]) >= x_ and plan["ty"] * plan["tiles_y"] >= y_
            and plan["tz"] * plan["tiles_z"] >= z_ and plan["tiles_z"] <= 65535
            and plan["groups"] == gather.cdiv(rows_per_moving, plan["rows"])
            and movings * plan["groups"] <= 65535)


@pytest.mark.parametrize("moving,df", _seg_launches())
def test_channel_plan_at_the_segmentation_shapes(moving, df):
    """At C = 36 on aligned tensors the warp takes the quad body (ch = 4,
    9 lanes a voxel); the plan passes the entry's checks; along each axis
    every voxel is reached once (the walk is the product of the axes,
    `test_channel_walk_is_the_axes_product`), every channel of a voxel by
    one lane, and the df rows once, in groups that read one moving row."""
    spatial = df[1:-1]
    size = gather.axes(spatial)
    plan = warp.tile_plan(moving, df)
    assert plan["ch"] == 4 and gather.lanes(36, 4) == 9
    assert _admissible_channels(plan, size, 36, df[0] // moving[0], moving[0])
    for counts in _axis_counts(plan, size):
        assert (counts == 1).all()
    j, lane = _forward_threads(plan, 36)
    pairs = set(zip(j.tolist(), lane.tolist()))
    assert pairs == {(a, b) for a in range(plan["tx"]) for b in range(9)} and len(pairs) == len(j)
    grid = _grid(plan, moving[0])
    rows = [_block_rows(plan, bz, moving[0], df[0])[1] for bz in range(grid[2])]
    assert sorted(r for rs in rows for r in rs) == list(range(df[0]))


CHANNEL_CASES = [((1, 6, 7, 9), (1, 6, 7, 9), 36, True), ((2, 5, 6, 11), (4, 5, 6, 11), 5, True),
                 ((1, 4, 5, 13), (3, 4, 5, 13), 36, False), ((1, 3, 4, 5), (2, 3, 4, 5), 132, True),
                 ((2, 7, 9), (4, 7, 9), 36, True), ((1, 5, 6, 11), (2, 5, 6, 11), 8, True)]


@pytest.mark.parametrize("blocks", [gather.TARGET_BLOCKS, 1])
@pytest.mark.parametrize("moving,df,c,is_aligned", CHANNEL_CASES)
def test_channel_walk_writes_every_channel_once(monkeypatch, moving, df, c, is_aligned,
                                                blocks):
    """Ragged sizes, C = 5 (single channels), C = 36 on a misaligned base
    (single channels), C = 132 (quads past a warp's 32 lanes), a 2D
    field, df rows read as r % B: block by block, the forward's threads
    write every (row, voxel, channel) exactly once, at the launch's own
    plan and (`blocks` 1) with tiles of several lines and one group of
    all df rows."""
    monkeypatch.setattr(gather, "TARGET_BLOCKS", blocks)
    b, b_df = moving[0], df[0]
    plan = gather.warp_plan(df[1:], b_df, b, c=c, is_aligned=is_aligned)
    assert plan["ch"] == (4 if c % 4 == 0 and is_aligned else 1)
    size = gather.axes(df[1:])
    assert _admissible_channels(plan, size, c, b_df // b, b)
    assert (_channel_walk(plan, size, c, b, b_df) == 1).all()


@pytest.mark.parametrize("moving,df,c,is_aligned", CHANNEL_CASES[:3])
def test_channel_walk_is_the_axes_product(moving, df, c, is_aligned):
    """The block-by-block walk of one row is the product of the per-axis
    decode and the lanes' chunks, so the axis checks at the paths' full
    sizes stand for the walk."""
    plan = gather.warp_plan(df[1:], 1, 1, c=c, is_aligned=is_aligned)
    size = gather.axes(df[1:])
    walk = _channel_walk(plan, size, c, 1, 1)[0]
    zc, yc, xc = _axis_counts(plan, size)
    assert (walk == (zc[:, None, None] * yc[None, :, None] * xc[None, None, :])[..., None]).all()


@pytest.mark.parametrize("c", [36, 8, 5, 132])
@pytest.mark.parametrize("base", [0, 4, 8, 12])
def test_16_byte_chunks_only_where_aligned(c, base):
    """A channel plan takes 16-byte chunks (ch = 4) only where C is a
    multiple of 4 and the base is 16-byte aligned (the wrappers'
    `gather.aligned`; the df-cotangent's launch makes the same test of the
    map and the cotangent); then every chunk of every voxel starts on a
    16-byte boundary (element (v, q) at byte base + 4 (v C + 4 q)).
    Elsewhere it takes single channels; C <= 4 and channels-first
    launches keep the voxel bodies (ch = 0)."""
    plan = gather.warp_plan((6, 7, 9), 1, 1, c=c, is_aligned=base % 16 == 0)
    assert plan["ch"] == (4 if c % 4 == 0 and base % 16 == 0 else 1)
    if plan["ch"] == 4:
        v, q = np.meshgrid(np.arange(6 * 7 * 9), np.arange(c // 4), indexing="ij")
        assert ((base + 4 * (v * c + 4 * q)) % 16 == 0).all()
    for small in (1, 3, 4):
        assert gather.warp_plan((6, 7, 9), 1, 1, c=small)["ch"] == 0
    assert gather.warp_plan((6, 7, 9), 1, 1, cf=True, c=c)["ch"] == 0


def test_aligned_reads_the_data_pointers():
    """`gather.aligned`: every tensor's data on a 16-byte boundary; a
    contiguous view one float in is not."""
    import torch

    t = torch.zeros(64)
    assert gather.aligned(t) and not gather.aligned(t, t[1:]) and gather.aligned(t[4:])


# ----------------------------------------------------------------------
# slab launches
# ----------------------------------------------------------------------

def _global_planes(plan, size, movings, b_df):
    """Per df row, how often each global output plane's voxels are
    computed by a slab launch (local plane z of a tile -> z + z0)."""
    z_, y_, x_ = size
    counts = np.zeros((b_df, plan["zg"], y_, x_), np.int32)
    stored, _ = _walk(plan, size, movings, b_df)
    counts[:, plan["z0"]:plan["z0"] + z_] = stored
    return counts


@pytest.mark.parametrize("whole,parts", [(16, 4), (16, 2), (20, 2), (80, 2), (8, 4)])
def test_slab_plans_walk_their_planes_once(whole, parts):
    """The warp's and the squaring step's slab launches, each slab's plan
    made over its own planes: every voxel of every global plane written by
    exactly one slab, once; each plan passes the entry points' checks."""
    y_, x_ = 7, 13
    per = whole // parts
    warp_total = np.zeros((3, whole, y_, x_), np.int32)
    step_total = np.zeros((2, whole, y_, x_), np.int32)
    for r in range(parts):
        size = (per, y_, x_)
        wplan = gather.slab(gather.warp_plan(size, 3, 1), r * per, whole)
        splan = gather.slab(gather.squaring_plan(size, 2), r * per, whole)
        assert _admissible(wplan, size, 3, 1, whole * y_ * x_ * 3)
        assert _admissible(splan, size, 1, 2, whole * y_ * x_ * 3)
        warp_total += _global_planes(wplan, size, 1, 3)
        step_total += _global_planes(splan, size, 2, 2)
    assert (warp_total == 1).all() and (step_total == 1).all()
    bad = gather.slab(gather.squaring_plan((per, y_, x_), 2), whole - per + 1, whole)
    assert not _admissible(bad, (per, y_, x_), 1, 2, whole * y_ * x_ * 3)


# flagship-2d's levels that split at space 2 (160 x 192 and its 80 x 96,
# 40 x 48 and 20 x 24: slabs of 80, 40, 20 and 10 lines; the depth-10
# level runs replicated) and a ragged 4-way split
SLABS_2D = [((160, 192), 2), ((80, 96), 2), ((40, 48), 2), ((20, 24), 2), ((16, 13), 4)]


@pytest.mark.parametrize("whole,parts", SLABS_2D, ids=[f"{w[0]}x{w[1]}-{p}" for w, p in SLABS_2D])
def test_2d_slab_plans_walk_their_lines_once(whole, parts):
    """The 2D warp's voxel body (C = 1, 2 df rows a moving row) and the
    2D step's slab launches along H, each slab's plan made over its own
    lines: every pixel of every global line written by exactly one slab,
    once (local line y -> y + z0); each plan passes the entry points'
    checks with the slab along the plan's y; a slab past the whole is
    refused."""
    h, w = whole
    per = h // parts
    warp_total = np.zeros((2, h, w), np.int32)
    step_total = np.zeros((2, h, w), np.int32)
    for r in range(parts):
        z0, size = r * per, (1, per, w)
        wplan = gather.slab(warp.tile_plan((1, h, w, 1), (2, per, w, 2)), z0, h)
        splan = gather.slab(squaring.tile_plan((2, per, w, 2)), z0, h)
        assert wplan["ch"] == 0 and wplan["v"] == 1 and (wplan["z0"], wplan["zg"]) == (z0, h)
        assert _admissible(wplan, size, 2, 1, h * w * 2, flat=True)
        assert _admissible(splan, size, 1, 2, h * w * 2, flat=True)
        warp_total[:, z0:z0 + per] += _walk(wplan, size, 1, 2)[0][:, 0]
        step_total[:, z0:z0 + per] += _walk(splan, size, 2, 2)[0][:, 0]
    assert (warp_total == 1).all() and (step_total == 1).all()
    bad = gather.slab(squaring.tile_plan((2, per, w, 2)), h - per + 1, h)
    assert not _admissible(bad, (1, per, w), 1, 2, h * w * 2, flat=True)


@pytest.mark.parametrize("whole,per,rows", [((160, 192), 80, 1), ((160, 192), 80, 10),
                                            ((20, 24), 10, 2), ((16, 13), 4, 3)])
def test_2d_channel_slab_plans_write_every_channel_once(whole, per, rows):
    """The 2D warp's channel body at C = 36 on slabs along H (the 2D
    Dice step's one-hot maps; aligned, so 16-byte quads, 9 lanes a
    pixel; single channels off a 16-byte boundary): the entry's checks
    with the slab along y, every (row, line,
    pixel, channel) of the whole written by one slab, once (walked block
    by block below 20 x 24, by the per-axis decode at 160 x 192)."""
    h, w = whole
    total = np.zeros((rows, h, w, 36), np.int32)
    lines = np.zeros(h, np.int32)
    for z0 in range(0, h, per):
        size = (1, per, w)
        plan = gather.slab(warp.tile_plan((1, h, w, 36), (rows, per, w, 2)), z0, h)
        assert plan["ch"] == 4 and gather.lanes(36, 4) == 9
        assert warp.tile_plan((1, h, w, 36), (rows, per, w, 2), is_aligned=False)["ch"] == 1
        assert _admissible_channels(plan, size, 36, rows, 1)
        assert plan["z0"] >= 0 and plan["z0"] + per <= plan["zg"] == h
        zc, yc, xc = _axis_counts(plan, size)
        assert (zc == 1).all() and (yc == 1).all() and (xc == 1).all()
        lines[z0:z0 + per] += yc
        if h * w <= 20 * 24:
            total[:, z0:z0 + per] += _channel_walk(plan, size, 36, 1, rows)[:, 0]
    assert (lines == 1).all()
    if h * w <= 20 * 24:
        assert (total == 1).all()


def test_squaring_bwd_slab_plan_covers_the_slab():
    """The step backward's slab plan: its chunks of tz planes cover the
    slab's planes, and the slab lies in the whole field."""
    for whole, per, z0 in ((80, 40, 40), (16, 4, 12), (10, 5, 0)):
        plan = gather.slab(gather.squaring_bwd_plan((per, 24, 28), 1), z0, whole)
        assert plan["tz"] * plan["tiles_z"] >= per > plan["tz"] * (plan["tiles_z"] - 1)
        assert plan["zg"] == whole and 0 <= plan["z0"] <= whole - per


def _slab_fields():
    rng = np.random.default_rng(90)
    shape = (2, 8, 6, 7)
    v = torch.from_numpy(rng.uniform(-2, 2, (*shape, 3)).astype(np.float32))
    moving = torch.from_numpy(rng.random((2, 11, 5, 9, 1), dtype=np.float32))
    df = torch.from_numpy(rng.uniform(-3, 3, (4, *shape[1:], 3)).astype(np.float32))
    g1 = torch.from_numpy(rng.standard_normal((4, *shape[1:], 1)).astype(np.float32))
    g3 = torch.from_numpy(rng.standard_normal((*shape, 3)).astype(np.float32))
    return v, moving, df, g1, g3


@pytest.mark.parametrize("z0,planes", [(0, 4), (4, 4), (2, 3), (6, 2), (0, 8)])
def test_plain_versions_at_an_offset_are_slices_of_the_whole(z0, planes):
    v, moving, df, g1, g3 = _slab_fields()
    sl = slice(z0, z0 + planes)
    whole = v.shape[1]
    assert torch.equal(warp.warp_plain(moving, df[:, sl], z0, whole),
                       warp.warp_plain(moving, df)[:, sl])
    assert torch.equal(warp.warp_dfgrad_plain(moving, df[:, sl], g1[:, sl], z0, whole),
                       warp.warp_dfgrad_plain(moving, df, g1)[:, sl])
    assert torch.equal(squaring.squaring_step_plain(v, z0, planes),
                       squaring.squaring_step_plain(v)[:, sl])
    masked = torch.zeros_like(g3)
    masked[:, sl] = g3[:, sl]
    share = squaring.squaring_step_bwd_plain(v, g3[:, sl], z0)
    assert share.shape == v.shape
    assert torch.equal(share, squaring.squaring_step_bwd_plain(v, masked))
    assert torch.equal(squaring.squaring_step(v, z0=z0, depth=planes, scale=0.5),
                       squaring.squaring_step(v * 0.5)[:, sl])


@pytest.mark.parametrize("z0,lines", [(0, 4), (4, 4), (2, 3), (6, 2), (0, 8)])
def test_2d_plain_versions_at_an_offset_are_slices_of_the_whole(z0, lines):
    """In 2D the slab runs along H: the warp (C = 1 and 36) and the
    squaring step of lines z0.. are the matching lines of the whole."""
    rng = np.random.default_rng(91)
    v = torch.from_numpy(rng.uniform(-2, 2, (2, 8, 7, 2)).astype(np.float32))
    df = torch.from_numpy(rng.uniform(-3, 3, (4, 8, 7, 2)).astype(np.float32))
    sl = slice(z0, z0 + lines)
    for c in (1, 36):
        moving = torch.from_numpy(rng.random((2, 11, 9, c), dtype=np.float32))
        assert torch.equal(warp.warp(moving, df[:, sl], z0, 8), warp.warp_plain(moving, df)[:, sl])
    assert torch.equal(squaring.squaring_step_plain(v, z0, lines),
                       squaring.squaring_step_plain(v)[:, sl])
    assert torch.equal(squaring.squaring_step(v, z0=z0, depth=lines, scale=0.5),
                       squaring.squaring_step(v * 0.5)[:, sl])


def test_the_slabs_shares_sum_to_the_whole_backward():
    """The step backward's shares of two slabs add up to the whole
    backward (within float32 rounding: the sums are reordered)."""
    v, _, _, _, g3 = _slab_fields()
    whole = squaring.squaring_step_bwd_plain(v, g3)
    shares = sum(squaring.squaring_step_bwd_plain(v, g3[:, z0:z0 + 4], z0) for z0 in (0, 4))
    assert float((shares - whole).abs().max()) <= 1e-6 * float(whole.abs().max())
