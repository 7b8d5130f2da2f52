"""The tile plan of the gather kernels (`csrc/warp.cu`, `csrc/squaring.cu`)
and of the squaring step's backward (`csrc/squaring_bwd.cu`).

The wrappers compute each launch's plan here and pass it to the C entry
points as 12 ints (`plan_arg`, `gather::Plan` in `csrc/gather.cuh`); the
kernels walk exactly that plan, and the entry points refuse one that
does not cover the output. `tests/test_torch_gather_plan.py` holds the
plans the paths launch to the kernels' walk: every output voxel of
every row written once, 16-byte accesses only where aligned.

A plan is a dict: `tx, ty, tz` (a block's threads along x, each with `v`
voxels, its lines and planes), `log_strips` (tiles along x:
2**log_strips), `tiles_y, tiles_z`, `groups` (df row groups per moving
row), `rows` (df rows a group), `v` (voxels a thread: 1, each thread
its own voxel; or, in a large channels-first warp, 4, moved as 16-byte
quads through a tile in shared memory) and `ch` (0 but in a channel
body). Axes are (z, y, x) with x the innermost; a 2D field has z = 1.

A channels-last warp of CHANNELS_FROM channels or more takes a channel
body (`channel_plan`): its threads run across channels, `lanes(c, ch)`
threads a voxel, each moving chunks of `ch` channels: 4 (16-byte quads)
where the channels are a multiple of 4 and the pointers the kernel moves
quads of are 16-byte aligned (`aligned`), else 1. There `tx` is the
voxels of a line a block takes (tx * lanes threads) and `ty, tz` the
lines and planes it walks in turn. The df-cotangent takes the voxel
plan at every C.

`z0, zg`: a slab launch (`slab`; the depth-sharded model,
parallel/spatial.py) computes output planes z0 .. z0 + Z - 1 of a whole
output of depth zg, its voxels' source coordinates taken at their
global plane; a whole launch has z0 = 0 and zg = Z. The squaring step
and its backward then read (and the backward writes) the whole field.
The same two ints run along the field's first spatial axis in every
launch: in a 2D launch that is H, the plan's y (z = 1), so there they
are the slab's first line and the whole field's lines (a whole 2D
launch: z0 = 0, zg = Y), and the step reads the whole field of zg
lines.

The squaring backward's plan (`squaring_bwd_plan`) is the same 12 ints
read another way: a block of tx x ty threads, one source column each,
marches `tz` planes along z (a chunk; `tiles_z` chunks), merging the
terms of a cell it sends twice before it sends them.
`tests/test_torch_box_sum_bwd_plan.py` walks it as the kernel does.
"""

from __future__ import annotations

import ctypes

THREADS = 256         # threads a block, at most
STRIP = 128           # voxels of a tile along x, at most
TARGET_BLOCKS = 2048  # a warp's rows are grouped until a launch has as many
# the channels-first warp launches (output voxels of all rows) from which
# a thread takes 4-voxel quads; every other gather launch takes 1 voxel a
# thread, measured faster at every shape the paths launch (PERF.md,
# scripts/bench_gather.py times both plans of the warp)
WARP_CF_QUADS_FROM = 1 << 24
BWD_STRIP = 32             # squaring backward: a tile's voxels along x, at most
BWD_TARGET_BLOCKS = 264    # its chunks along z: as few as give a launch as many blocks
CHANNELS_FROM = 5  # a channels-last warp of this many channels or more runs across channels
LINES = 8          # lines a channel body's block walks, at most

KEYS = ("tx", "ty", "tz", "log_strips", "tiles_y", "tiles_z", "groups", "rows", "v", "ch",
        "z0", "zg")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def make_plan(x: int, y: int, z: int, rows_per_moving: int, movings: int, v: int,
              strip: int = STRIP) -> dict:
    """The plan over z x y x x output voxels a row, `movings` moving rows
    each read by `rows_per_moving` df rows, `v` voxels a thread: strips
    of at most `strip` voxels (a power-of-two count along x), blocks of at
    most THREADS threads filled with whole lines, then planes, and the
    df rows of a moving row split into as few groups as give a launch
    TARGET_BLOCKS blocks."""
    q = cdiv(x, v)
    strips, log_strips = 1, 0
    while strips * (strip // v) < q:
        strips *= 2
        log_strips += 1
    tx = cdiv(q, strips)
    ty = max(1, min(THREADS // tx, y))
    tz = max(1, min(THREADS // (tx * ty), z))
    tiles_y, tiles_z = cdiv(y, ty), cdiv(z, tz)
    per_moving = (tiles_y * tiles_z * movings) << log_strips
    groups = min(cdiv(TARGET_BLOCKS, per_moving), rows_per_moving)
    rows = cdiv(rows_per_moving, max(groups, 1))
    groups = cdiv(rows_per_moving, rows)
    return {"tx": tx, "ty": ty, "tz": tz, "log_strips": log_strips, "tiles_y": tiles_y,
            "tiles_z": tiles_z, "groups": groups, "rows": rows, "v": v, "ch": 0, "z0": 0,
            "zg": z}


def lanes(c: int, ch: int) -> int:
    """Threads a voxel in a channel body (`gather::lanes`): one a chunk
    of `ch` of the `c` channels, at most 32 (a lane then takes every 32nd
    chunk)."""
    return min(c // ch, 32)


def aligned(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def channel_plan(x: int, y: int, z: int, rows_per_moving: int, movings: int, c: int,
                 ch: int) -> dict:
    """The channel body's plan over z x y x x output voxels of `c`
    channels: strips of at most THREADS // lanes voxels (a power-of-two
    count along x), each block walking up to LINES lines of one plane, as
    many as leave the launch TARGET_BLOCKS blocks (neighbouring lines
    share half their corners, which the block then reads from L1), and
    the df rows of a moving row split into as few groups as give a launch
    TARGET_BLOCKS blocks (the rows of a group share the moving slabs)."""
    most = THREADS // lanes(c, ch)
    strips, log_strips = 1, 0
    while strips * most < x:
        strips *= 2
        log_strips += 1
    per_line = strips * movings
    ty = 1
    while 2 * ty <= min(LINES, y) and per_line * cdiv(y, 2 * ty) * z >= TARGET_BLOCKS:
        ty *= 2
    per_moving = strips * cdiv(y, ty) * z
    groups = min(cdiv(TARGET_BLOCKS, per_moving * movings), rows_per_moving)
    rows = cdiv(rows_per_moving, max(groups, 1))
    return {"tx": cdiv(x, strips), "ty": ty, "tz": 1, "log_strips": log_strips,
            "tiles_y": cdiv(y, ty), "tiles_z": z, "groups": cdiv(rows_per_moving, rows),
            "rows": rows, "v": 1, "ch": ch, "z0": 0, "zg": z}


def axes(spatial) -> tuple[int, int, int]:
    """(z, y, x) of a 3D or 2D size."""
    spatial = tuple(spatial)
    return spatial if len(spatial) == 3 else (1, *spatial)


def warp_plan(out_spatial, b_df: int, movings: int, cf: bool = False,
              v: int | None = None, c: int = 1, is_aligned: bool = True) -> dict:
    """The plan of `pulpo_warp{,_cf,_2d}` (and, at the default `c`, of
    `pulpo_warp_dfgrad`) for a df of `b_df` rows over `out_spatial`,
    reading `movings` moving rows of `c` channels (channels-first with
    `cf`): a channel body on a channels-last launch of CHANNELS_FROM
    channels or more, of 16-byte quads where `c` is a multiple of 4 and
    the launch's pointers are aligned (`is_aligned`), else of single
    channels; else a voxel body of `v` voxels a thread: 4 on a
    channels-first launch of at least WARP_CF_QUADS_FROM voxels whose df
    and output are aligned (`is_aligned`), else 1, unless given."""
    z, y, x = axes(out_spatial)
    ch = 0 if cf or c < CHANNELS_FROM else (4 if c % 4 == 0 and is_aligned else 1)
    if ch:
        return whole(channel_plan(x, y, z, b_df // movings, movings, c, ch), out_spatial)
    if v is None:
        v = 4 if cf and is_aligned and b_df * x * y * z >= WARP_CF_QUADS_FROM else 1
    return whole(make_plan(x, y, z, b_df // movings, movings, v), out_spatial)


def squaring_plan(spatial, rows: int) -> dict:
    """The plan of `pulpo_squaring_step{,_cf,_2d}` on `rows` fields over
    `spatial`: one voxel a thread."""
    z, y, x = axes(spatial)
    return whole(make_plan(x, y, z, 1, rows, 1), spatial)


def squaring_bwd_plan(spatial, rows: int) -> dict:
    """The plan of `pulpo_squaring_step_bwd` on `rows` fields over a 3D
    `spatial`: tiles of one plane (strips of at most BWD_STRIP voxels,
    whole lines), each block marching a chunk of `tz` planes along z, z
    split into as few chunks as give the launch BWD_TARGET_BLOCKS
    blocks."""
    z, y, x = axes(spatial)
    plan = make_plan(x, y, 1, 1, rows, 1, strip=BWD_STRIP)
    per_chunk = (plan["tiles_y"] << plan["log_strips"]) * rows
    tz = cdiv(z, min(z, cdiv(BWD_TARGET_BLOCKS, per_chunk)))
    return dict(plan, tz=tz, tiles_z=cdiv(z, tz), zg=z)


def whole(plan: dict, spatial) -> dict:
    """`plan` as the whole launch over `spatial`: z0 = 0 and zg its first
    axis's extent (a volume's depth, a 2D field's lines)."""
    return dict(plan, z0=0, zg=int(tuple(spatial)[0]))


def slab(plan: dict, z0: int, zg: int) -> dict:
    """`plan` (over a slab's planes, or a 2D slab's lines) as a slab
    launch: output planes (lines) z0 .. of a whole output of `zg`."""
    return dict(plan, z0=int(z0), zg=int(zg))


def plan_arg(plan: dict):
    """`plan` as the C entry points take it (`gather::Plan`): 12 ints."""
    return (ctypes.c_int * len(KEYS))(*(plan[k] for k in KEYS))
