"""The tile plan of the gather kernels (`csrc/warp.cu`, `csrc/squaring.cu`)
and of the squaring step's backward (`csrc/squaring_bwd.cu`).

The wrappers compute each launch's plan here and pass it to the C entry
points as 9 ints (`plan_arg`, `gather::Plan` in `csrc/gather.cuh`); the
kernels walk exactly that plan, and the entry points refuse one that
does not cover the output. `tests/test_torch_gather_plan.py` holds the
plans the paths launch to the kernels' walk: every output voxel of
every row written once, 16-byte accesses only where aligned.

A plan is a dict: `tx, ty, tz` (a block's threads along x, each with `v`
voxels, its lines and planes), `log_strips` (tiles along x:
2**log_strips), `tiles_y, tiles_z`, `groups` (df row groups per moving
row), `rows` (df rows a group) and `v` (voxels a thread: 1, each thread
its own voxel; or, in a large channels-first warp, 4, moved as 16-byte
quads through a tile in shared memory). Axes are (z, y, x) with x the
innermost; a 2D field has z = 1.

The squaring backward's plan (`squaring_bwd_plan`) is the same 9 ints
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

KEYS = ("tx", "ty", "tz", "log_strips", "tiles_y", "tiles_z", "groups", "rows", "v")


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
            "tiles_z": tiles_z, "groups": groups, "rows": rows, "v": v}


def axes(spatial) -> tuple[int, int, int]:
    """(z, y, x) of a 3D or 2D size."""
    spatial = tuple(spatial)
    return spatial if len(spatial) == 3 else (1, *spatial)


def warp_plan(out_spatial, b_df: int, movings: int, cf: bool = False,
              v: int | None = None) -> dict:
    """The plan of `pulpo_warp{,_cf,_2d}` for a df of `b_df` rows over
    `out_spatial`, reading `movings` moving rows (channels-first with
    `cf`; `v`: 4 on a channels-first launch of at least
    WARP_CF_QUADS_FROM voxels, else 1, unless given)."""
    z, y, x = axes(out_spatial)
    if v is None:
        v = 4 if cf and b_df * x * y * z >= WARP_CF_QUADS_FROM else 1
    return make_plan(x, y, z, b_df // movings, movings, v)


def squaring_plan(spatial, rows: int) -> dict:
    """The plan of `pulpo_squaring_step{,_cf,_2d}` on `rows` fields over
    `spatial`: one voxel a thread."""
    z, y, x = axes(spatial)
    return make_plan(x, y, z, 1, rows, 1)


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
    return dict(plan, tz=tz, tiles_z=cdiv(z, tz))


def plan_arg(plan: dict):
    """`plan` as the C entry points take it (`gather::Plan`): 9 ints."""
    return (ctypes.c_int * len(KEYS))(*(plan[k] for k in KEYS))
