"""Depth sharding of volumes over a (data, space) mesh, with every
exchange written by hand over `torch.distributed`.

Port of pulpo_tpu/parallel/spatial.py. The JAX package shards each
volume's depth axis over a `space` mesh axis by annotation, and XLA's
SPMD partitioner inserts the halo exchanges of the convs and the
collectives of the pooling, resizes, warp gathers, loss reductions and
gradient sums. PyTorch has no such partitioner, so the ops of the port
consult a process-wide context, `sharded(mesh, cfg)` (as BatchNorm
consults `BatchNorm.synced`), and do each exchange themselves:

- layout: rank r of a (data, space) mesh (`make_2d_mesh`, rank r at
  (r // space, r % space)) holds batch rows d * B .. of the global batch
  and, at every level whose depth D splits (`splits`: D = space * an even
  number of planes), planes s * D / space .. of its depth; a level that
  does not split (the flagship's coarsest, D = 10, at space 2 would have
  slabs of 5 planes with odd boundaries) runs REPLICATED: each rank of the
  space column holds and computes the whole level, and a tensor enters it
  by an all-gather and leaves it by taking the rank's slab. This is a
  stated design, not a fallback. The 2D configuration is sharded the same
  way along its first spatial axis, H (the JAX P("data", "space") of a
  (B, H, W, C) image): a "plane" of a slice is one of its lines, every op
  below takes 4-dim tensors as 5-dim ones, and the 2D kernels take the
  same slab launches. Which level a tensor belongs to is read from its
  plane ((H, W) of a volume, (W,) of a slice), unique to a level of the
  pyramid (`sharded` refuses a configuration where it is not);
- k = 3 convs (`conv`) run on the slab plus a 1-plane halo on each side
  toward the neighbours (`halo`; at the volume's own ends none, where the
  conv's zero padding is the volume's), cropped to the slab; the fused
  eval chains take a halo as deep as the chain (`on_halo`: the conv chain
  3, the posterior head 4, the velocity head 2). The halo's backward adds
  its cotangents back into the neighbours' edge planes;
- pooling (`avg_pool`) is local between two split levels (slab
  boundaries on even planes); the depth matmul of a resize (`resize`)
  takes the band of input planes its output rows read, by the same halo
  exchange, and multiplies it by its row block of the matrix: no
  all-gather of the volume;
- gathers whose reads cross slabs (the warp of a level image, each
  squaring step of an integration): the moving volume is all-gathered
  along depth and the rank computes its own output slab by a slab launch
  (`kernels/gather.py:slab`); the squaring backward's data term is summed
  over the space column in fixed point (the column's max |g| rides on the
  step's all-gather, and each rank sends each other rank the int64 sums
  of the other's planes that its own terms reach, one all-to-all:
  `_column`), so each rank gets its slab of the whole field's cotangent
  bit for bit as the unsharded backward gives it (the backward of the
  all-gather). A 2D integration launches
  the 2D step's slabs and, as the whole 2D one, is differentiated as its
  plain version (the plain slab steps on differentiable gathers; no
  backward kernel), its warp likewise. The channels-first fields of
  the full_res eval decode (B, 3, d, H, W) are read by their plane too
  (`layout(x, cf=True)`) and gathered along their depth axis, 2:
  `integrate_svf_cf` slab-launches the CF step (#3) on each step's
  gathered field, `batched_level_warp_cf` the CF image warp (#8) of the
  gathered image by the rank's slab of all levels' stacked dfs. The
  full_res train step stays channels-last: its batched warp is a slab
  launch of #4 with L df rows a moving row;
- losses: every sum or mean over voxels becomes the slab's partial sum
  (a replicated level's terms count 1 / space on each rank), so that the
  loss summed over the space column is the whole one; the normalisers
  stay the whole volume's voxel counts (ops/losses.py). A loss that is
  not a sum of per-voxel terms (the Dice ratio, the Jacobian
  determinant's standard deviation) is built on partial statistics
  summed over the ranks (`sum_partials`, a differentiable all-reduce)
  and weighted by the rule below;
- sampling noise: a rank draws the whole (global batch, whole depth)
  noise of each level, as the unsharded model does from the same seed,
  and takes its block (`block`).

Backends: the exchanges use all-gather, all-reduce and (the squaring
backward's sums) all-to-all, which both gloo and NCCL take. NCCL gathers
on the card; gloo's all-gather and all-to-all take CPU tensors only, so
a gloo rank stages its CUDA tensors through the host (two ranks sharing
one card need gloo: NCCL refuses two ranks on one device). No
collective's failure is caught.

The weight of a term on reduced statistics. `spatial_compute_grads`
sums the gradients over the space column and averages them over the data
row. Take a term L = f(S), S a sum of partial statistics over a group of
G ranks (`_SumOver`: forward the all-reduce, backward the all-reduce of
the cotangent). Each rank adds w * L to its loss; the backward gives each
rank's partial the cotangent G * w * f'(S), and its gradient is G * w *
f'(S) dS_r/dθ. Summed over space and averaged over data:
- S over the space column (G = space; the Dice ratio, a mean over the
  batch of per-row ratios): each data row's sum is space * w * dL_d/dθ,
  L_d the mean over its own rows, and the data mean of equal local
  batches is the global mean, so w = 1 / space gives dL/dθ;
- S over the whole world (G = data * space; the Jacobian determinant's
  standard deviation, a statistic of the whole global batch): the sum
  over all ranks of data * space * w * f'(S) dS_r/dθ, divided by data, is
  space * w * dL/dθ: again w = 1 / space.
A replicated level keeps w = 1 / space: its statistics are whole on
every rank of the column, so they are summed over the data row only (a
world statistic) or not at all (a column statistic), and the column's
space copies of w * L make one L. The metrics follow the same rule: w *
L summed over space and averaged over data is L (`statistic_weight`).

Remat (`remat`, `remat_down`; models/pulpo.py:remat): a checkpointed
region recomputes in the backward under the flags its forward saw
(`snapshot`, `restored`), so it issues the forward's exchanges again
(halo all-gathers, volume gathers, the resizes' and statistics'
all-reduces, the integration's per-step gathers, `BatchNorm.synced`'s
moments), the same collectives in the same order on every rank;
`traffic` counts them apart ("<kind>_recomputed", mesh.py:
`recomputing`). Why a remat step equals the plain sharded step:
models/pulpo.py's module doc.

`make_spatial_forward(model, mesh)` returns this rank's slab of the
level-0 final df and warped image; `make_spatial_train_step(model, tx,
mesh)` is the ordinary step (train/step.py) under `sharded(mesh)` and
`BatchNorm.synced(mesh.world)`, its gradients summed over the space
column and averaged over the data row in one flat bucket each.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pulpo_tpu_torch.kernels import plain_vjp, squaring
from pulpo_tpu_torch.kernels import warp as warp_kernel
from pulpo_tpu_torch.parallel.mesh import (Mesh, Mesh2D, Traffic, bucket_mean, bucket_sum,
                                            make_2d_mesh)

__all__ = ["make_2d_mesh", "volume_batch_spec", "replicated", "shard_volume",
           "with_spatial_constraint", "sharded", "make_spatial_forward",
           "make_spatial_train_step", "spatial_compute_grads", "traffic", "reset_traffic"]

QUEUE = "not ported under spatial sharding yet (ROADMAP.md Queue 1)"

# bytes and calls of each exchange on this rank since `reset_traffic`:
# "halo" (all-gathers of edge planes and of their cotangents), "gather"
# (all-gathers of whole volumes), "gather_seg" (those of the moving maps
# of more than one channel that a warp reads: the one-hot segmentation
# maps), "reduce" (all-reduces of whole-field cotangents
# and of a resize's partial products), "stats" (all-reduces of a loss's
# partial statistics and of their cotangents); bytes are the gathered or
# reduced buffer's. A checkpointed region's recomputation in the backward
# (remat) counts its exchanges again, apart: "<kind>_recomputed"
traffic = Traffic()
reset_traffic = traffic.clear


def _count(kind: str, t: torch.Tensor, n: int = 1) -> None:
    traffic.count(kind, t.numel() * t.element_size() * n)


def splits(depth: int, space: int) -> bool:
    """Whether a level of `depth` planes is split over `space` ranks:
    equal slabs of an even number of planes (so that pooling stays
    local); else it runs replicated."""
    return space > 1 and depth % space == 0 and (depth // space) % 2 == 0


def volume_batch_spec(mesh: Mesh2D, shape) -> tuple[slice, slice]:
    """(batch rows, depth planes) of a global (B, D, ...) volume that this
    rank holds: B over `data`, D over `space` where D splits."""
    b, depth = shape[0], shape[1]
    data, space = mesh.shape
    d, s = mesh.coords
    if b % data:
        raise ValueError(f"global batch {b} not divisible by data={data}")
    rows = slice(d * (b // data), (d + 1) * (b // data))
    if not splits(depth, space):
        return rows, slice(0, depth)
    per = depth // space
    return rows, slice(s * per, (s + 1) * per)


def replicated(mesh: Mesh2D, shape) -> tuple[slice, slice]:
    """The whole of a (B, D, ...) tensor: what every rank holds of a
    replicated one."""
    return slice(0, shape[0]), slice(0, shape[1])


def shard_volume(x, mesh: Mesh2D):
    """This rank's block (rows and depth slab) of a global volume."""
    rows, planes = volume_batch_spec(mesh, x.shape)
    return x[rows, planes]


def with_spatial_constraint(x, mesh: Mesh2D):
    """A whole activation (B, D, ...) pinned to the (data, space) layout:
    this rank's block of it (differentiable)."""
    return shard_volume(x, mesh)


# ----------------------------------------------------------------------
# the context
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _State:
    mesh: Mesh2D
    grids: dict  # the plane of a level ((H, W), or (W,) in 2D) -> its depth


_state: _State | None = None
_suspended = False


def active() -> bool:
    """Whether the ops run sharded (inside `sharded`, outside `suspended`)."""
    return _state is not None and not _suspended


@contextlib.contextmanager
def sharded(mesh: Mesh2D, cfg):
    """The ops inside run on this rank's block of every volume of the
    model of `cfg` (module doc)."""
    global _state
    grids: dict = {}
    for size in cfg.global_level_sizes.values():
        plane = tuple(size[1:])
        if grids.setdefault(plane, size[0]) != size[0]:
            raise NotImplementedError(f"two levels share the plane {plane}: {QUEUE}")
    before, _state = _state, _State(mesh, grids)
    try:
        yield
    finally:
        _state = before


@contextlib.contextmanager
def suspended():
    """Ops inside run as unsharded ops on the tensors they are given (a
    slab with its halo, or a replicated level's whole tensor)."""
    global _suspended
    before, _suspended = _suspended, True
    try:
        yield
    finally:
        _suspended = before


def snapshot() -> tuple:
    """The sharding flags in force (`sharded`'s state, `suspended`), for a
    checkpointed region to recompute under (`restored`)."""
    return _state, _suspended


@contextlib.contextmanager
def restored(flags: tuple):
    """The flags a checkpointed region's forward saw (`snapshot`), for its
    recomputation in the backward (models/pulpo.py:remat). The flags are
    process-wide, and autograd may recompute on its own thread while the
    caller's thread waits in the backward, so this sets them rather than
    trusting them."""
    global _state, _suspended
    before = (_state, _suspended)
    _state, _suspended = flags
    try:
        yield
    finally:
        _state, _suspended = before


def _space() -> Mesh:
    return _state.mesh.space


def split(depth: int) -> bool:
    return splits(depth, _state.mesh.shape[1])


def part(depth: int) -> tuple[int, int]:
    """(first plane, planes) of this rank's slab of a split depth."""
    per = depth // _state.mesh.shape[1]
    return _state.mesh.coords[1] * per, per


def layout(x: torch.Tensor, cf: bool = False) -> tuple[int, bool]:
    """(whole depth, split) of a channels-last (B, d, *plane, C) tensor of
    the sharded model, or with `cf` of a channels-first (B, C, d, *plane)
    one, read from its plane ((H, W) of a volume, (W,) of a 2D slice);
    checks its planes."""
    z = 2 if cf else 1
    nd = len(next(iter(_state.grids))) + 1  # the model's spatial axes
    plane = tuple(x.shape[z + 1:z + nd])
    depth = _state.grids.get(plane) if x.dim() == nd + 2 else None
    if depth is None:
        axes = ", ".join(["d", "H", "W"][3 - nd:])
        what = f"(B, C, {axes})" if cf else f"(B, {axes}, C)"
        raise ValueError(f"no level of the sharded model has a {what} tensor of shape "
                         f"{tuple(x.shape)}")
    sp = split(depth)
    if x.shape[z] != (depth // _state.mesh.shape[1] if sp else depth):
        raise ValueError(f"a tensor of level depth {depth} ({'split' if sp else 'replicated'}) "
                         f"has {x.shape[z]} planes")
    return depth, sp


def whole_spatial(x: torch.Tensor) -> tuple[int, ...]:
    """The whole volume's spatial size of a channels-last tensor."""
    return (layout(x)[0], *x.shape[2:-1])


def slab_of(x: torch.Tensor) -> tuple[int, int]:
    """(first plane, planes) of the whole depth that `x` holds."""
    depth, sp = layout(x)
    return part(depth) if sp else (0, depth)


def share(x: torch.Tensor) -> float:
    """The weight of this rank's partial loss term on `x`: 1 for a split
    level's slab, 1 / space for a replicated level (every rank of the
    column computes the whole term); 1 outside `sharded`."""
    if not active() or layout(x)[1]:
        return 1.0
    return 1.0 / _state.mesh.shape[1]


def partial_mean(v: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of a volume (equal slabs, or the
    whole on every rank): summed over the space column, the mean."""
    return v.mean() / _state.mesh.shape[1]


def statistic_weight() -> float:
    """w of a term built on statistics summed by `sum_partials` (module
    doc): 1 / space, on a split and on a replicated level alike."""
    return 1.0 / _state.mesh.shape[1]


def global_rows(x: torch.Tensor) -> int:
    """The global batch of which `x` holds this rank's rows."""
    return x.shape[0] * _state.mesh.shape[0]


def sum_partials(t: torch.Tensor, x: torch.Tensor, over: str = "space") -> torch.Tensor:
    """Partial statistics `t` of a term on `x` summed over `over`: "space"
    (the column: a statistic of each data row's own batch) or "world" (a
    statistic of the whole global batch). Differentiable (`_SumOver`).
    On a replicated level `t` already holds the whole volume's
    statistics: summed over the data row for "world", left as it is for
    "space" (a sum over the column would count them space times)."""
    split = layout(x)[1]
    mesh = _state.mesh
    group = {("space", True): mesh.space, ("world", True): mesh.world,
             ("space", False): None, ("world", False): mesh.data}[(over, split)]
    if group is None or group.size == 1:
        return t
    return _SumOver.apply(t, group, "stats")


# ----------------------------------------------------------------------
# collectives (gloo and NCCL)
# ----------------------------------------------------------------------

def _gather_list(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's `t` (all the same shape), in rank order."""
    if mesh.size == 1:
        return [t]
    t = t.detach().contiguous()
    if dist.get_backend(mesh.group) == "nccl":
        out = t.new_empty((mesh.size, *t.shape))
        dist.all_gather_into_tensor(out, t, group=mesh.group)
        return list(out.unbind(0))
    host = t.cpu()  # gloo's all-gather takes CPU tensors
    outs = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(outs, host, group=mesh.group)
    return [o.to(t.device) for o in outs]


def _sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `t` over the ranks (gloo and NCCL take device tensors)."""
    if mesh.size == 1:
        return t
    buf = t.detach().contiguous().clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf


def _all_to_all(send: torch.Tensor, sizes_out: list[int], sizes_in: list[int],
                mesh: Mesh) -> torch.Tensor:
    """One all-to-all of flat `send` (sizes_in[r] elements to rank r, in
    rank order) over `mesh`: what the ranks sent this one, sizes_out[r]
    elements from rank r, in rank order."""
    if dist.get_backend(mesh.group) == "nccl":
        recv = send.new_empty(sum(sizes_out))
        dist.all_to_all_single(recv, send, sizes_out, sizes_in, group=mesh.group)
        return recv
    host = send.cpu()  # gloo's all-to-all takes CPU tensors
    recv = host.new_empty(sum(sizes_out))
    dist.all_to_all_single(recv, host, sizes_out, sizes_in, group=mesh.group)
    return recv.to(send.device)


def _gather_field(x: torch.Tensor, g: torch.Tensor, mesh: Mesh):
    """(the whole field from the column's slabs `x`, as `_gather_depth`;
    the largest `warp.abs_max_bits` of the column's slabs `g`) in one
    all-gather: each slab carries its g's bits as one more float32."""
    _count("gather", x, mesh.size)
    bits = warp_kernel.abs_max_bits(g).to(torch.int32).view(torch.float32)
    parts = _gather_list(torch.cat([x.reshape(-1), bits]), mesh)
    whole = torch.cat([p[:-1].view(x.shape) for p in parts], dim=1)
    top = torch.stack([p[-1] for p in parts]).view(torch.int32).amax()
    return whole, top.to(torch.int64).reshape(1)


def _column(whole: torch.Tensor, g: torch.Tensor, top: torch.Tensor, mesh: Mesh):
    """The `column` (top, exchange) of this rank's squaring backward slab
    launch on `whole` for its slab g (`squaring.squaring_step_bwd`). The
    exchange sends each other rank the int64 sums of the other's planes
    that this rank's terms reach, and adds what it receives into its own
    planes: one all-to-all, counted as "reduce" traffic by the bytes this
    rank sends. Every rank takes every rank's reach from the whole field
    (`squaring.reaches`), so the ranks agree on the sizes unasked."""
    depth = g.shape[1]
    reach = squaring.reaches(whole, depth)

    def planes(src: int, dst: int) -> tuple[int, int]:
        """The planes of dst's slab that src's terms reach (none for src = dst)."""
        lo, hi = max(reach[src][0], dst * depth), min(reach[src][1], (dst + 1) * depth)
        return (lo, hi) if src != dst and lo < hi else (0, 0)

    def exchange(acc: torch.Tensor) -> None:
        rows, plane, me = acc.shape[0], acc[0, 0].numel(), mesh.rank
        sends = [planes(me, r) for r in range(mesh.size)]
        recvs = [planes(r, me) for r in range(mesh.size)]
        send = torch.cat([acc[:, lo:hi].reshape(-1) for lo, hi in sends])
        _count("reduce", send)
        if mesh.size == 1:
            return
        size = lambda p: rows * (p[1] - p[0]) * plane
        recv = _all_to_all(send, [size(p) for p in recvs], [size(p) for p in sends], mesh)
        for part, (lo, hi) in zip(recv.split([size(p) for p in recvs]), recvs):
            if hi > lo:
                acc[:, lo:hi] += part.view(rows, hi - lo, *acc.shape[2:])

    return top, exchange


def _gather_depth(x: torch.Tensor, mesh: Mesh, kind: str = "gather", dim: int = 1) -> torch.Tensor:
    """The whole volume from the slabs of `mesh`'s ranks, joined along
    the depth axis `dim` (1 channels-last, 2 channels-first; no
    autograd)."""
    _count(kind, x, mesh.size)
    return torch.cat(_gather_list(x, mesh), dim=dim)


class _SumOver(torch.autograd.Function):
    """The sum of `t` over the ranks of `mesh` (all-reduce); backward: the
    cotangent summed over the same ranks (each rank's partial feeds the
    sum that every rank's term reads)."""

    @staticmethod
    def forward(ctx, t, mesh, kind):
        ctx.mesh, ctx.kind = mesh, kind
        _count(kind, t)
        return _sum(t, mesh)

    @staticmethod
    def backward(ctx, g):
        _count(ctx.kind, g)
        return _sum(g, ctx.mesh), None, None


class _GatherDepth(torch.autograd.Function):
    """Slabs -> the whole volume along the depth axis `dim`; backward: the
    cotangent summed over the column, this rank's slab of it."""

    @staticmethod
    def forward(ctx, x, kind, dim=1):
        ctx.mesh, ctx.dim = _space(), dim
        ctx.z0, ctx.planes = ctx.mesh.rank * x.shape[dim], x.shape[dim]
        return _gather_depth(x, ctx.mesh, kind, dim)

    @staticmethod
    def backward(ctx, g):
        _count("reduce", g)
        return _sum(g, ctx.mesh).narrow(ctx.dim, ctx.z0, ctx.planes), None, None


def gather(x: torch.Tensor, kind: str = "gather") -> torch.Tensor:
    """The whole volume of `x` (itself where its level is replicated),
    counted under `traffic[kind]`. An `x` that needs no gradient builds
    no autograd node, so its backward adds no all-reduce."""
    return _GatherDepth.apply(x, kind) if layout(x)[1] else x


def take(x: torch.Tensor, depth: int) -> torch.Tensor:
    """This rank's slab of a whole tensor of a level of `depth` (itself
    where the level is replicated); differentiable."""
    if not split(depth):
        return x
    z0, planes = part(depth)
    return x[:, z0:z0 + planes]


class _Halo(torch.autograd.Function):
    """A slab with up to h planes of its neighbours' on each side (none
    past the volume's ends). A slab of fewer than h planes takes planes of
    ranks further away. Backward: the halo planes' cotangents are added
    into the planes they came from."""

    @staticmethod
    def forward(ctx, x, h):
        mesh = ctx.mesh = _space()
        n, s, zs = mesh.size, mesh.rank, x.shape[1]
        e = min(h, zs)
        mine = torch.cat([x[:, :e], x[:, zs - e:]], 1)
        _count("halo", mine, n)
        edges = _gather_list(mine, mesh)
        lo, hi = min(h, s * zs), min(h, (n - 1 - s) * zs)
        z0 = s * zs
        # a plane p below the slab is in rank p // zs's tail, above in a head
        below = [edges[p // zs][:, e + p % zs - (zs - e)] for p in range(z0 - lo, z0)]
        above = [edges[p // zs][:, p % zs] for p in range(z0 + zs, z0 + zs + hi)]
        ctx.h, ctx.lo, ctx.hi, ctx.zs = h, lo, hi, zs
        parts = ([torch.stack(below, 1)] if below else []) + [x] + (
            [torch.stack(above, 1)] if above else [])
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n, s = mesh.size, mesh.rank
        h, lo, hi, zs = ctx.h, ctx.lo, ctx.hi, ctx.zs
        out = g[:, lo:lo + zs].clone()
        # each rank's halo cotangents, its lower planes right-aligned to h
        pad = g.new_zeros((g.shape[0], h, *g.shape[2:]))
        mine = torch.cat([pad[:, :h - lo], g[:, :lo], g[:, lo + zs:], pad[:, :h - hi]], 1)
        _count("halo", mine, n)
        z0 = s * zs
        for r, t in enumerate(_gather_list(mine, mesh)):
            r0 = r * zs
            lo_r, hi_r = min(h, r0), min(h, (n - 1 - r) * zs)
            for i, p in enumerate(range(r0 - lo_r, r0)):
                if z0 <= p < z0 + zs:
                    out[:, p - z0] += t[:, h - lo_r + i]
            for i, p in enumerate(range(r0 + zs, r0 + zs + hi_r)):
                if z0 <= p < z0 + zs:
                    out[:, p - z0] += t[:, h + i]
        return out, None


def halo(x: torch.Tensor, h: int) -> tuple[torch.Tensor, int, int]:
    """(x with up to h neighbouring planes on each side, planes below,
    planes above) for a split level's slab; (x, 0, 0) otherwise."""
    if h == 0 or not layout(x)[1] or _space().size == 1:
        return x, 0, 0
    xh = _Halo.apply(x, h)
    n, s, zs = _space().size, _space().rank, x.shape[1]
    return xh, min(h, s * zs), min(h, (n - 1 - s) * zs)


def on_halo(fn, x: torch.Tensor, *others: torch.Tensor, depth: int):
    """fn(x, *others) on this rank's slab: each argument with a halo of
    `depth` planes (the depth of the chain of k = 3 convs in fn), the
    result (a tensor or a tuple) cropped to the slab; unsharded ops
    inside. On a replicated level, fn on the whole tensors."""
    if not layout(x)[1]:
        with suspended():
            return fn(x, *others)
    xh, lo, _ = halo(x, depth)
    oh = [halo(o, depth)[0] for o in others]
    with suspended():
        out = fn(xh, *oh)
    crop = lambda t: t[:, lo:lo + x.shape[1]]
    return tuple(crop(t) for t in out) if isinstance(out, tuple) else crop(out)


# ----------------------------------------------------------------------
# the sharded ops
# ----------------------------------------------------------------------

def conv(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """`models/blocks.conv_cl` on this rank's slab: a k = 3, pad = 1 conv
    on a 1-plane halo (a replicated level's on the whole volume)."""
    from pulpo_tpu_torch.models.blocks import conv_cl

    if not layout(x)[1]:
        with suspended():
            return conv_cl(x, w, pad)
    if (w.shape[2], pad) != (3, 1):
        raise NotImplementedError(f"a k = {w.shape[2]}, pad = {pad} conv: {QUEUE}")
    return on_halo(lambda t: conv_cl(t, w, 1), x, depth=1)


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """`ops/resize.avg_pool_ceil` over the spatial axes: local between two
    split levels, else on the whole volume."""
    from pulpo_tpu_torch.ops.resize import avg_pool_ceil

    depth, sp = layout(x)
    out = -(-depth // 2)
    if sp and split(out):
        with suspended():
            return avg_pool_ceil(x)
    whole = gather(x)
    with suspended():
        y = avg_pool_ceil(whole)
    return take(y, out)


_blocks: dict = {}


def _rows(x: torch.Tensor, m: np.ndarray, key: tuple) -> torch.Tensor:
    """Contract x's axis 1 with the (out, in) matrix block m, in x's dtype."""
    k = (key, x.device, x.dtype)
    if k not in _blocks:
        with torch.inference_mode(False):
            _blocks[k] = torch.as_tensor(np.ascontiguousarray(m.T)).to(x.device, x.dtype)
    return torch.matmul(x.movedim(1, -1), _blocks[k]).movedim(-1, 1)


def resize(x: torch.Tensor, out_size, scales=None) -> torch.Tensor:
    """`ops/resize.resize_linear` over the spatial axes (depth first, as
    there): the depth matmul of a slab on the band of input planes its
    output rows read, with that row block of the matrix."""
    from pulpo_tpu_torch.ops.resize import _linear_matrix, resize_linear

    depth, sp = layout(x)
    out = int(out_size[0])
    scale = None if scales is None else scales[0]
    if depth != out or scale not in (None, 1.0):
        m = _linear_matrix(depth, out, scale)
        key = (depth, out, scale)
        if not split(out) and sp:
            # a replicated output from slabs: each rank's partial product
            # with its columns of the matrix, summed over the column (the
            # output's bytes exchanged, not the input's)
            z0, planes = part(depth)
            x = _SumOver.apply(_rows(x, m[:, z0:z0 + planes], key + ("cols", z0)), _space(),
                               "reduce")
        elif not split(out):
            x = _rows(x, m, key)
        elif not sp:
            o0, n_out = part(out)
            x = _rows(x, m[o0:o0 + n_out], key + (o0,))
        else:
            space = _state.mesh.shape[1]
            per_in, per_out = depth // space, out // space
            bands = []
            for r in range(space):
                cols = np.nonzero(m[r * per_out:(r + 1) * per_out].any(0))[0]
                bands.append((int(cols[0]), int(cols[-1]) + 1))
            h = max(max(r * per_in - b0, b1 - (r + 1) * per_in, 0)
                    for r, (b0, b1) in enumerate(bands))
            o0, _ = part(out)
            b0, b1 = bands[o0 // per_out]
            xh, lo, _ = halo(x, h)
            start = o0 // per_out * per_in - lo  # xh's first plane
            x = _rows(xh[:, b0 - start:b1 - start], m[o0:o0 + per_out, b0:b1],
                      key + (o0, b0, b1))
    with suspended():
        return resize_linear(x, tuple(out_size[1:]), spatial_axes=tuple(range(2, x.dim() - 1)),
                             scales=None if scales is None else tuple(scales[1:]))


def warp_image(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """`ops/warp.warp_image` on this rank's slab of df: the moving volume
    all-gathered, the slab launch of the warp (#4; its backward #6 takes
    the same slab). A moving map of more than one channel (the one-hot
    segmentation) is counted as `gather_seg`."""
    moving = gather(moving, "gather" if moving.shape[-1] == 1 else "gather_seg")
    depth, sp = layout(df)
    if not sp:
        return warp_kernel.warp(moving, df)
    z0, _ = part(depth)
    return warp_kernel.warp(moving, df, z0, depth)


class _IntegrateSlab(torch.autograd.Function):
    """Scaling and squaring of a split field: each step all-gathers the
    field and launches the step's slab (#1). Keeps the steps' input slabs;
    its backward gathers each again, with the column's max |g|
    (`_gather_field`), and launches the step backward's slab (#2), whose
    data term is summed over the column in fixed point (`_column`): the
    slab of the whole cotangent, bit-equal to the unsharded step
    backward's planes."""

    @staticmethod
    def forward(ctx, vec, nsteps, z0):
        scale = 1.0 / (2**nsteps)
        planes, mesh = vec.shape[1], _space()
        cur, inputs = vec, []
        for k in range(nsteps):
            inputs.append(cur)
            cur = squaring.squaring_step(_gather_depth(cur.contiguous(), mesh),
                                         scale=scale if k == 0 else 1.0, z0=z0, depth=planes)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(*inputs)
        ctx.nsteps, ctx.z0, ctx.mesh = nsteps, z0, mesh
        return cur

    @staticmethod
    def backward(ctx, g):
        scale = 1.0 / (2**ctx.nsteps)
        inputs = ctx.saved_tensors
        g = g.float().contiguous()
        for k in reversed(range(ctx.nsteps)):
            whole, top = _gather_field(inputs[k].contiguous(), g, ctx.mesh)
            if k == 0:
                whole = whole * scale
            column = _column(whole, g, top, ctx.mesh)
            g = squaring.squaring_step_bwd(whole, g, ctx.z0, column).contiguous()
        return g * scale, None, None


def integrate_svf(vec: torch.Tensor, nsteps: int) -> torch.Tensor:
    """`ops/warp.integrate_svf` on this rank's slab of a split field; a
    replicated field integrates whole. A 2D field (B, h, W, 2) runs the
    slab launches of the 2D step (#1's 2D arm) as `integrate_svf_cf`
    runs the CF step's: its gradient is the plain version's, as the
    whole 2D integration's is."""
    depth, sp = layout(vec)
    if not sp or nsteps == 0:
        return squaring.integrate_svf(vec, nsteps)
    if vec.shape[-1] == 2:
        return _integrate_gathered(vec, nsteps, part(depth)[0], 1, squaring.squaring_step,
                                   squaring.squaring_step_plain)
    return _IntegrateSlab.apply(vec, nsteps, part(depth)[0])


def integrate_svf_cf(vec_cf: torch.Tensor, nsteps: int) -> torch.Tensor:
    """`ops/warp.integrate_svf_cf` on this rank's slab of a split
    channels-first field (B, 3, d, H, W): each step all-gathers the field
    along its depth (axis 2) and launches the CF step's slab (#3); a
    replicated field integrates whole. An eval path: as the whole CF
    integration, a gradient through the kernels is the plain version's
    (`plain_vjp`), the same steps on differentiable gathers."""
    depth, sp = layout(vec_cf, cf=True)
    if not sp or nsteps == 0:
        return squaring.integrate_svf_cf(vec_cf, nsteps)
    return _integrate_gathered(vec_cf, nsteps, part(depth)[0], 2, squaring.squaring_step_cf,
                               squaring.squaring_step_cf_plain)


def _integrate_gathered(vec: torch.Tensor, nsteps: int, z0: int, dim: int, step,
                        step_plain) -> torch.Tensor:
    """Scaling and squaring of this rank's slab (from z0, along axis
    `dim`) of a split field: each step all-gathers the field and launches
    `step`'s slab; differentiated as `step_plain`'s slabs on
    differentiable gathers (`plain_vjp`), which run alone on the CPU."""
    planes = vec.shape[dim]
    scale = 1.0 / (2**nsteps)

    def plain(v):
        for k in range(nsteps):
            whole = _GatherDepth.apply(v, "gather", dim)
            v = step_plain(whole * scale if k == 0 else whole, z0, planes)
        return v

    if vec.device.type == "cpu":
        return plain(vec)

    def kernel(v):
        mesh = _space()
        for k in range(nsteps):
            v = step(_gather_depth(v.contiguous(), mesh, dim=dim),
                     scale=scale if k == 0 else 1.0, z0=z0, depth=planes)
        return v

    return plain_vjp.apply(kernel, plain, vec)


def batched_level_warp_cf(moving: torch.Tensor, stacked_cf: torch.Tensor) -> torch.Tensor:
    """The batched channels-first image warp of `ops/warp.
    batched_level_warp_cf` on this rank's rows and slab: the moving image
    (channels-last, C = 1) all-gathered, and the stacked CF dfs (L * B,
    3, d, H, W) of the rank's slab in one slab launch of the CF warp (#8);
    returns the CF output's slab (L * B, C, d, H, W)."""
    moving_cf = gather(moving.float()).permute(0, 4, 1, 2, 3)
    depth, sp = layout(stacked_cf, cf=True)
    if not sp:
        return warp_kernel.warp_cf(moving_cf, stacked_cf)
    return warp_kernel.warp_cf(moving_cf, stacked_cf, part(depth)[0], depth)


def whole_draw_shape(shape, samples: int) -> tuple[int, ...]:
    """The per-sample shape of the whole draw (global batch, whole depth)
    of which a level's draws of local `shape` (S * B, d, *plane, z) are
    a block."""
    b = shape[0] // samples * _state.mesh.shape[0]
    depth = _state.grids[tuple(shape[2:-1])]
    return (b, depth, *shape[2:])


def block(whole: torch.Tensor, samples: int) -> torch.Tensor:
    """This rank's block (batch rows, depth slab) of sample-major draws
    (S * B_global, D, H, W, z) of the whole volume."""
    data = _state.mesh.shape[0]
    d = _state.mesh.coords[0]
    b_all = whole.shape[0] // samples
    b = b_all // data
    t = whole.reshape(samples, b_all, *whole.shape[1:])[:, d * b:(d + 1) * b]
    if split(whole.shape[1]):
        z0, planes = part(whole.shape[1])
        t = t[:, :, z0:z0 + planes]
    return t.reshape(samples * b, *t.shape[2:])


# ----------------------------------------------------------------------
# the entry points
# ----------------------------------------------------------------------

def make_spatial_forward(model, mesh: Mesh2D, deterministic: bool = True):
    """``fwd(x, y, seed=0) -> (df, warped)``: the eval forward on this
    rank's block of the global batch (`shard_volume`; float32
    (B, d, H, W, 1)), returning its slab of the level-0 final df and
    warped image (the JAX function's outs[6][0], outs[7][0]). The
    weights are the model's, the same on every rank."""

    def fwd(x, y, seed: int = 0):
        with sharded(mesh, model.cfg):
            outs = model.apply_eval(x, y, deterministic=deterministic, seed=seed)
        return outs[6][0], outs[7][0]

    return fwd


def spatial_compute_grads(model, batch: dict, mesh: Mesh2D, seed: int = 0, noise=None):
    """One train forward and backward on this rank's block of the global
    batch, BatchNorm moments over the whole mesh; the gradients summed
    over the space column and averaged over the data row (one flat bucket
    each), the metrics likewise: the global step's gradients and metrics
    on every rank. `noise` holds the global batch's whole draws."""
    from pulpo_tpu_torch.models.blocks import BatchNorm
    from pulpo_tpu_torch.train.step import _flat_metrics, compute_grads

    with sharded(mesh, model.cfg), BatchNorm.synced(mesh.world):
        grads, new_stats, metrics = compute_grads(model, batch, seed, noise)
    names = list(grads)
    flat = bucket_mean(bucket_sum([grads[n] for n in names], mesh.space), mesh.data)
    grads = dict(zip(names, flat))
    items = _flat_metrics(metrics)
    values = bucket_mean(bucket_sum([v.float() for _, v in items], mesh.space), mesh.data)
    out: dict = {}
    for (path, _), v in zip(items, values):
        if len(path) == 1:
            out[path[0]] = v
        else:
            out.setdefault(path[0], {})[path[1]] = v
    return grads, new_stats, out


def make_spatial_train_step(model, tx, mesh: Mesh2D):
    """The training step on the (data, space) mesh: ``step(state, batch,
    noise=None) -> (state, metrics)`` with `batch` this rank's block of
    the global batch (`shard_volume`) and `noise` the global batch's
    whole draws; the update, the NaN guard and the metrics are the
    global ones, the same on every rank."""
    from pulpo_tpu_torch.train.step import make_step

    return make_step(model, tx, lambda batch, seed, noise: spatial_compute_grads(
        model, batch, mesh, seed, noise))
