"""The meshes: a process group and its world size, and the 2D (data,
space) mesh of the depth-sharded model.

Port of pulpo_tpu/parallel/mesh.py. The JAX package lays a 1D `data`
mesh over devices and lets XLA insert the collectives; here a rank is a
process with one device, the mesh is its process group, and the
collectives are called by hand: `mean_over` (differentiable: its
backward averages the cotangents over the ranks too, as the transpose
of JAX's `pmean` does) and `bucket_mean` / `bucket_sum` (one flat
float32 all-reduce for many tensors). Without an initialised process
group the world is one rank and every collective is the identity.

What the sharded models (spatial.py, tp.py) share: `Traffic`, the count
of each exchange a rank makes, and `recomputing`, the one flag of a
checkpointed region's recomputation in the backward
(models/pulpo.py:remat), under which train BatchNorms record no running
update and every exchange is counted apart.

`make_2d_mesh(data, space)` (pulpo_tpu/parallel/spatial.py:23) puts
rank r at (r // space, r % space) and holds a 1D mesh for each axis: its
`space` column (the ranks that split one volume's depth: same data
index) and its `data` row (the ranks of one depth slab: same space
index), and the `world` (both axes), so that `mean_over` and the bucket
collectives run over either axis or both.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`size` ranks of `group` (None: the default group); this process
    is rank `rank`."""
    size: int
    rank: int
    group: object = None

    @property
    def active(self) -> bool:
        """Whether collectives run (a process group is initialised)."""
        return dist.is_available() and dist.is_initialized()

    def device(self, like: torch.Tensor) -> torch.device:
        """Where a collective takes its tensors: the rank's card under
        NCCL, the tensor's own device under gloo."""
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return like.device


_recomputing = False  # process-wide: autograd may recompute on its own thread


@contextlib.contextmanager
def recomputing():
    """A checkpointed region's recomputation in the backward: train
    BatchNorms inside record no running-statistics update (the forward
    recorded it, from the same batch), and each exchange counts apart in
    its `Traffic`."""
    global _recomputing
    before, _recomputing = _recomputing, True
    try:
        yield
    finally:
        _recomputing = before


def in_recomputation() -> bool:
    return _recomputing


class Traffic(dict):
    """{kind: [calls, bytes]} of each exchange on this rank since `clear`;
    one made while `recomputing` counts under "<kind>_recomputed"."""

    def count(self, kind: str, nbytes: int) -> None:
        if _recomputing:
            kind = f"{kind}_recomputed"
        calls, total = self.get(kind, [0, 0])
        self[kind] = [calls + 1, total + nbytes]


def world(group=None) -> tuple[int, int]:
    """(world size, rank) of `group`; (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def make_mesh(n_data: int | None = None, group=None) -> Mesh:
    """The data mesh over every rank of `group`. `n_data` must equal its
    world size: a rank outside the mesh would hold no rows of a batch."""
    size, rank = world(group)
    if n_data is None:
        n_data = size
    if n_data != size:
        raise ValueError(
            f"data={n_data} replicas need a world of {n_data} processes, one a replica; this "
            f"one has {size} (launch with `torchrun --nproc_per_node {n_data}`)")
    return Mesh(size=size, rank=rank, group=group)


def process_shard(global_batch: int, rank: int, world_size: int) -> slice:
    """The contiguous rows of the global batch that `rank` owns (an equal
    share each: `global_batch` divisible by the world size)."""
    if global_batch % world_size:
        raise ValueError(
            f"global batch {global_batch} not divisible by {world_size} processes")
    per = global_batch // world_size
    return slice(rank * per, (rank + 1) * per)


def shard_batch_spec(mesh: Mesh, global_batch: int) -> slice:
    """The rows of a global batch of `global_batch` that this rank owns."""
    return process_shard(global_batch, mesh.rank, mesh.size)


def fold_in(seed: int, rank: int) -> int:
    """A seed for `rank`'s draws, decorrelated from every other rank's
    (the role of `jax.random.fold_in(key, axis_index)`): a splitmix64
    step of the seed and the rank, below 2**62."""
    mask = (1 << 64) - 1
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(rank) + 1) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 2


class _MeanOver(torch.autograd.Function):
    """The mean over the ranks, with the mean of the cotangents over the
    ranks as its backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_mean(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_mean(g, ctx.mesh), None


def _all_reduce_mean(x: torch.Tensor, mesh: Mesh, mean: bool = True) -> torch.Tensor:
    dev = mesh.device(x)
    buf = x.detach().to(dev, copy=True).contiguous()
    dist.all_reduce(buf, group=mesh.group)
    return ((buf / mesh.size) if mean else buf).to(x.device)


def mean_over(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of `x` over the ranks of `mesh` (differentiable); `x`
    itself without a mesh or a process group."""
    if mesh is None or not mesh.active:
        return x
    return _MeanOver.apply(x, mesh)


def bucket_mean(tensors: list[torch.Tensor], mesh: Mesh | None,
                mean: bool = True) -> list[torch.Tensor]:
    """Each tensor's mean (or, `mean` False, sum) over the ranks, by one
    all-reduce of a flat float32 bucket; each comes back in its own
    shape, dtype and device."""
    if mesh is None or not mesh.active or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float().to(tensors[0].device) for t in tensors])
    flat = _all_reduce_mean(flat, mesh, mean)
    out, start = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[start:start + n].view(t.shape).to(device=t.device, dtype=t.dtype))
        start += n
    return out


def bucket_sum(tensors: list[torch.Tensor], mesh: Mesh | None) -> list[torch.Tensor]:
    """Each tensor's sum over the ranks (`bucket_mean`'s one all-reduce)."""
    return bucket_mean(tensors, mesh, mean=False)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The (data, space) mesh: rank `rank` of the world sits at `coords`
    = (rank // space, rank % space). `space` is its column (the ranks
    that split one volume's depth), `data` its row (the ranks that hold
    the same depth slab of other batch rows), `world` both."""
    shape: tuple[int, int]
    rank: int
    world: Mesh
    data: Mesh
    space: Mesh

    @property
    def coords(self) -> tuple[int, int]:
        return divmod(self.rank, self.shape[1])


def make_2d_mesh(data: int, space: int) -> Mesh2D:
    """The (data, space) mesh over the whole world, which must hold
    data * space ranks; every rank creates every row and column group,
    in the same order."""
    size, rank = world()
    if data * space != size:
        raise ValueError(f"a ({data}, {space}) mesh needs a world of {data * space} processes; "
                         f"this one has {size} (launch with `torchrun --nproc_per_node "
                         f"{data * space}`)")
    whole = Mesh(size=size, rank=rank)
    if size == 1:
        one = Mesh(size=1, rank=0)
        return Mesh2D((data, space), rank, whole, one, one)
    d, s = divmod(rank, space)
    columns = [dist.new_group([i * space + j for j in range(space)]) for i in range(data)]
    rows = [dist.new_group([i * space + j for i in range(data)]) for j in range(space)]
    return Mesh2D((data, space), rank, whole, Mesh(size=data, rank=d, group=rows[s]),
                  Mesh(size=space, rank=s, group=columns[d]))


def broadcast_(tensors: list[torch.Tensor], mesh: Mesh | None, src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place: one broadcast
    per dtype, of a flat bucket."""
    if mesh is None or not mesh.active or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            dev = mesh.device(group[0])
            flat = torch.cat([t.reshape(-1).to(dev) for t in group])
            dist.broadcast(flat, src=src, group=mesh.group)
            start = 0
            for t in group:
                n = t.numel()
                t.copy_(flat[start:start + n].view(t.shape))
                start += n
