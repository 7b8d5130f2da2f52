"""Multi-process start-up and per-process data, on `torch.distributed`.

Port of pulpo_tpu/parallel/multihost.py. The JAX package runs one SPMD
program over every process's devices; here each process is one rank
with one device, and a training step averages its gradients over the
ranks by hand (parallel/dp.py). What the JAX module offers maps so:

  initialize()            -- torch.distributed.init_process_group from
                             the arguments or torchrun's environment
                             (no-op without either)
  make_global_mesh(n)     -- the data mesh over the whole world
  process_shard(n)        -- the rows of a global batch a rank owns
  shard_dataset_indices   -- a rank's rows of each global batch of an
                             epoch's permutation (bit-equal to the JAX
                             function for the same rank and world size)
  local_to_global(batch)  -- a rank's rows as tensors on its device,
                             checked against the global batch

Launch: `torchrun --nproc_per_node N -m pulpo_tpu_torch.train_cli
--data_parallel N ...`, or call `initialize` with an address, the number
of processes and this one's index.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from pulpo_tpu_torch.parallel.mesh import Mesh, make_mesh, process_shard as _shard, world


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               device="cuda") -> bool:
    """Start the default process group. The rendezvous is
    `coordinator_address` ("host:port", or a URL such as
    "tcp://localhost:29500" or "file:///path"), else torchrun's
    MASTER_ADDR / MASTER_PORT; the world size and rank come from the
    arguments, else WORLD_SIZE / RANK. Returns False, and starts nothing,
    when neither an address nor MASTER_ADDR is given; True when a group
    is running (already, or now).

    The backend is `nccl` for a `cuda` device and `gloo` on the CPU,
    unless `backend` names one (gloo also takes CUDA tensors, as two
    ranks sharing one card need). A failed start raises; nothing falls
    back to another backend. On `cuda` the rank uses card LOCAL_RANK
    (modulo the cards present)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            return False
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world_size = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None else env.get("RANK", "0"))
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for gloo on the CPU")
        card = int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", card)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return True


def shutdown() -> None:
    """Tear the default process group down, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_global_mesh(data: int | None = None) -> Mesh:
    """The data mesh over the whole world (`make_mesh` of the default
    group)."""
    return make_mesh(data)


def _rank_world(rank, world_size):
    size, r = world()
    return (r if rank is None else int(rank)), (size if world_size is None else int(world_size))


def process_shard(global_batch: int, rank: int | None = None,
                  world_size: int | None = None) -> slice:
    """The contiguous rows of the global batch that `rank` (this process
    by default) feeds; the batch must split evenly over the world."""
    rank, world_size = _rank_world(rank, world_size)
    return _shard(global_batch, rank, world_size)


def shard_dataset_indices(n_items: int, seed: int, epoch: int, global_batch: int,
                          rank: int | None = None, world_size: int | None = None) -> np.ndarray:
    """The epoch's permutation (from (seed, epoch), the same on every
    rank) cut into global batches, the n_items % global_batch tail
    dropped, and this rank's rows of each: (batches, global_batch /
    world) indices, disjoint across ranks."""
    rng = np.random.default_rng((seed, epoch))
    perm = rng.permutation(n_items)
    n_batches = n_items // global_batch
    perm = perm[: n_batches * global_batch].reshape(n_batches, global_batch)
    return perm[:, process_shard(global_batch, rank, world_size)]


def local_to_global(local_batch: dict, mesh: Mesh, device=None,
                    global_batch: int | None = None) -> dict[str, torch.Tensor]:
    """A rank's rows of a global batch as tensors on its device (`device`,
    else `cuda`). The JAX function assembles one global array; here each
    rank keeps its rows, and the global batch is their count times the
    world size: every leaf must hold the same number of rows, and that
    times the world size must equal `global_batch` when it is given."""
    rows = {k: int(np.shape(v)[0]) for k, v in local_batch.items() if v is not None}
    if len(set(rows.values())) > 1:
        raise ValueError(f"the leaves hold different numbers of rows: {rows}")
    local = next(iter(rows.values()), 0)
    if global_batch is not None and local * mesh.size != global_batch:
        raise ValueError(f"{local} rows a rank x {mesh.size} ranks != global batch "
                         f"{global_batch}")
    dev = torch.device("cuda" if device is None else device)
    return {k: torch.as_tensor(v).to(dev) for k, v in local_batch.items() if v is not None}
