"""Parallelism over `torch.distributed`: the meshes (a process group and
its world size, and the 2D (data, space) mesh, `mesh.py`), multi-process
start-up and shards (`multihost.py`), the data-parallel training step
(`dp.py`), depth sharding of volumes with its hand-written exchanges
(`spatial.py`: the sharded forward and training step) and the
output-channel split of the eval forward (`tp.py`).

`make_dp_train_step` and `replicate_state` are re-exported from `dp.py`
as the JAX package's `pulpo_tpu.parallel` does, but imported on first
use (a module `__getattr__`): `dp.py` imports the model and the training
step, and `models/blocks.py` imports this package, so an import at the
top would be a cycle. Importing this package builds nothing."""

from pulpo_tpu_torch.parallel.mesh import Mesh, Mesh2D, make_2d_mesh, make_mesh, shard_batch_spec

__all__ = ["Mesh", "Mesh2D", "make_2d_mesh", "make_mesh", "shard_batch_spec",
           "make_dp_train_step", "replicate_state"]

_FROM_DP = ("make_dp_train_step", "replicate_state")


def __getattr__(name: str):
    if name in _FROM_DP:
        from pulpo_tpu_torch.parallel import dp

        return getattr(dp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
