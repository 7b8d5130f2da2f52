"""Parallelism over `torch.distributed`: the meshes (a process group and
its world size, and the 2D (data, space) mesh, `mesh.py`), multi-process
start-up and shards (`multihost.py`), the data-parallel training step
(`dp.py`), depth sharding of volumes with its hand-written exchanges
(`spatial.py`: the sharded forward and training step) and the
output-channel split of the eval forward (`tp.py`)."""

from pulpo_tpu_torch.parallel.mesh import Mesh, Mesh2D, make_2d_mesh, make_mesh, shard_batch_spec

__all__ = ["Mesh", "Mesh2D", "make_2d_mesh", "make_mesh", "shard_batch_spec"]
