"""Data parallelism over `torch.distributed`: the mesh (a process group
and its world size, `mesh.py`), multi-process start-up and shards
(`multihost.py`), and the data-parallel training step (`dp.py`).
`spatial.py` and `tp.py` of the JAX package are not ported yet (ROADMAP
Queue 1)."""

from pulpo_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch_spec

__all__ = ["Mesh", "make_mesh", "shard_batch_spec"]
