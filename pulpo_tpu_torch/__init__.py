"""PULPo in PyTorch with hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package `pulpo_tpu` (the reference, which stays in
the repository). It imports torch, numpy and the standard library, and
nothing of JAX. Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""

from pulpo_tpu_torch.config import PULPoConfig

__all__ = ["PULPoConfig"]
