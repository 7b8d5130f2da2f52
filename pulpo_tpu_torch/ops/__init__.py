"""Warping, SVF integration, resampling and the losses.

The JAX package's `pulpo_tpu.ops` re-exports, from `resize.py`,
`warp.py` and `losses.py`. Importing this package builds no kernel (a
kernel is built at its first launch)."""

from pulpo_tpu_torch.ops import losses
from pulpo_tpu_torch.ops.resize import avg_pool_ceil, avg_pool_pyramid, resize_linear
from pulpo_tpu_torch.ops.warp import integrate_svf, resize_vecfield, warp_image, warp_landmarks

__all__ = ["resize_linear", "avg_pool_ceil", "avg_pool_pyramid", "warp_image", "integrate_svf",
           "resize_vecfield", "warp_landmarks", "losses"]
