"""Dense warping, SVF integration and vector-field resizing.

Port of pulpo_tpu/ops/warp.py (the reference SpatialTransformer,
VecInt and ResizeTransform), without the TPU's halo, channels-first and
repair machinery: on the card a warp is a gather, exact at any
displacement.

`warp_image` and `integrate_svf` run the hand-written CUDA kernels for
tensors on the card (kernels/warp.py, kernels/squaring.py) and their
plain PyTorch versions for tensors on the CPU. Both are differentiable:
they go through the kernels' autograd Functions (`Warp`,
`IntegrateSVF`), whose backward passes are kernels too.

Layout: images (B, *spatial, C); displacement fields (B, *spatial, ndims)
with channel i = displacement along spatial axis i in voxels.
"""

from __future__ import annotations

import torch

from pulpo_tpu_torch.kernels import squaring
from pulpo_tpu_torch.kernels import warp as warp_kernel
from pulpo_tpu_torch.ops.resize import resize_linear


def warp_image(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Warp `moving` (B, *in_spatial, C) by `df` (B_df, *out_spatial, nd).

    Trilinear, border padding, align_corners=False. The output has the
    df's spatial shape; moving may have another resolution (the mapping
    of pulpo_tpu/ops/warp.py:_source_coords). df row r reads moving row
    r % B (samples folded into the df's batch)."""
    return warp_kernel.warp(moving, df)


def integrate_svf(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling and squaring: ``vec *= 1/2**nsteps``, then ``nsteps`` times
    ``vec = vec + warp(vec, vec)`` (the reference VecInt)."""
    return squaring.integrate_svf(vec, nsteps)


def batched_level_warp(moving: torch.Tensor,
                       dfs: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
    """Warp ONE moving image by every level's same-shaped df in a single
    call: the dfs are stacked along the batch axis as one sample-tiled
    warp (pulpo_tpu/ops/warp.py:174-193)."""
    levels = sorted(dfs)
    shapes = {tuple(dfs[l].shape) for l in levels}
    assert len(shapes) == 1, f"batched_level_warp needs equal shapes, got {shapes}"
    stacked = torch.cat([dfs[l] for l in levels], dim=0)
    warped = warp_image(moving.float(), stacked)
    per = dfs[levels[0]].shape[0]
    return {l: warped[i * per:(i + 1) * per] for i, l in enumerate(levels)}


def resize_vecfield(
    x: torch.Tensor,
    vel_resize: float,
    out_size: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """ResizeTransform: resize a vector field and rescale its magnitudes.

    factor = 1/vel_resize; factor < 1: interpolate then multiply;
    factor > 1: multiply then interpolate; 1: identity. The factor of
    every axis is the one given (the caller derives it from axis 0),
    not out/in per axis."""
    factor = 1.0 / vel_resize
    spatial = x.shape[1:-1]
    if out_size is None:
        out_size = tuple(int(s * factor) for s in spatial)
    scales = tuple(factor for _ in spatial)
    if factor < 1:
        x = resize_linear(x, out_size, scales=scales)
        x = x * factor
    elif factor > 1:
        x = x * factor
        x = resize_linear(x, out_size, scales=scales)
    return x


def warp_landmarks(lm: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Warp landmarks (B, N, ndims) by a df (B, *spatial, ndims): the
    TRUNCATED landmark minus the df at it (pulpo_tpu/ops/warp.py:385-410)."""
    b = lm.shape[0]
    lmi = lm.to(torch.int64)
    lm = lmi.to(lm.dtype)
    spatial = df.shape[1:-1]
    ndims = len(spatial)
    strides, acc = [], 1
    for s in reversed(spatial):
        strides.append(acc)
        acc *= s
    strides = strides[::-1]
    idx = sum(lmi[..., ax] * strides[ax] for ax in range(ndims))  # (B, N)
    flat = df.reshape(b, -1, ndims)
    sampled = torch.gather(flat, 1, idx[..., None].expand(-1, -1, ndims))
    return lm - sampled
