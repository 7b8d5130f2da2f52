"""Dense warping, SVF integration and vector-field resizing.

Port of pulpo_tpu/ops/warp.py (the reference SpatialTransformer,
VecInt and ResizeTransform), without the TPU's halo, channels-first and
repair machinery: on the card a warp is a gather, exact at any
displacement.

`warp_image` and `integrate_svf` run the hand-written CUDA kernels for
tensors on the card (kernels/warp.py, kernels/squaring.py) and their
plain PyTorch versions for tensors on the CPU. Both are differentiable:
they go through the kernels' autograd Functions (`Warp`,
`IntegrateSVF`), whose backward passes are kernels too. On 2D fields
(the 2D configuration) the forward runs the 2D kernels and the gradient
is the plain version's, as the JAX package's 2D gradient is XLA's VJP.

The channels-first functions (`integrate_svf_cf`, `resize_vecfield_cf`,
`batched_level_warp_cf`; pulpo_tpu/ops/warp.py:236-295) serve the eval
decode at full resolution: the integration and the batched image warp
read and write (B, 3, *spatial) memory, and the resize between them
repeats the channels-last resize on a view. Unlike the JAX package's
fields they hold no tile padding and no halo: those exist for the
TPU's layout.

Under spatial sharding (parallel/spatial.py) `warp_image`,
`integrate_svf`, `integrate_svf_cf` and `batched_level_warp_cf` run on
this rank's slab by slab launches of the kernels (`spatial.warp_image`,
`spatial.integrate_svf`, `spatial.integrate_svf_cf`,
`spatial.batched_level_warp_cf`: the CF ones gather along the CF depth
axis 2); the resizes, `resize_vecfield_cf`'s too (a channels-last view),
run `spatial.resize`.

Layout: images (B, *spatial, C); displacement fields (B, *spatial, ndims)
with channel i = displacement along spatial axis i in voxels; the CF
fields (B, ndims, *spatial).
"""

from __future__ import annotations

import torch

from pulpo_tpu_torch.kernels import squaring
from pulpo_tpu_torch.kernels import warp as warp_kernel
from pulpo_tpu_torch.ops.resize import resize_linear
from pulpo_tpu_torch.parallel import spatial


def warp_image(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Warp `moving` (B, *in_spatial, C) by `df` (B_df, *out_spatial, nd).

    Trilinear, border padding, align_corners=False. The output has the
    df's spatial shape; moving may have another resolution (the mapping
    of pulpo_tpu/ops/warp.py:_source_coords). df row r reads moving row
    r % B (samples folded into the df's batch)."""
    if spatial.active():
        return spatial.warp_image(moving, df)
    return warp_kernel.warp(moving, df)


def integrate_svf(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling and squaring: ``vec *= 1/2**nsteps``, then ``nsteps`` times
    ``vec = vec + warp(vec, vec)`` (the reference VecInt)."""
    if spatial.active():
        return spatial.integrate_svf(vec, nsteps)
    return squaring.integrate_svf(vec, nsteps)


def integrate_svf_cf(vec_cf: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """`integrate_svf` of a channels-first field (B, 3, *spatial)."""
    if spatial.active():
        return spatial.integrate_svf_cf(vec_cf, nsteps)
    return squaring.integrate_svf_cf(vec_cf, nsteps)


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


def batched_level_warp_cf(moving: torch.Tensor,
                          dfs_cf: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
    """`batched_level_warp` with the per-level dfs channels-first
    (B_df, 3, *spatial): one CF kernel launch for all levels
    (pulpo_tpu/ops/warp.py:274-295). `moving` is channels-last (B,
    *spatial, C); each level's output is channels-last (B_df, *spatial,
    C), a view of the CF output (at C = 1 the same memory order)."""
    levels = sorted(dfs_cf)
    shapes = {tuple(dfs_cf[l].shape) for l in levels}
    assert len(shapes) == 1, f"batched_level_warp_cf needs equal shapes, got {shapes}"
    stacked = torch.cat([dfs_cf[l] for l in levels], dim=0)
    if spatial.active():
        warped = spatial.batched_level_warp_cf(moving, stacked)
    else:
        warped = warp_kernel.warp_cf(moving.float().permute(0, 4, 1, 2, 3), stacked)
    warped = warped.permute(0, 2, 3, 4, 1)
    per = dfs_cf[levels[0]].shape[0]
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
    size = x.shape[1:-1]
    if out_size is None:
        out_size = tuple(int(s * factor) for s in size)
    scales = tuple(factor for _ in size)
    if factor < 1:
        x = resize_linear(x, out_size, scales=scales)
        x = x * factor
    elif factor > 1:
        x = x * factor
        x = resize_linear(x, out_size, scales=scales)
    return x


def resize_vecfield_cf(x: torch.Tensor, vel_resize: float,
                       out_size: tuple[int, ...]) -> torch.Tensor:
    """`resize_vecfield` of a channels-first field (B, 3, *spatial)
    (pulpo_tpu/ops/warp.py:236-271, without its tile pads): the
    channels-last resize's operations on a view of the same values, so
    the two are equal bit for bit. A matmul's rounding depends on where
    a row sits in its operand (the CPU's GEMM rounds its edge rows
    otherwise), so a resize that contracted the CF memory directly
    would differ from the CL one in the last bit. Returns a (B, 3,
    *out_size) view of the last axis' matmul output."""
    out = resize_vecfield(x.permute(0, 2, 3, 4, 1), vel_resize, out_size)
    return out.permute(0, 4, 1, 2, 3)


def warp_landmarks(lm: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Warp landmarks (B, N, ndims) by a df (B, *spatial, ndims): the
    TRUNCATED landmark minus the df at it (pulpo_tpu/ops/warp.py:385-410)."""
    b = lm.shape[0]
    lmi = lm.to(torch.int64)
    lm = lmi.to(lm.dtype)
    size = df.shape[1:-1]
    ndims = len(size)
    strides, acc = [], 1
    for s in reversed(size):
        strides.append(acc)
        acc *= s
    strides = strides[::-1]
    idx = sum(lmi[..., ax] * strides[ax] for ax in range(ndims))  # (B, N)
    flat = df.reshape(b, -1, ndims)
    sampled = torch.gather(flat, 1, idx[..., None].expand(-1, -1, ndims))
    return lm - sampled
