"""Dense trilinear warp: a hand-written CUDA kernel and its plain version.

Replaces the TPU's `pulpo_tpu/kernels/warp_halo.py:_warp_halo_pallas`
and the cascade, repair and gather branches around it
(`warp_cascaded`, `warp_repaired`, `_exact_warp_rows`, and the XLA
gather `ops/warp.py:warp_image`): they all compute one function, the
reference SpatialTransformer (grid_sample, border padding,
align_corners=False). The TPU has no vector gather, so it needs a
halo stencil that is exact only within +-H voxels, and a ladder of
fallbacks past it. A CUDA thread can gather, so one kernel
(`csrc/warp.cu`) is exact at any displacement and any input size.

Layout: moving (B, *S_in, C) and df (B_df, *S_out, 3) channels-last
float32, df channel i = displacement along spatial axis i; df row r
reads moving row r % B (samples folded into the df's batch).
"""

from __future__ import annotations

import ctypes

import torch

from pulpo_tpu_torch.kernels import _build

launches = 0  # kernel launches of `warp` (never of the plain version)


def reset_count() -> None:
    global launches
    launches = 0


def source_coords(df: torch.Tensor, in_spatial: tuple[int, ...]) -> list[torch.Tensor]:
    """Per-axis clamped source coordinates into an input of size
    `in_spatial` for a df on the output grid (pulpo_tpu/ops/warp.py:33-53):
    ``src = (g + d) * S_in / (S_out - 1) - 0.5``, clamped to [0, S_in-1]."""
    out_spatial = df.shape[1:-1]
    coords = []
    for i in range(len(out_spatial)):
        s_out, s_in = out_spatial[i], in_spatial[i]
        shape = [1] * (len(out_spatial) + 1)
        shape[i + 1] = s_out
        g = torch.arange(s_out, device=df.device, dtype=torch.float32).view(shape)
        loc = g + df[..., i].to(torch.float32)
        src = loc * (s_in / (s_out - 1)) - 0.5
        coords.append(torch.clamp(src, 0.0, s_in - 1))
    return coords


def warp_plain(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, operation for operation as
    `pulpo_tpu/ops/warp.py:warp_image`: 2**nd corner gathers, weights
    multiplied along the axes in order, corners summed in order."""
    spatial = moving.shape[1:-1]
    ndims = len(spatial)
    assert df.shape[-1] == ndims, (df.shape, moving.shape)
    assert df.shape[0] % moving.shape[0] == 0, (df.shape, moving.shape)
    coords = source_coords(df, spatial)
    i0, i1, w = [], [], []
    for c, size in zip(coords, spatial):
        f = torch.floor(c)
        idx0 = f.to(torch.int64)
        i0.append(idx0)
        i1.append(torch.clamp(idx0 + 1, max=size - 1))
        w.append((c - f).to(moving.dtype))

    b, c = moving.shape[0], moving.shape[-1]
    n_in = 1
    for s in spatial:
        n_in *= s
    strides, acc = [], 1
    for s in reversed(spatial):
        strides.append(acc)
        acc *= s
    strides = strides[::-1]
    b_df = df.shape[0]
    bidx = torch.arange(b_df, device=df.device).view((b_df,) + (1,) * ndims) % b
    flat = moving.reshape(-1, c)

    out = None
    for corner in range(2**ndims):
        idx = bidx * n_in
        weight = None
        for ax in range(ndims):
            hi = (corner >> ax) & 1
            idx = idx + (i1[ax] if hi else i0[ax]) * strides[ax]
            wax = w[ax] if hi else (1.0 - w[ax])
            weight = wax if weight is None else weight * wax
        contrib = flat[idx.reshape(-1)] * weight.reshape(-1, 1)
        out = contrib if out is None else out + contrib
    return out.reshape(b_df, *df.shape[1:-1], c)


def _check(moving: torch.Tensor, df: torch.Tensor) -> None:
    if moving.dim() != 5 or df.dim() != 5 or df.shape[-1] != 3:
        raise ValueError(f"warp kernel takes 3D fields: moving {tuple(moving.shape)}, "
                         f"df {tuple(df.shape)}")
    if moving.dtype != torch.float32 or df.dtype != torch.float32:
        raise TypeError(f"warp kernel takes float32, got {moving.dtype}, {df.dtype}")
    if df.shape[0] % moving.shape[0] != 0:
        raise ValueError(f"df rows {df.shape[0]} not a multiple of moving rows "
                         f"{moving.shape[0]}")
    if df.device != moving.device:
        raise ValueError(f"moving on {moving.device}, df on {df.device}")


def warp(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Warp `moving` by `df`: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if moving.device.type == "cpu":
        return warp_plain(moving, df)
    _check(moving, df)
    moving = moving.contiguous()
    df = df.contiguous()
    b, c = moving.shape[0], moving.shape[-1]
    b_df = df.shape[0]
    s_in, s_out = moving.shape[1:4], df.shape[1:4]
    out = torch.empty((b_df, *s_out, c), device=df.device, dtype=torch.float32)
    # the per-axis factor S_in / (S_out - 1), rounded to float32 as the
    # plain version's multiply by a Python float is
    f = [float(torch.tensor(s_in[i] / (s_out[i] - 1), dtype=torch.float32))
         for i in range(3)]
    lib = _build.load("warp")
    fn = lib.pulpo_warp
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    with torch.cuda.device(df.device):
        rc = fn(moving.data_ptr(), df.data_ptr(), out.data_ptr(),
                b, b_df, c, *s_in, *s_out, *f, _build.stream_ptr(df))
        launches += 1
    _build.check(rc, "warp")
    return out
