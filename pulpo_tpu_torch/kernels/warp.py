"""Dense trilinear warp and its two cotangents: hand-written CUDA kernels
and their plain versions.

Replaces the TPU's `pulpo_tpu/kernels/warp_halo.py:_warp_halo_pallas`
and the cascade, repair and gather branches around it
(`warp_cascaded`, `warp_repaired`, `_exact_warp_rows`, and the XLA
gather `ops/warp.py:warp_image`): they all compute one function, the
reference SpatialTransformer (grid_sample, border padding,
align_corners=False). The TPU has no vector gather, so it needs a
halo stencil that is exact only within +-H voxels, and a ladder of
fallbacks past it. A CUDA thread can gather, so one kernel
(`csrc/warp.cu`) is exact at any displacement and any input size.

The backward (`csrc/warp_bwd.cu`) replaces the df-cotangent
`_warp_halo_dfgrad_pallas` and the moving-cotangent
`_warp_halo_mgrad_pallas` (and their cascades, the XLA VJP of
`ops/warp.py:warp_image` past them). `Warp` is the autograd Function
that joins the three; `warp` goes through it on both devices.

Clamp convention of the backward: the source coordinate is
``clip(u, 0, S_in - 1)``; its derivative is taken as `jax.grad` takes
it through `jnp.clip` (maximum, then minimum): 1 strictly inside, 1/2
at a tie with a bound, 0 outside. The floor is one-sided (``w = c -
floor(c)``, derivative 1). The plain versions and the kernels use the
same convention; the Pallas kernels use a strict mask (0 at a tie),
which differs only on that measure-zero set.

Layout: moving (B, *S_in, C) and df (B_df, *S_out, 3) channels-last
float32, df channel i = displacement along spatial axis i; df row r
reads moving row r % B (samples folded into the df's batch).
"""

from __future__ import annotations

import ctypes

import torch

from pulpo_tpu_torch.kernels import _build

launches = 0         # kernel launches of `warp` (never of the plain version)
dfgrad_launches = 0  # kernel launches of `warp_dfgrad`
mgrad_launches = 0   # kernel launches of `warp_mgrad`


def reset_count() -> None:
    global launches, dfgrad_launches, mgrad_launches
    launches = dfgrad_launches = mgrad_launches = 0


def _factor(s_in: int, s_out: int) -> float:
    """The per-axis factor S_in / (S_out - 1), rounded to float32 as the
    plain version's multiply by a Python float is."""
    return float(torch.tensor(s_in / (s_out - 1), dtype=torch.float32))


def _unclamped(df: torch.Tensor, in_spatial, i: int) -> torch.Tensor:
    """``u = (g + d) * S_in / (S_out - 1) - 0.5`` along axis i."""
    out_spatial = df.shape[1:-1]
    s_out, s_in = out_spatial[i], in_spatial[i]
    shape = [1] * (len(out_spatial) + 1)
    shape[i + 1] = s_out
    g = torch.arange(s_out, device=df.device, dtype=torch.float32).view(shape)
    loc = g + df[..., i].to(torch.float32)
    return loc * (s_in / (s_out - 1)) - 0.5


def _clamp(u: torch.Tensor, s_in: int) -> torch.Tensor:
    """clip(u, 0, S_in - 1) as the kernels take it: fmaxf first, so a NaN
    coordinate reads voxel 0 instead of indexing out of the volume."""
    return torch.clamp(torch.fmax(u, u.new_zeros(())), max=s_in - 1)


def source_coords(df: torch.Tensor, in_spatial: tuple[int, ...]) -> list[torch.Tensor]:
    """Per-axis clamped source coordinates into an input of size
    `in_spatial` for a df on the output grid (pulpo_tpu/ops/warp.py:33-53):
    ``src = (g + d) * S_in / (S_out - 1) - 0.5``, clamped to [0, S_in-1]."""
    return [_clamp(_unclamped(df, in_spatial, i), in_spatial[i])
            for i in range(len(df.shape) - 2)]


def _corners(df: torch.Tensor, in_spatial, dtype):
    """Per axis: the lower and upper corner index and the upper corner's
    weight, in `dtype`."""
    i0, i1, w = [], [], []
    for c, size in zip(source_coords(df, in_spatial), in_spatial):
        f = torch.floor(c)
        idx0 = f.to(torch.int64)
        i0.append(idx0)
        i1.append(torch.clamp(idx0 + 1, max=size - 1))
        w.append((c - f).to(dtype))
    return i0, i1, w


def _clip_grad(df: torch.Tensor, in_spatial) -> list[torch.Tensor]:
    """Per axis d src / d df: the clip's derivative (1 inside, 1/2 at a
    tie, 0 outside, as jax.grad through maximum then minimum) times the
    factor S_in / (S_out - 1)."""
    out = []
    for i, s_in in enumerate(in_spatial):
        u = _unclamped(df, in_spatial, i)
        t = torch.fmax(u, u.new_zeros(()))
        half = torch.tensor(0.5, dtype=u.dtype, device=u.device)
        dmax = torch.where(u > 0, 1.0, torch.where(u == 0, half, 0.0))
        dmin = torch.where(t < s_in - 1, 1.0, torch.where(t == s_in - 1, half, 0.0))
        out.append(dmax * dmin * _factor(s_in, df.shape[1 + i]))
    return out


def _flat_index(moving_shape, df: torch.Tensor):
    """Row offsets into the flat moving volume (df row r reads r % B) and
    the per-axis strides."""
    spatial = moving_shape[1:-1]
    n_in = 1
    for s in spatial:
        n_in *= s
    strides, acc = [], 1
    for s in reversed(spatial):
        strides.append(acc)
        acc *= s
    b_df = df.shape[0]
    bidx = torch.arange(b_df, device=df.device).view((b_df,) + (1,) * len(spatial))
    return (bidx % moving_shape[0]) * n_in, strides[::-1]


def _corner(ndims, corner, i0, i1, w, base, strides, skip=None):
    """Flat index and weight of one corner; the weight's product leaves
    out axis `skip` (the derivative along it)."""
    idx = base
    weight = None
    for ax in range(ndims):
        hi = (corner >> ax) & 1
        idx = idx + (i1[ax] if hi else i0[ax]) * strides[ax]
        if ax == skip:
            continue
        wax = w[ax] if hi else (1.0 - w[ax])
        weight = wax if weight is None else weight * wax
    return idx, weight


def warp_plain(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, operation for operation as
    `pulpo_tpu/ops/warp.py:warp_image`: 2**nd corner gathers, weights
    multiplied along the axes in order, corners summed in order."""
    spatial = moving.shape[1:-1]
    ndims = len(spatial)
    assert df.shape[-1] == ndims, (df.shape, moving.shape)
    assert df.shape[0] % moving.shape[0] == 0, (df.shape, moving.shape)
    i0, i1, w = _corners(df, spatial, moving.dtype)
    base, strides = _flat_index(moving.shape, df)
    c = moving.shape[-1]
    flat = moving.reshape(-1, c)
    out = None
    for corner in range(2**ndims):
        idx, weight = _corner(ndims, corner, i0, i1, w, base, strides)
        contrib = flat[idx.reshape(-1)] * weight.reshape(-1, 1)
        out = contrib if out is None else out + contrib
    return out.reshape(df.shape[0], *df.shape[1:-1], c)


def warp_dfgrad_plain(moving: torch.Tensor, df: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """The df-cotangent of `warp_plain` written out (not autograd):
    per output voxel and axis a, ``sum_corner <g, m_corner> * (+-1) *
    prod_{b != a} w_b``, times the clip's derivative and the factor.
    Returns (B_df, *S_out, 3) float32."""
    spatial = moving.shape[1:-1]
    ndims = len(spatial)
    moving, g = moving.float(), g.float()
    i0, i1, w = _corners(df, spatial, torch.float32)
    base, strides = _flat_index(moving.shape, df)
    c = moving.shape[-1]
    flat = moving.reshape(-1, c)
    gflat = g.reshape(-1, c)
    gw = [None] * ndims
    for corner in range(2**ndims):
        idx, _ = _corner(ndims, corner, i0, i1, w, base, strides)
        gm = (flat[idx.reshape(-1)] * gflat).sum(-1).reshape(idx.shape)
        for a in range(ndims):
            _, others = _corner(ndims, corner, i0, i1, w, base, strides, skip=a)
            t = gm * others
            if (corner >> a) & 1:
                gw[a] = t if gw[a] is None else gw[a] + t
            else:
                gw[a] = -t if gw[a] is None else gw[a] - t
    dclip = _clip_grad(df, spatial)
    return torch.stack([gw[a] * dclip[a] for a in range(ndims)], dim=-1)


def warp_mgrad_plain(moving_shape, df: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The moving-cotangent of `warp_plain` written out: the gather's
    transpose, each output voxel's ``w_corner * g`` added into its 8
    source corners of moving row r % B. Returns `moving_shape` float32."""
    moving_shape = tuple(moving_shape)
    spatial = moving_shape[1:-1]
    ndims = len(spatial)
    i0, i1, w = _corners(df, spatial, torch.float32)
    base, strides = _flat_index(moving_shape, df)
    c = moving_shape[-1]
    gflat = g.float().reshape(-1, c)
    n = 1
    for s in moving_shape[:-1]:
        n *= s
    out = torch.zeros((n, c), device=df.device, dtype=torch.float32)
    for corner in range(2**ndims):
        idx, weight = _corner(ndims, corner, i0, i1, w, base, strides)
        out.index_add_(0, idx.reshape(-1), gflat * weight.reshape(-1, 1))
    return out.reshape(moving_shape)


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


def _check_g(g: torch.Tensor, df: torch.Tensor, c: int) -> None:
    if g.dtype != torch.float32 or tuple(g.shape) != (*df.shape[:-1], c) \
            or g.device != df.device:
        raise ValueError(f"warp cotangent takes float32 {(*df.shape[:-1], c)} on "
                         f"{df.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")


def _launch(lib: str, entry: str, ptrs, moving_shape, df: torch.Tensor):
    """Call the C entry `entry(ptrs..., B, B_df, C, I0..2, O0..2, f0..2,
    stream)` of kernel library `lib`."""
    b, c = moving_shape[0], moving_shape[-1]
    s_in, s_out = tuple(moving_shape[1:4]), tuple(df.shape[1:4])
    f = [_factor(s_in[i], s_out[i]) for i in range(3)]
    fn = getattr(_build.load(lib), entry)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(df.device):
        rc = fn(*ptrs, b, df.shape[0], c, *s_in, *s_out, *f, _build.stream_ptr(df))
    _build.check(rc, entry)


def _warp_kernel(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """The forward: the CUDA kernel on the card, the plain version on the CPU."""
    if moving.device.type == "cpu":
        return warp_plain(moving, df)
    _check(moving, df)
    moving, df = moving.contiguous(), df.contiguous()
    out = torch.empty((df.shape[0], *df.shape[1:4], moving.shape[-1]),
                      device=df.device, dtype=torch.float32)
    global launches
    _launch("warp", "pulpo_warp", [moving.data_ptr(), df.data_ptr(), out.data_ptr()],
            moving.shape, df)
    launches += 1
    return out


def warp_dfgrad(moving: torch.Tensor, df: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """df-cotangent of the warp for cotangent g (B_df, *S_out, C): the CUDA
    kernel on the card, the plain version on the CPU."""
    if moving.device.type == "cpu":
        return warp_dfgrad_plain(moving, df, g)
    _check(moving, df)
    _check_g(g, df, moving.shape[-1])
    moving, df, g = moving.contiguous(), df.contiguous(), g.contiguous()
    out = torch.empty(df.shape, device=df.device, dtype=torch.float32)
    global dfgrad_launches
    _launch("warp_bwd", "pulpo_warp_dfgrad",
            [moving.data_ptr(), df.data_ptr(), g.data_ptr(), out.data_ptr()],
            moving.shape, df)
    dfgrad_launches += 1
    return out


def warp_mgrad(moving_shape, df: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """moving-cotangent of the warp, of shape `moving_shape`: the CUDA
    kernel (f32 atomics, so the summation order is not fixed) on the
    card, the plain version on the CPU."""
    if df.device.type == "cpu":
        return warp_mgrad_plain(moving_shape, df, g)
    moving_shape = tuple(moving_shape)
    if len(moving_shape) != 5 or df.dim() != 5 or df.shape[-1] != 3 \
            or df.dtype != torch.float32 or df.shape[0] % moving_shape[0] != 0:
        raise ValueError(f"warp_mgrad takes a 3D float32 df with rows a multiple of "
                         f"moving's: moving {moving_shape}, df {tuple(df.shape)} {df.dtype}")
    _check_g(g, df, moving_shape[-1])
    df, g = df.contiguous(), g.contiguous()
    out = torch.zeros(moving_shape, device=df.device, dtype=torch.float32)
    global mgrad_launches
    _launch("warp_bwd", "pulpo_warp_mgrad", [df.data_ptr(), g.data_ptr(), out.data_ptr()],
            moving_shape, df)
    mgrad_launches += 1
    return out


class Warp(torch.autograd.Function):
    """warp(moving, df) with its backward: the df-cotangent always, the
    moving-cotangent only when moving needs a gradient."""

    @staticmethod
    def forward(ctx, moving, df):
        ctx.save_for_backward(moving, df)
        return _warp_kernel(moving, df)

    @staticmethod
    def backward(ctx, g):
        moving, df = ctx.saved_tensors
        g = g.float()
        gm = (warp_mgrad(moving.shape, df, g).to(moving.dtype)
              if ctx.needs_input_grad[0] else None)
        gd = (warp_dfgrad(moving, df, g).to(df.dtype)
              if ctx.needs_input_grad[1] else None)
        return gm, gd


def warp(moving: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Warp `moving` by `df`, differentiable in both: the CUDA kernels for
    tensors on the card, the plain versions for tensors on the CPU."""
    return Warp.apply(moving, df)
