"""VecInt squaring step and its backward: hand-written CUDA kernels and
their plain versions.

Replaces the TPU's `pulpo_tpu/kernels/warp_local.py:_squaring_step_pallas`
and, past its sub-voxel bound, the warp_halo cascade of
`_squaring_step_tiered` (warp_local.py:377-422). Both compute one step
``v + warp(v, v)`` of the reference VecInt; `csrc/squaring.cu` does it
at any displacement with a per-voxel gather.

The backward (`csrc/squaring_bwd.cu`) replaces
`_squaring_step_bwd_pallas` (warp_local.py:309) and the tiered backward
past its bound (warp_local.py:455-485): ``g + dfgrad(v, v, g) +
mgrad(v, v, g)``, one launch per step at any displacement.

`integrate_svf` is the autograd Function `IntegrateSVF`: the
1/2**nsteps scale folded into the first step, then one launch per step.
Without a gradient to keep, the steps alternate two buffers; with one,
each step writes a fresh buffer, and the backward runs the steps'
backward in reverse over the kept inputs.

Layout: (B, *S, 3) channels-last float32.
"""

from __future__ import annotations

import ctypes

import torch

from pulpo_tpu_torch.kernels import _build
from pulpo_tpu_torch.kernels.warp import (
    _factor,
    warp_dfgrad_plain,
    warp_mgrad_plain,
    warp_plain,
)

launches = 0      # kernel launches of `squaring_step` (one per step)
bwd_launches = 0  # kernel launches of `squaring_step_bwd` (one per step)


def reset_count() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def squaring_step_plain(vec: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``vec + warp(vec, vec)``."""
    return vec + warp_plain(vec, vec)


def squaring_step_bwd_plain(vec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's plain version: the VJP of
    ``vec + warp(vec, vec)`` for cotangent g, written out as
    ``g + dfgrad(v, v, g) + mgrad(v, v, g)``."""
    return (g.float() + warp_dfgrad_plain(vec, vec, g)
            + warp_mgrad_plain(vec.shape, vec, g))


def integrate_svf_plain(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling and squaring in plain PyTorch (pulpo_tpu/ops/warp.py:294-305)."""
    assert nsteps >= 0
    vec = vec * (1.0 / (2**nsteps))
    for _ in range(nsteps):
        vec = squaring_step_plain(vec)
    return vec


def _check(vec: torch.Tensor, what: str) -> None:
    if vec.dim() != 5 or vec.shape[-1] != 3 or vec.dtype != torch.float32:
        raise ValueError(f"{what} takes (B, S0, S1, S2, 3) float32, "
                         f"got {tuple(vec.shape)} {vec.dtype}")


def _factors(vec: torch.Tensor) -> list[float]:
    s = vec.shape[1:4]
    return [_factor(s[i], s[i]) for i in range(3)]


def squaring_step(vec: torch.Tensor, out: torch.Tensor | None = None,
                  scale: float = 1.0) -> torch.Tensor:
    """One step ``v + warp(v, v)`` with ``v = scale * vec``: the CUDA
    kernel for a tensor on the card, the plain version on the CPU.
    `scale` must be a power of two (it is then exact)."""
    if vec.device.type == "cpu":
        return squaring_step_plain(vec * scale if scale != 1.0 else vec)
    _check(vec, "squaring kernel")
    vec = vec.contiguous()
    if out is None:
        out = torch.empty_like(vec, memory_format=torch.contiguous_format)
    if out.shape != vec.shape or out.dtype != vec.dtype or not out.is_contiguous():
        raise ValueError("squaring kernel writes a contiguous float32 `out` "
                         f"of the input's shape, got {tuple(out.shape)} {out.stride()}")
    b, s = vec.shape[0], vec.shape[1:4]
    lib = _build.load("squaring")
    fn = lib.pulpo_squaring_step
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    with torch.cuda.device(vec.device):
        rc = fn(vec.data_ptr(), out.data_ptr(), b, *s, *_factors(vec), float(scale),
                _build.stream_ptr(vec))
        launches += 1
    _build.check(rc, "squaring_step")
    return out


def squaring_step_bwd(vec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The VJP of one step at `vec` for cotangent g: the CUDA kernel
    (f32 atomics, so the summation order is not fixed) for tensors on
    the card, the plain version on the CPU."""
    if vec.device.type == "cpu":
        return squaring_step_bwd_plain(vec, g)
    _check(vec, "squaring backward kernel")
    _check(g, "squaring backward kernel")
    if g.shape != vec.shape or g.device != vec.device:
        raise ValueError(f"cotangent {tuple(g.shape)} on {g.device} does not match "
                         f"the field {tuple(vec.shape)} on {vec.device}")
    vec, g = vec.contiguous(), g.contiguous()
    out = torch.empty_like(vec, memory_format=torch.contiguous_format)
    b, s = vec.shape[0], vec.shape[1:4]
    fn = _build.load("squaring_bwd").pulpo_squaring_step_bwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global bwd_launches
    with torch.cuda.device(vec.device):
        rc = fn(vec.data_ptr(), g.data_ptr(), out.data_ptr(), b, *s, *_factors(vec),
                _build.stream_ptr(vec))
        bwd_launches += 1
    _build.check(rc, "squaring_step_bwd")
    return out


class IntegrateSVF(torch.autograd.Function):
    """Scaling and squaring with its backward. The forward keeps every
    step's input (nsteps fields) when the input needs a gradient."""

    @staticmethod
    def forward(ctx, vec, nsteps):
        scale = 1.0 / (2**nsteps)
        ctx.nsteps = nsteps
        keep = ctx.needs_input_grad[0]
        if vec.device.type == "cpu":
            cur = vec * scale
            inputs = []
            for _ in range(nsteps):
                inputs.append(cur)
                cur = squaring_step_plain(cur)
        else:
            # contiguous buffers: empty_like would copy the strides of a
            # permuted input, and the kernel writes row-major
            vec = vec.contiguous()
            new = lambda: torch.empty_like(vec, memory_format=torch.contiguous_format)
            bufs = (new(), new())
            inputs = [None]  # step 0's input, scale * vec, is rebuilt in backward
            cur = squaring_step(vec, new() if keep else bufs[0], scale=scale)
            for k in range(1, nsteps):
                inputs.append(cur)
                cur = squaring_step(cur, new() if keep else bufs[k % 2])
        if keep:
            ctx.save_for_backward(vec, *inputs[1:])
        return cur

    @staticmethod
    def backward(ctx, g):
        vec, *later = ctx.saved_tensors
        scale = 1.0 / (2**ctx.nsteps)
        inputs = [vec * scale] + later
        g = g.float()
        for v in reversed(inputs):
            g = squaring_step_bwd(v, g)
        return g * scale, None


def integrate_svf(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling-and-squaring integration of a stationary velocity field
    (the reference VecInt), differentiable. vec: (B, *S, 3) float32."""
    assert nsteps >= 0
    if nsteps == 0:
        return vec.clone()
    if vec.device.type != "cpu":
        _check(vec, "squaring kernel")
    return IntegrateSVF.apply(vec, nsteps)
