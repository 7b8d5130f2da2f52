"""VecInt squaring step: a hand-written CUDA kernel and its plain version.

Replaces the TPU's `pulpo_tpu/kernels/warp_local.py:_squaring_step_pallas`
and, past its sub-voxel bound, the warp_halo cascade of
`_squaring_step_tiered` (warp_local.py:377-422). Both compute one step
``v + warp(v, v)`` of the reference VecInt; `csrc/squaring.cu` does it
at any displacement with a per-voxel gather.

`integrate_svf` on the card is the 1/2**nsteps scale folded into the
first step, then one launch per step, alternating two buffers.

Layout: (B, *S, 3) channels-last float32.
"""

from __future__ import annotations

import ctypes

import torch

from pulpo_tpu_torch.kernels import _build
from pulpo_tpu_torch.kernels.warp import warp_plain

launches = 0  # kernel launches of `squaring_step` (one per step)


def reset_count() -> None:
    global launches
    launches = 0


def squaring_step_plain(vec: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``vec + warp(vec, vec)``."""
    return vec + warp_plain(vec, vec)


def integrate_svf_plain(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling and squaring in plain PyTorch (pulpo_tpu/ops/warp.py:294-305)."""
    assert nsteps >= 0
    vec = vec * (1.0 / (2**nsteps))
    for _ in range(nsteps):
        vec = squaring_step_plain(vec)
    return vec


def squaring_step(vec: torch.Tensor, out: torch.Tensor | None = None,
                  scale: float = 1.0) -> torch.Tensor:
    """One step ``v + warp(v, v)`` with ``v = scale * vec``: the CUDA
    kernel for a tensor on the card, the plain version on the CPU.
    `scale` must be a power of two (it is then exact)."""
    if vec.device.type == "cpu":
        return squaring_step_plain(vec * scale if scale != 1.0 else vec)
    if vec.dim() != 5 or vec.shape[-1] != 3 or vec.dtype != torch.float32:
        raise ValueError(f"squaring kernel takes (B, S0, S1, S2, 3) float32, "
                         f"got {tuple(vec.shape)} {vec.dtype}")
    vec = vec.contiguous()
    if out is None:
        out = torch.empty_like(vec, memory_format=torch.contiguous_format)
    if out.shape != vec.shape or out.dtype != vec.dtype or not out.is_contiguous():
        raise ValueError("squaring kernel writes a contiguous float32 `out` "
                         f"of the input's shape, got {tuple(out.shape)} {out.stride()}")
    b, s = vec.shape[0], vec.shape[1:4]
    f = [float(torch.tensor(s[i] / (s[i] - 1), dtype=torch.float32)) for i in range(3)]
    lib = _build.load("squaring")
    fn = lib.pulpo_squaring_step
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    with torch.cuda.device(vec.device):
        rc = fn(vec.data_ptr(), out.data_ptr(), b, *s, *f, float(scale),
                _build.stream_ptr(vec))
        launches += 1
    _build.check(rc, "squaring_step")
    return out


def integrate_svf(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling-and-squaring integration of a stationary velocity field
    (the reference VecInt). vec: (B, *S, nd) float32."""
    if vec.device.type == "cpu":
        return integrate_svf_plain(vec, nsteps)
    assert nsteps >= 0
    if nsteps == 0:
        return vec.clone()
    # contiguous buffers: empty_like would copy the strides of a permuted
    # input, and the kernel writes row-major
    vec = vec.contiguous()
    bufs = tuple(torch.empty_like(vec, memory_format=torch.contiguous_format)
                 for _ in range(2))
    cur = squaring_step(vec, bufs[0], scale=1.0 / (2**nsteps))
    for k in range(1, nsteps):
        cur = squaring_step(cur, bufs[k % 2])
    return cur
