"""Zero-padded separable box sum (the windowed-NCC building block): a
hand-written CUDA kernel and its plain version.

Replaces the TPU's `pulpo_tpu/kernels/box_sum.py:_box_sum_pallas` (and
its `lax.reduce_window` fallback `_box_sum_xla`): the sum of x over a
win x win x win window around each voxel, zero outside the volume (the
reference's ones-kernel convs with padding win // 2). `csrc/box_sum.cu`
runs the three axis passes in the TPU kernel's order (H, W, D) as
shifted adds, as the plain version does, so the two agree bit for bit.

`BoxSum` is the autograd Function: the box sum is symmetric and zero-
padded, so it is self-adjoint and its backward is the same kernel on
the cotangent (pulpo_tpu/kernels/box_sum.py:121-137).

Layout: (B, D, H, W) float32.
"""

from __future__ import annotations

import ctypes

import torch

from pulpo_tpu_torch.kernels import _build

launches = 0  # kernel launches of `box_sum` (one per call, three passes)


def reset_count() -> None:
    global launches
    launches = 0


def _box_axis(x: torch.Tensor, win: int, axis: int) -> torch.Tensor:
    """Zero-padded box sum along `axis` as shifted adds, in the order of
    pulpo_tpu/kernels/box_sum.py:28-39: acc = x, then + x shifted down by
    k, + x shifted up by k, for k = 1 .. win // 2."""
    acc = x
    size = x.shape[axis]
    for k in range(1, win // 2 + 1):
        if k >= size:
            break
        hi = torch.cat([x.narrow(axis, k, size - k),
                        x.new_zeros(x.shape[:axis] + (k,) + x.shape[axis + 1:])], axis)
        lo = torch.cat([x.new_zeros(x.shape[:axis] + (k,) + x.shape[axis + 1:]),
                        x.narrow(axis, 0, size - k)], axis)
        acc = acc + hi
        acc = acc + lo
    return acc


def box_sum_plain(x: torch.Tensor, win: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: H, W, then D passes."""
    for axis in (2, 3, 1):
        x = _box_axis(x, win, axis)
    return x


def _box_sum_kernel(x: torch.Tensor, win: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return box_sum_plain(x, win)
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"box_sum kernel takes (B, D, H, W) float32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    fn = _build.load("box_sum").pulpo_box_sum
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), tmp.data_ptr(), *x.shape, int(win),
                _build.stream_ptr(x))
        launches += 1
    _build.check(rc, "box_sum")
    return out


class BoxSum(torch.autograd.Function):
    """box_sum with its backward: the same box sum of the cotangent."""

    @staticmethod
    def forward(ctx, x, win):
        ctx.win = win
        return _box_sum_kernel(x, win)

    @staticmethod
    def backward(ctx, g):
        return _box_sum_kernel(g.float(), ctx.win), None


def box_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Zero-padded box sum of x (B, D, H, W) with window `win` (odd),
    differentiable: the CUDA kernel on the card, the plain version on
    the CPU."""
    if win % 2 != 1:
        raise ValueError(f"box_sum takes an odd window, got {win}")
    if win == 1:
        return x
    return BoxSum.apply(x, win)
