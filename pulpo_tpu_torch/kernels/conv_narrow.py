"""Narrow-input SAME 3x3x3 conv: a hand-written CUDA kernel, its plain
version and its autograd Function.

Replaces the TPU's `pulpo_tpu/attic/conv_narrow.py:conv3d_narrow_mxu`:
a 3x3x3 conv, stride 1, zero padding 1, no bias, of a channels-last
input with at most `MAX_CIN` channels, summed in float32 and rounded
once to the input's type. In the port it is the one implementation of
the model's narrow convs (`models/blocks.py:conv_cl` routes every
k = 3, pad = 1 conv whose input has <= 4 channels here): on the train
path `down_block_0`'s first conv (2 -> n0, the concatenated pair) and
each latent level's velocity head's first conv (zdim = 3 -> n0). In
eval both sit inside the fused kernels (`conv_chain`, `vel_head`).

`NarrowConv` is the autograd Function: the forward is the kernel on the
card and the plain version on the CPU; the backward is the library conv
backward (`aten.convolution_backward`) in the compute type, as the JAX
package's `custom_vjp` replays XLA's conv VJP
(attic/conv_narrow.py:179-199): the JAX package has no backward kernel.

Layout: x (B, *S, cin), weight (cout, cin, 3, 3, 3) as nn.Conv3d holds
it; out (B, *S, cout) in x's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from pulpo_tpu_torch.kernels import _build

MAX_CIN = 4   # attic/conv_narrow.py:62
launches = 0  # kernel launches of `conv_narrow` (never of the plain version)


def reset_count() -> None:
    global launches
    launches = 0


def takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """The shape rule: a 3D channels-last x with at most MAX_CIN channels
    and a (cout, cin, 3, 3, 3) weight."""
    return (x.dim() == 5 and w.dim() == 5 and tuple(w.shape[2:]) == (3, 3, 3)
            and w.shape[1] == x.shape[-1] <= MAX_CIN)


def _taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(27, cin, cout) float32 weights, rounded to the compute dtype first,
    tap-major in (kz, ky, kx) order."""
    cout, cin = w.shape[:2]
    return w.to(dtype).float().permute(2, 3, 4, 1, 0).reshape(27, cin, cout).contiguous()


def conv_narrow_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the 27-tap sum in float32 over
    shifted views of the zero-padded input, taps in (kz, ky, kx) order and
    channels inner, each product added to an accumulator that starts at 0,
    rounded once to x's dtype. The JAX kernel's arithmetic (f32
    accumulation of products of compute-type values)."""
    b, s0, s1, s2, cin = x.shape
    taps = _taps(w, x.dtype)
    xp = x.new_zeros((b, s0 + 2, s1 + 2, s2 + 2, cin), dtype=torch.float32)
    xp[:, 1:-1, 1:-1, 1:-1] = x.float()
    acc = torch.zeros((b, s0, s1, s2, w.shape[0]), device=x.device, dtype=torch.float32)
    for k in range(27):
        kz, ky, kx = k // 9, (k // 3) % 3, k % 3
        view = xp[:, kz:kz + s0, ky:ky + s1, kx:kx + s2]
        for ci in range(cin):
            acc += view[..., ci:ci + 1] * taps[k, ci]
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if not takes(x, w):
        raise ValueError(f"narrow conv kernel takes x (B, S0, S1, S2, cin <= {MAX_CIN}) and a "
                         f"(cout, cin, 3, 3, 3) weight, got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"narrow conv kernel takes float32 or bfloat16, got {x.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, weight on {w.device}")


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv without its gradient: the CUDA kernel for a tensor on the
    card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return conv_narrow_plain(x, w)
    _check(x, w)
    x = x.contiguous()
    taps = _taps(w, x.dtype)
    b, s0, s1, s2, cin = x.shape
    cout = w.shape[0]
    out = torch.empty((b, s0, s1, s2, cout), device=x.device, dtype=x.dtype)
    fn = _build.load("conv_narrow").pulpo_conv_narrow
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), taps.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
                b, cin, s0, s1, s2, cout, _build.stream_ptr(x))
        launches += 1
    _build.check(rc, "conv_narrow")
    return out


class NarrowConv(torch.autograd.Function):
    """conv_narrow(x, w) with the library conv backward in x's dtype: dW
    always, dx only when x needs a gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype).permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
            None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
            [need_x, need_w, False])
        return (gx.permute(0, 2, 3, 4, 1) if need_x else None,
                gw.to(w.dtype) if need_w else None)


def conv_narrow(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3x3 conv of a channels-last x with <= MAX_CIN channels by a
    (cout, cin, 3, 3, 3) weight, no bias, differentiable: the CUDA kernel
    for a tensor on the card (raises for a shape it does not take), the
    plain version on the CPU."""
    return NarrowConv.apply(x, w)
