"""The fused eval VelocityField head: a hand-written CUDA kernel and its
plain version.

Replaces the TPU's `pulpo_tpu/kernels/vel_head.py:velocity_head_fused`:
conv3^3(zdim -> n0) + bias -> eval BatchNorm -> LeakyReLU(0.2) ->
conv3^3(n0 -> n0) + bias -> BatchNorm -> LeakyReLU -> 1x1(n0 -> 3) + bias,
with every intermediate kept on chip (`csrc/vel_head.cu`).

Parameters use PyTorch's layout: k1 (n0, zdim, 3, 3, 3), k2 (n0, n0, 3,
3, 3), k3 (3, n0, 1, 1, 1), biases b1, b2, b3, and for each BatchNorm
scale{i}, bias{i}, mean{i}, var{i} (i = 1, 2). z: (B, S0, S1, S2, zdim)
channels-last, bfloat16 or float32; the output has z's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pulpo_tpu_torch.kernels import _build

MAX_ZDIM = 4
MAX_N0 = 64
BN_EPS = 1e-5
_N0_BUILDS = (16, 32, 64)  # the kernel's template widths

launches = 0  # kernel launches of `velocity_head`


def reset_count() -> None:
    global launches
    launches = 0


def bn_affine(mean, var, scale, bias) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax's eval BatchNorm as (mean, mul, add), all float32:
    ``y = (x - mean) * mul + add``, ``mul = rsqrt(var + eps) * scale``."""
    mul = torch.rsqrt(var.float() + BN_EPS) * scale.float()
    return mean.float(), mul, bias.float()


def head_bn(p: dict, i: int):
    """bn_affine of the head's BatchNorm i (1 or 2)."""
    return bn_affine(p[f"mean{i}"], p[f"var{i}"], p[f"scale{i}"], p[f"bias{i}"])


def leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) in x's dtype, the slope rounded to that dtype."""
    return torch.where(x < 0, x * torch.tensor(0.2, dtype=x.dtype, device=x.device), x)


def eval_bn(x: torch.Tensor, mean, mul, add) -> torch.Tensor:
    """Eval BatchNorm on a channels-last tensor, in float32, cast back."""
    return ((x.float() - mean) * mul + add).to(x.dtype)


def _conv_f32(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """conv3d of channels-last x, summed in float32 over values of x's
    dtype, rounded to x's dtype (the kernel's rounding point)."""
    dt = x.dtype
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.to(dt).float(), padding=pad)
    return y.to(dt).permute(0, 2, 3, 4, 1)


def velocity_head_plain(z: torch.Tensor, p: dict) -> torch.Tensor:
    """The kernel's plain PyTorch version, with its rounding points
    (pulpo_tpu/kernels/vel_head.py:velocity_head_xla)."""
    dt = z.dtype
    x = _conv_f32(z, p["k1"], 1) + p["b1"].to(dt)
    x = leaky(eval_bn(x, *head_bn(p, 1)))
    x = _conv_f32(x, p["k2"], 1) + p["b2"].to(dt)
    x = leaky(eval_bn(x, *head_bn(p, 2)))
    return _conv_f32(x, p["k3"], 0) + p["b3"].to(dt)


def _pack(p: dict, dt: torch.dtype, n0p: int, device) -> list[torch.Tensor]:
    """Kernel operands, float32 holding values rounded to `dt`, padded
    with zero channels to the kernel's width n0p."""
    n0, zdim = p["k1"].shape[:2]
    pad = n0p - n0
    r = lambda t: t.to(device=device, dtype=dt).float()
    w1 = r(p["k1"]).permute(2, 3, 4, 1, 0).reshape(27, zdim, n0)
    w2 = r(p["k2"]).permute(2, 3, 4, 1, 0).reshape(27, n0, n0)
    w3 = r(p["k3"]).reshape(3, n0).T
    w1 = F.pad(w1, (0, pad))
    w2 = F.pad(w2, (0, pad, 0, pad))
    w3 = F.pad(w3, (0, 0, 0, pad))
    bias = torch.stack([F.pad(r(p["b1"]), (0, pad)), F.pad(r(p["b2"]), (0, pad)),
                        F.pad(r(p["b3"]), (0, n0p - 3))])
    bn = torch.stack([F.pad(t.to(device), (0, pad))
                      for i in (1, 2) for t in head_bn(p, i)])
    return [t.contiguous() for t in (w1, w2, w3, bias, bn)]


def _check(z: torch.Tensor, p: dict) -> int:
    if z.dim() != 5:
        raise ValueError(f"velocity head takes (B, S0, S1, S2, zdim), got {tuple(z.shape)}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"velocity head takes bfloat16 or float32, got {z.dtype}")
    n0, zdim = p["k1"].shape[:2]
    if zdim != z.shape[-1] or zdim > MAX_ZDIM:
        raise ValueError(f"velocity head kernel takes zdim <= {MAX_ZDIM} "
                         f"matching k1, got z {tuple(z.shape)}, k1 {tuple(p['k1'].shape)}")
    if n0 > MAX_N0 or tuple(p["k2"].shape) != (n0, n0, 3, 3, 3) \
            or tuple(p["k3"].shape) != (3, n0, 1, 1, 1):
        raise ValueError(f"velocity head kernel takes n0 <= {MAX_N0} and a "
                         f"3-channel 1x1 head, got k2 {tuple(p['k2'].shape)}, "
                         f"k3 {tuple(p['k3'].shape)}")
    if z.shape[0] > 65535:
        raise ValueError(f"velocity head kernel takes at most 65535 rows, got {z.shape[0]}")
    return next(w for w in _N0_BUILDS if w >= n0)


def velocity_head(z: torch.Tensor, p: dict) -> torch.Tensor:
    """The fused head: the CUDA kernel for a tensor on the card, the plain
    version on the CPU. Raises for widths the kernel does not take."""
    if z.device.type == "cpu":
        return velocity_head_plain(z, p)
    n0p = _check(z, p)
    z = z.contiguous()
    ops = _pack(p, z.dtype, n0p, z.device)
    out = torch.empty((*z.shape[:4], 3), device=z.device, dtype=z.dtype)
    fn = _build.load("vel_head").pulpo_vel_head
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in ops],
                *z.shape[:4], z.shape[-1], n0p, int(z.dtype == torch.bfloat16),
                _build.stream_ptr(z))
        launches += 1
    _build.check(rc, "velocity_head")
    return out
