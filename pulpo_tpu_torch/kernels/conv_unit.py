"""One eval ConvUnit with its fused epilogue: the launcher of
`csrc/conv_unit.cu` and the plain version of one unit.

A unit is a dict with PyTorch's layout: k (cout, cin, 3, 3, 3), b
(cout,), and its BatchNorm's mean, var, scale, bias (cout,). It computes
conv3^3 SAME (+ y2) + bias -> eval BatchNorm -> LeakyReLU(0.2) on a
channels-last x (R, S0, S1, S2, cin) in x's dtype (bfloat16 or
float32), with the JAX package's rounding points
(pulpo_tpu/kernels/pos_head.py:44-50): the conv's float32 sum is
rounded to the compute type before anything is added; y2 and the bias
are added in that type; BatchNorm runs in float32 and rounds; the
LeakyReLU takes its sign from the float32 value. The last unit of the
posterior head adds the 1x1 mu and sigma heads (softplus on sigma).

`kernels/pos_head.py` and `kernels/conv_chain.py` launch it; they hold
the launch counts. In bfloat16 the kernel walks the spatial bricks of
output voxels that `tile_plan` lays out, in `_build.tile_origin`'s
order, with weights packed as 8-channel core matrices (`pack_tc`); in
float32 it takes the (np, kp) matrix of `_pack`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pulpo_tpu_torch.kernels import _build
from pulpo_tpu_torch.kernels.vel_head import _conv_f32, bn_affine

UNIT, UNIT_ADD, UNIT_HEADS = 0, 1, 2
WIDTHS = (16, 32, 64, 96, 128, 192)  # the kernel's template widths (cout padded)
MAX_WIDTH = WIDTHS[-1]
K_CHUNK = 32  # float32: the packed K is a multiple of this
TC_CHUNK = 16  # bfloat16: input channels per K step (the wgmma depth)
TILE_YX = 8  # bfloat16: a brick's y and x extent
UNIT_KEYS = ("k", "b", "mean", "var", "scale", "bias")


def leaky_from_f32(y: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """LeakyReLU(0.2) of float32 y rounded to dt, the sign taken from y
    (pulpo_tpu/kernels/activations.py:leaky_from_f32): rounding keeps the
    sign, so this is leaky(y.to(dt)) value for value."""
    x = y.to(dt)
    return torch.where(y < 0, x * torch.tensor(0.2, dtype=dt, device=x.device), x)


def softplus_dt(x: torch.Tensor) -> torch.Tensor:
    """softplus in x's dtype: max(x, 0) + log1p(exp(-|x|)), each
    transcendental computed in float32 and rounded to the dtype
    (pulpo_tpu/kernels/activations.py:softplus_dt)."""
    dt = x.dtype
    xf = x.float()
    m = torch.where(xf >= 0, x, torch.zeros((), dtype=dt, device=x.device))
    e = torch.exp(-xf.abs()).to(dt)
    return m + torch.log1p(e.float()).to(dt)


def unit_plain(x: torch.Tensor, u: dict, y2: torch.Tensor | None = None) -> torch.Tensor:
    """One unit, plain. y2 (B, *, cout) has fewer rows than x (R = S*B):
    row r adds y2[r % B]."""
    dt = x.dtype
    a = _conv_f32(x, u["k"], 1)
    if y2 is not None:
        a = a + y2.to(dt).repeat(a.shape[0] // y2.shape[0], 1, 1, 1, 1)
    a = a + u["b"].to(dt)
    mean, mul, add = bn_affine(u["mean"], u["var"], u["scale"], u["bias"])
    return leaky_from_f32((a.float() - mean) * mul + add, dt)


def heads_plain(x: torch.Tensor, hk_mu, hb_mu, hk_sig, hb_sig):
    """The 1x1 mu and sigma heads (k (zd, c, 1, 1, 1)), softplus on sigma."""
    dt = x.dtype
    mu = _conv_f32(x, hk_mu, 0) + hb_mu.to(dt)
    return mu, softplus_dt(_conv_f32(x, hk_sig, 0) + hb_sig.to(dt))


def width(cout: int) -> int:
    """The kernel's padded width for `cout` channels."""
    return next(w for w in WIDTHS if w >= cout)


def _epilogue_operands(u: dict, dt: torch.dtype, npad: int, device):
    """bias (np,) float32 rounded to dt; BatchNorm (3, np) float32."""
    cout = u["k"].shape[0]
    b = F.pad(u["b"].to(device=device, dtype=dt).float(), (0, npad - cout))
    bn = torch.stack([F.pad(t.to(device), (0, npad - cout))
                      for t in bn_affine(u["mean"], u["var"], u["scale"], u["bias"])])
    return b.contiguous(), bn.contiguous()


def _pack(u: dict, dt: torch.dtype, device) -> list[torch.Tensor]:
    """The float32 kernel's operands: weights (np, kp) in dt with k = tap *
    cin + c, zero-padded, and `_epilogue_operands`."""
    cout, cin = u["k"].shape[:2]
    npad, kp = width(cout), -(-27 * cin // K_CHUNK) * K_CHUNK
    w = u["k"].to(device=device, dtype=dt).permute(0, 2, 3, 4, 1).reshape(cout, 27 * cin)
    w = F.pad(w, (0, kp - 27 * cin, 0, npad - cout))
    return [w.contiguous(), *_epilogue_operands(u, dt, npad, device)]


def tile_plan(rows: int, size, npad: int, sms: int) -> dict:
    """The bf16 kernel's launch (`_build.brick_plan`): bricks of tz x 8 x 8
    output voxels of one row, tz = 8, 4 or 2 for a padded width <= 64,
    <= 128, 192 (the planes of its two warpgroups' accumulators), walked
    by a persistent grid of one block per SM."""
    tz = 8 if npad <= 64 else 4 if npad <= 128 else 2
    return _build.brick_plan(rows, size, (tz, TILE_YX, TILE_YX), sms)


def pack_tc(k: torch.Tensor, npad: int) -> torch.Tensor:
    """bf16 weights k (cout, cin, 3, 3, 3) as the kernel's stages: (cp / 16,
    3 dz, 9 (dy, dx), 2, npad, 8), cp = cin padded to 16 and npad = cout
    padded, with zeros. Each [c, dz] block is one bulk copy; each [.., h]
    (npad, 8) slab is npad / 8 core matrices of 8 output channels x 8
    input channels (c * 16 + h * 8 + e)."""
    cout, cin = k.shape[:2]
    cp = -(-cin // TC_CHUNK) * TC_CHUNK
    k = F.pad(k, (0, 0, 0, 0, 0, 0, 0, cp - cin, 0, npad - cout))
    k = k.reshape(npad, cp // TC_CHUNK, 2, 8, 3, 3, 3).permute(1, 4, 5, 6, 2, 0, 3)
    return k.reshape(cp // TC_CHUNK, 3, 9, 2, npad, 8).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(x: torch.Tensor, u: dict, mode: int = UNIT, y2: torch.Tensor | None = None,
           heads: tuple | None = None):
    """One launch of the kernel on x (a CUDA tensor the callers' `takes`
    admitted). UNIT_ADD takes y2 (B, *x.shape[1:4], cout); UNIT_HEADS
    takes heads = (hk_mu, hb_mu, hk_sig, hb_sig) and returns (mu, sigma)."""
    dt = x.dtype
    R, S0, S1, S2, cin = x.shape
    cout = u["k"].shape[0]
    if dt == torch.bfloat16:  # channels padded to the K step, weights as core matrices
        npad, kp = width(cout), 0
        cp = -(-cin // TC_CHUNK) * TC_CHUNK
        if cp != cin:
            x = F.pad(x, (0, cp - cin))
        cin = cp
        w = pack_tc(u["k"].to(device=x.device, dtype=dt), npad)
        b, bn = _epilogue_operands(u, dt, npad, x.device)
        plan = _build.plan_arg(tile_plan(
            R, (S0, S1, S2), npad, torch.cuda.get_device_properties(x.device).multi_processor_count))
    else:
        w, b, bn = _pack(u, dt, x.device)
        (npad, kp), plan = w.shape, None
    x = _aligned(x)
    zd = 0
    wh = bh = y2p = out2 = None
    if mode == UNIT_ADD:
        y2p = _aligned(y2.to(dt))
    if mode == UNIT_HEADS:
        hk_mu, hb_mu, hk_sig, hb_sig = heads
        zd = hk_mu.shape[0]
        r = lambda t: t.to(device=x.device, dtype=dt).float()
        wh = F.pad(torch.cat([r(hk_mu).reshape(zd, cout), r(hk_sig).reshape(zd, cout)]),
                   (0, npad - cout)).contiguous()
        bh = torch.cat([r(hb_mu), r(hb_sig)]).contiguous()
        out = torch.empty((R, S0, S1, S2, zd), device=x.device, dtype=dt)
        out2 = torch.empty_like(out)
    else:
        out = torch.empty((R, S0, S1, S2, cout), device=x.device, dtype=dt)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.load("conv_unit").pulpo_conv_unit
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), bn.data_ptr(), ptr(y2p), ptr(wh),
                ptr(bh), out.data_ptr(), ptr(out2), R, S0, S1, S2, cin, cout, npad, kp,
                1 if y2p is None else y2p.shape[0], mode, zd, plan, _build.stream_ptr(x))
    _build.check(rc, "conv_unit")
    return (out, out2) if mode == UNIT_HEADS else out


def check_unit(u: dict, cin: int) -> bool:
    """Whether the kernel takes unit u on a cin-channel input."""
    k = u["k"]
    return (k.dim() == 5 and tuple(k.shape[1:]) == (cin, 3, 3, 3)
            and 1 <= k.shape[0] <= MAX_WIDTH and cin <= MAX_WIDTH
            and all(tuple(u[n].shape) == (k.shape[0],) for n in UNIT_KEYS[1:]))


def check_input(x: torch.Tensor) -> bool:
    """Whether the kernel takes x's rank, dtype and size."""
    return (x.dim() == 5 and x.dtype in (torch.bfloat16, torch.float32)
            and x.numel() > 0 and x.numel() // x.shape[-1] < 2**31)
