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

Routing by type: a bfloat16 x goes to the tensor-core body of
`csrc/conv_narrow.cu` (an implicit GEMM on `mma.sync`: its weights packed
here by `pack_weights` into a (K_pad, N_pad) bf16 matrix, 27 taps x cin
rounded up to even by cout rounded up to 8; its launch walking the tile
plan `tile_plan` computes); a float32 x to the CUDA-core body, bit-equal
to the plain version. The tensor cores sum the products in another
order, so a bf16 output is held to one bf16 ulp at the output's scale of
the plain version. Neither body falls back to the other: a launch that
fails raises.

Layout: x (B, *S, cin), weight (cout, cin, 3, 3, 3) as nn.Conv3d holds
it; out (B, *S, cout) in x's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pulpo_tpu_torch.kernels import _build

MAX_CIN = 4   # attic/conv_narrow.py:62
launches = 0  # kernel launches of `conv_narrow` (never of the plain version)

# the bf16 body's tiling (csrc/conv_narrow.cu): a block of 8 warps takes 8
# lines x 32 voxels of a plane and marches them along z through a chunk
# of at most MAX_TZ planes (`tile_plan`)
TILE_X, TILE_Y = 32, 8
MAX_TZ = 32
PLAN_KEYS = ("tiles_x", "tiles_y", "tz", "chunks")


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


def pair_channels(cin: int) -> int:
    """Channels a tap takes in the packed matrix: cin rounded up to even,
    so that every channel pair of the kernel's A fragments is one tap's."""
    return cin + cin % 2


def k_pad(cin: int) -> int:
    """Rows of the packed weight matrix: 27 taps x `pair_channels(cin)`,
    rounded up to a multiple of 16 (an mma k-step)."""
    return -(-27 * pair_channels(cin) // 16) * 16


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """The bf16 body's weights: a (K_pad, N_pad) bfloat16 matrix, row k =
    tap * cin_p + ci with taps in (kz, ky, kx) order and cin_p =
    `pair_channels(cin)`, column = output channel; zero in the pad
    channel of an odd cin, past the 27 * cin_p rows and past the cout
    columns (N_pad = cout rounded up to 8)."""
    cout, cin = w.shape[:2]
    cp = pair_channels(cin)
    packed = torch.zeros((k_pad(cin), -(-cout // 8) * 8), device=w.device,
                         dtype=torch.bfloat16)
    # one copy, rounding to bf16 as `_taps` does (two launches a call)
    packed[:27 * cp].view(27, cp, -1)[:, :cin, :cout] = w.permute(2, 3, 4, 1, 0).reshape(
        27, cin, cout)
    return packed


def tile_plan(b: int, s0: int, s1: int, s2: int, sms: int) -> dict:
    """The bf16 body's launch over B x S0 x S1 x S2 on a card of `sms`
    SMs: tiles of TILE_Y x TILE_X voxels of a plane, each block marching
    `tz` planes of one (`chunks` chunks along z). The chunks minimize the
    launch's waves (blocks over SMs, rounded up) times a block's planes
    plus 4 (its two halo planes and its prologue): a block's planes share
    its SM's shared-memory pipe, so more blocks than SMs buy little, and
    every chunk reloads its halo. At most MAX_TZ planes a block: past
    that, at the input size, the fewer blocks hid the loads' latency
    worse (PERF.md). The grid is (tiles_x * tiles_y, chunks, B)."""
    tiles_x, tiles_y = -(-s2 // TILE_X), -(-s1 // TILE_Y)
    per_chunk = tiles_x * tiles_y * b
    best = None
    for chunks in range(-(-s0 // MAX_TZ), s0 + 1):
        tz = -(-s0 // chunks)
        if -(-s0 // tz) != chunks:  # the same tz as fewer chunks
            continue
        cost = -(-per_chunk * chunks // sms) * (tz + 4)
        if best is None or cost < best[0]:
            best = (cost, tz, chunks)
    return {"tiles_x": tiles_x, "tiles_y": tiles_y, "tz": best[1], "chunks": best[2]}


def plan_arg(plan: dict):
    """`plan` as the C entry takes it: 4 ints."""
    return (ctypes.c_int * len(PLAN_KEYS))(*(plan[k] for k in PLAN_KEYS))


@functools.lru_cache(maxsize=None)
def _launch_plan(b: int, s0: int, s1: int, s2: int, sms: int):
    """`plan_arg(tile_plan(...))`, computed once a shape (a step launches
    the same five shapes every step)."""
    return plan_arg(tile_plan(b, s0, s1, s2, sms))


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


def conv_packed(x: torch.Tensor, weights: torch.Tensor, cout: int) -> torch.Tensor:
    """One launch of the kernel on a contiguous x on the card with its
    weights already laid out: `pack_weights(w)` for bf16, `_taps(w,
    torch.float32)` for float32."""
    b, s0, s1, s2, cin = x.shape
    if s0 * s1 * s2 * max(cout, cin) >= 2**31:
        raise ValueError(f"narrow conv kernel addresses a row in 32 bits: x {tuple(x.shape)}, "
                         f"cout {cout}")
    bf16 = x.dtype == torch.bfloat16
    plan = None
    if bf16:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = _launch_plan(b, s0, s1, s2, sms)
    out = torch.empty((b, s0, s1, s2, cout), device=x.device, dtype=x.dtype)
    fn = _build.load("conv_narrow").pulpo_conv_narrow
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    global launches
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weights.data_ptr(), out.data_ptr(), int(bf16),
                b, cin, s0, s1, s2, cout, plan, _build.stream_ptr(x))
        launches += 1
    _build.check(rc, "conv_narrow")
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv without its gradient: the CUDA kernel for a tensor on the
    card (the tensor-core body for bf16, the CUDA-core body for float32),
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return conv_narrow_plain(x, w)
    _check(x, w)
    x = x.contiguous()
    weights = pack_weights(w) if x.dtype == torch.bfloat16 else _taps(w, x.dtype)
    return conv_packed(x, weights, w.shape[0])


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
