"""Zero-padded separable box sum (the windowed-NCC building block): a
hand-written CUDA kernel and its plain version.

Replaces the TPU's `pulpo_tpu/kernels/box_sum.py:_box_sum_pallas` (and
its `lax.reduce_window` fallback `_box_sum_xla`): the sum of x over a
win x win x win window around each voxel, zero outside the volume (the
reference's ones-kernel convs with padding win // 2). `csrc/box_sum.cu`
runs the three axis passes in the TPU kernel's order (H, W, D) as
shifted adds, as the plain version does, so the two agree bit for bit:
one launch, in which a block marches a tile of (H, W) along a chunk of
D planes (`box_sum_plan`), the H and W passes in shared memory and the
D pass over a register ring of the last `win` planes.

In 2D (`box_sum_2d` launches, the NCC of the 2D configuration) it
replaces the x.ndim == 3 arm of `_box_sum_pallas` (box_sum.py:63-74):
the win x win box sum of a (B, H, W) slice, the H pass then the W pass
(`_hw_kernel`), from the same source's `pulpo_box_sum_2d` entry: the
same plane kernel without the D ring, one launch.

`BoxSum` is the autograd Function: the box sum is symmetric and zero-
padded, so it is self-adjoint and its backward is the same kernel on
the cotangent (pulpo_tpu/kernels/box_sum.py:121-137).

Layout: (B, D, H, W) or, in 2D, (B, H, W) float32.
"""

from __future__ import annotations

import ctypes

import torch

from pulpo_tpu_torch.kernels import _build
from pulpo_tpu_torch.kernels.gather import cdiv

launches = 0     # kernel launches of `box_sum` on (B, D, H, W)
launches_2d = 0  # kernel launches of `box_sum` on (B, H, W)

TILE_W, TILE_H = 32, 32  # a block's outputs along W and H (csrc/box_sum.cu: TW, TH)
MAX_WINDOW = 17          # the widest window the kernel is instantiated for
TARGET_BLOCKS = 396      # D is split into chunks until a launch has as many blocks


def reset_count() -> None:
    global launches, launches_2d
    launches = launches_2d = 0


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
    """The kernel's plain PyTorch version: H, W, then D passes on
    (B, D, H, W); H then W on (B, H, W)."""
    for axis in ((2, 3, 1) if x.dim() == 4 else (1, 2)):
        x = _box_axis(x, win, axis)
    return x


def box_sum_plan(b: int, d: int, h: int, w: int) -> dict:
    """The launch's plan over B x D x H x W (a 2D input: D = 1): tiles of
    TILE_H x TILE_W outputs, and D split into as few chunks of `chunk`
    planes as give the launch TARGET_BLOCKS blocks (a chunk also reads
    win // 2 planes on each side). The grid is (tiles_w, tiles_h,
    b * chunks)."""
    tiles_w, tiles_h = cdiv(w, TILE_W), cdiv(h, TILE_H)
    chunks = max(1, min(d, cdiv(TARGET_BLOCKS, tiles_w * tiles_h * b)))
    chunk = cdiv(d, chunks)
    return {"tw": TILE_W, "th": TILE_H, "tiles_w": tiles_w, "tiles_h": tiles_h,
            "chunk": chunk, "chunks": cdiv(d, chunk)}


PLAN_KEYS = ("tw", "th", "tiles_w", "tiles_h", "chunk", "chunks")


def plan_arg(plan: dict):
    """`plan` as the C entry points take it: 6 ints."""
    return (ctypes.c_int * len(PLAN_KEYS))(*(plan[k] for k in PLAN_KEYS))


def _box_sum_kernel(x: torch.Tensor, win: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return box_sum_plain(x, win)
    if x.dim() not in (3, 4) or x.dtype != torch.float32:
        raise ValueError(f"box_sum kernel takes (B, D, H, W) or (B, H, W) float32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if win > MAX_WINDOW:
        raise ValueError(f"box_sum kernel takes windows up to {MAX_WINDOW}, got {win}")
    x = x.contiguous()
    out = torch.empty_like(x)
    entry = "pulpo_box_sum" if x.dim() == 4 else "pulpo_box_sum_2d"
    fn = getattr(_build.load("box_sum"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * (x.dim() + 1)
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    b, *rest = x.shape
    d, h, w = rest if x.dim() == 4 else (1, *rest)
    plan = plan_arg(box_sum_plan(b, d, h, w))
    global launches, launches_2d
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), *x.shape, int(win), plan, _build.stream_ptr(x))
        if x.dim() == 4:
            launches += 1
        else:
            launches_2d += 1
    _build.check(rc, entry)
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
    """Zero-padded box sum of x (B, D, H, W) or (B, H, W) with window `win` (odd),
    differentiable: the CUDA kernel on the card (windows up to
    MAX_WINDOW), the plain version on the CPU."""
    if win % 2 != 1:
        raise ValueError(f"box_sum takes an odd window, got {win}")
    if win == 1:
        return x
    return BoxSum.apply(x, win)
