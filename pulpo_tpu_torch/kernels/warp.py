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
`_warp_halo_dfgrad_pallas` (on the forward's tile plan) and the
moving-cotangent
`_warp_halo_mgrad_pallas` (and their cascades, the XLA VJP of
`ops/warp.py:warp_image` past them). `Warp` is the autograd Function
that joins the three; `warp` goes through it on both devices. The
moving-cotangent is a scatter summed order-free (`csrc/fixed.cuh`):
its terms are quantized to 64-bit fixed point at a scale fixed for the
launch (`fixed_scale`) and added as integers, so the kernel repeats
itself bit for bit and equals its plain version; it walks the squaring
backward's march (`mgrad_plan`).

Clamp convention of the backward: the source coordinate is
``clip(u, 0, S_in - 1)``; its derivative is taken as `jax.grad` takes
it through `jnp.clip` (maximum, then minimum): 1 strictly inside, 1/2
at a tie with a bound, 0 outside. The floor is one-sided (``w = c -
floor(c)``, derivative 1). The plain versions and the kernels use the
same convention; the Pallas kernels use a strict mask (0 at a tie),
which differs only on that measure-zero set.

`warp_cf` (the channels-first instantiation of `csrc/warp.cu`)
replaces `_warp_halo_pallas_cf` (warp_halo.py:1560) with its tier
ladder, sparse repair and terminal fallback (warp_halo.py:1560-1685,
1722-1736): the same warp of a (B, C, *S_in) moving by a (B_df, 3,
*S_out) df, without the TPU's tile padding, bit-equal to the
channels-last kernel. Like the JAX package's CF warp it serves the eval
decode; a gradient through it replays the plain version (`plain_vjp`).

In 2D (the 2D instantiation of `csrc/warp.cu`, counted in
`launches_2d`) the warp is the JAX package's XLA gather
(pulpo_tpu/ops/warp.py:56 `warp_image`, which `warp_image_auto` at
:154-171 takes in 2D): no Pallas kernel computes it, but a
kernel does here, so that no plain version runs on the card's forward
path. Its df- and moving-cotangents replay the plain version
(`plain_vjp`), as the JAX package's 2D gradient is XLA's VJP;
`csrc/warp_bwd.cu` stays 3D.

The forward kernel walks tiles of the output (`csrc/gather.cuh`) by the
plan that `tile_plan` computes and the launch passes in
(`kernels/gather.py`): a block takes planes x lines x a strip of the
innermost axis of one df row group that reads one moving row; a thread
computes its own voxel or, in a large channels-first launch, moves a
quad of 4 voxels with 16-byte accesses. A channels-last warp of more
than 4 channels (the 36-channel one-hot segmentation maps) takes the
channel body instead: a voxel's channels spread over neighbouring
threads in 16-byte chunks (single channels where C % 4 != 0 or the map
or output is not 16-byte aligned, `gather.aligned`). The df-cotangent
takes the forward's voxel plan at every C (`dfgrad_plan`); its launch
moves the channels of a voxel in 16-byte chunks where it can.

Slab launches (the depth-sharded model, parallel/spatial.py): `warp`,
`warp_dfgrad` and their plain versions take `z0, zg`: the df (and g,
and the output) are planes z0 .. of a whole output of depth zg, the
moving volume whole; each voxel's source coordinate takes its global
plane and the axis-0 factor S_in / (zg - 1), so a slab is bit-equal to
the matching planes of the whole launch (`gather.slab`). A 2D `warp`
takes the same slab along its first axis, H (lines z0 .. of zg), in its
voxel body (C = 1) and its channel body (C = 36); its gradient stays the
plain slab's (`plain_vjp`). Each slab launch records the body it took
in `slab_bodies` (the forward's channel body of 16-byte quads or of
single channels, or its voxel body, from its plan's `ch`, under "warp"
or "warp_2d"; the df-cotangent's `<1>`, `<36>` or `<0>`, from the body
`dfgrad_body` passes to its launch): a slab view off a 16-byte boundary
takes the single-channel body, right but slower.

Layout: moving (B, *S_in, C) and df (B_df, *S_out, nd) channels-last
float32, nd = 3 or, in 2D, 2 (the CF functions: (B, C, *S_in) and
(B_df, 3, *S_out)); df channel i = displacement along spatial axis i;
df row r reads moving row r % B (samples folded into the df's batch).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pulpo_tpu_torch.kernels import _build, gather, plain_vjp

launches = 0         # kernel launches of `warp` in 3D (never of the plain version)
launches_2d = 0      # kernel launches of `warp` in 2D
dfgrad_launches = 0  # kernel launches of `warp_dfgrad`
mgrad_launches = 0   # kernel launches of `warp_mgrad`
cf_launches = 0      # kernel launches of `warp_cf`


# slab launches by (kernel, body) since `reset_count`: ("warp" or, in 2D,
# "warp_2d", "ch4" | "ch1" | "voxel"), ("warp_dfgrad", "<1>" | "<36>" |
# "<0>"), ("warp_cf", "quad" | "voxel")
slab_bodies: dict[tuple[str, str], int] = {}


def reset_count() -> None:
    global launches, launches_2d, dfgrad_launches, mgrad_launches, cf_launches
    launches = launches_2d = dfgrad_launches = mgrad_launches = cf_launches = 0
    slab_bodies.clear()


def _record_slab(kernel: str, body: str) -> None:
    slab_bodies[(kernel, body)] = slab_bodies.get((kernel, body), 0) + 1


def dfgrad_body(moving: torch.Tensor, g: torch.Tensor) -> int:
    """The body of the df-cotangent's launch, passed to `pulpo_warp_dfgrad`
    (`csrc/warp_bwd.cu`, which refuses one that does not fit): 1 at C = 1,
    36 at C = 36 with map and cotangent 16-byte aligned, else 0 (a loop
    over single channels)."""
    c = moving.shape[-1]
    if c == 1:
        return 1
    return 36 if c == 36 and gather.aligned(moving, g) else 0


def _factor(s_in: int, s_out: int) -> float:
    """The per-axis factor S_in / (S_out - 1), rounded to float32 as the
    plain version's multiply by a Python float is."""
    return float(torch.tensor(s_in / (s_out - 1), dtype=torch.float32))


def _whole(df: torch.Tensor, i: int, z0: int, zg) -> tuple[int, int]:
    """(first global index, whole output size) of the df's axis i: a slab
    of planes z0 .. of a whole depth zg along axis 0, else the df's own."""
    s_out = df.shape[1 + i]
    if i == 0 and zg is not None:
        return z0, zg
    return 0, s_out


def _unclamped(df: torch.Tensor, in_spatial, i: int, z0: int = 0, zg=None) -> torch.Tensor:
    """``u = (g + d) * S_in / (S_out - 1) - 0.5`` along axis i (g the
    global grid index, S_out the whole output's size)."""
    out_spatial = df.shape[1:-1]
    s_out, s_in = out_spatial[i], in_spatial[i]
    g0, whole = _whole(df, i, z0, zg)
    shape = [1] * (len(out_spatial) + 1)
    shape[i + 1] = s_out
    g = torch.arange(g0, g0 + s_out, device=df.device, dtype=torch.float32).view(shape)
    loc = g + df[..., i].to(torch.float32)
    return loc * (s_in / (whole - 1)) - 0.5


def _clamp(u: torch.Tensor, s_in: int) -> torch.Tensor:
    """clip(u, 0, S_in - 1) as the kernels take it: fmaxf first, so a NaN
    coordinate reads voxel 0 instead of indexing out of the volume."""
    return torch.clamp(torch.fmax(u, u.new_zeros(())), max=s_in - 1)


def source_coords(df: torch.Tensor, in_spatial: tuple[int, ...], z0: int = 0,
                  zg=None) -> list[torch.Tensor]:
    """Per-axis clamped source coordinates into an input of size
    `in_spatial` for a df on the output grid (pulpo_tpu/ops/warp.py:33-53):
    ``src = (g + d) * S_in / (S_out - 1) - 0.5``, clamped to [0, S_in-1];
    a slab's (z0, zg) as `warp_plain`'s."""
    return [_clamp(_unclamped(df, in_spatial, i, z0, zg), in_spatial[i])
            for i in range(len(df.shape) - 2)]


def _corners(df: torch.Tensor, in_spatial, dtype, z0: int = 0, zg=None):
    """Per axis: the lower and upper corner index and the upper corner's
    weight, in `dtype`."""
    i0, i1, w = [], [], []
    for c, size in zip(source_coords(df, in_spatial, z0, zg), in_spatial):
        f = torch.floor(c)
        idx0 = f.to(torch.int64)
        i0.append(idx0)
        i1.append(torch.clamp(idx0 + 1, max=size - 1))
        w.append((c - f).to(dtype))
    return i0, i1, w


def _clip_grad(df: torch.Tensor, in_spatial, z0: int = 0, zg=None) -> list[torch.Tensor]:
    """Per axis d src / d df: the clip's derivative (1 inside, 1/2 at a
    tie, 0 outside, as jax.grad through maximum then minimum) times the
    factor S_in / (S_out - 1)."""
    out = []
    for i, s_in in enumerate(in_spatial):
        u = _unclamped(df, in_spatial, i, z0, zg)
        t = torch.fmax(u, u.new_zeros(()))
        half = torch.tensor(0.5, dtype=u.dtype, device=u.device)
        dmax = torch.where(u > 0, 1.0, torch.where(u == 0, half, 0.0))
        dmin = torch.where(t < s_in - 1, 1.0, torch.where(t == s_in - 1, half, 0.0))
        out.append(dmax * dmin * _factor(s_in, _whole(df, i, z0, zg)[1]))
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


def warp_plain(moving: torch.Tensor, df: torch.Tensor, z0: int = 0, zg=None) -> torch.Tensor:
    """The kernel's plain PyTorch version, operation for operation as
    `pulpo_tpu/ops/warp.py:warp_image`: 2**nd corner gathers, weights
    multiplied along the axes in order, corners summed in order. With
    `zg`, df is planes z0 .. of a whole output of depth zg (a slab)."""
    spatial = moving.shape[1:-1]
    ndims = len(spatial)
    assert df.shape[-1] == ndims, (df.shape, moving.shape)
    assert df.shape[0] % moving.shape[0] == 0, (df.shape, moving.shape)
    i0, i1, w = _corners(df, spatial, moving.dtype, z0, zg)
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
                      g: torch.Tensor, z0: int = 0, zg=None) -> torch.Tensor:
    """The df-cotangent of `warp_plain` written out (not autograd):
    per output voxel and axis a, ``sum_corner <g, m_corner> * (+-1) *
    prod_{b != a} w_b``, times the clip's derivative and the factor.
    Each corner's dot product adds its channels in order, as the kernel's
    bodies do. Returns (B_df, *S_out, 3) float32."""
    spatial = moving.shape[1:-1]
    ndims = len(spatial)
    moving, g = moving.float(), g.float()
    i0, i1, w = _corners(df, spatial, torch.float32, z0, zg)
    base, strides = _flat_index(moving.shape, df)
    c = moving.shape[-1]
    flat = moving.reshape(-1, c)
    gflat = g.reshape(-1, c)
    gw = [None] * ndims
    for corner in range(2**ndims):
        idx, _ = _corner(ndims, corner, i0, i1, w, base, strides)
        rows = flat[idx.reshape(-1)]
        gm = rows.new_zeros(rows.shape[0])
        for ch in range(c):
            gm = gm + rows[:, ch] * gflat[:, ch]
        gm = gm.reshape(idx.shape)
        for a in range(ndims):
            _, others = _corner(ndims, corner, i0, i1, w, base, strides, skip=a)
            t = gm * others
            if (corner >> a) & 1:
                gw[a] = t if gw[a] is None else gw[a] + t
            else:
                gw[a] = -t if gw[a] is None else gw[a] - t
    dclip = _clip_grad(df, spatial, z0, zg)
    return torch.stack([gw[a] * dclip[a] for a in range(ndims)], dim=-1)


def _ceil_log2(n: int) -> int:
    return max(0, (int(n) - 1).bit_length())


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2**k as float64, from its bits (exact for -1022 <= k <= 1023)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def abs_max_bits(g: torch.Tensor) -> torch.Tensor:
    """The largest |g| as the bits of a non-negative float32, in a (1,)
    int64 tensor (0 for an empty g), as the kernels' max pass writes it
    into their workspace's header: a max over several tensors (ranks) is
    the max of their bits, and a NaN or Inf in any of them stays at or
    above 0x7f800000."""
    if not g.numel():
        return torch.zeros(1, dtype=torch.int64, device=g.device)
    bits = g.float().abs().max().reshape(1).view(torch.int32) & 0x7FFFFFFF
    return bits.to(torch.int64)


def _exponent(top: torch.Tensor, count: int):
    """(k, finite) of `fixed_scale`, as 0-dim tensors."""
    bits = top.reshape(())
    finite = bits < 0x7F800000
    value = torch.where(finite, bits, torch.zeros_like(bits)).to(torch.int32).view(torch.float32)
    return 62 - _ceil_log2(count) - torch.frexp(value).exponent.to(torch.int64), finite


def fixed_scale(top: torch.Tensor, count: int):
    """The order-free scatter's scale (`csrc/fixed.cuh`) from `top` (the
    launch's largest |g|, `abs_max_bits`) over an output of `count` source
    (row, voxel) pairs: (2**k, 2**-k, finite) as 0-dim tensors on top's
    device, k = 62 - ceil(log2 count) - e with max|g| < 2**e (frexp's e),
    so that no target's sum of terms ``round(w * g * 2**k)`` (|w| <= 1)
    reaches 2**62; `finite` is False where max|g| is not finite. No host
    sync."""
    k, finite = _exponent(top, count)
    return _pow2(k), _pow2(-k), finite


def _factors_of(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2**k as two float32 powers of two, 2**(k // 2) and 2**(k - k // 2)
    (k lies in [-128, 210], so each lies in float32's normal range): a
    float32 term times the one and then the other is its exact product
    with 2**k wherever that is at least 2**-126, and a coarser product
    (below 2**-126) rounds to the same integer, 0. So `round(t * a * b)`
    in float32 is the kernels' `fixed::quantize` (exact in double
    there)."""
    half = torch.div(k, 2, rounding_mode="floor")
    return _pow2(half).float(), _pow2(k - half).float()


def warp_mgrad_plain(moving_shape, df: torch.Tensor, g: torch.Tensor, z0: int = 0,
                     zg=None, own: torch.Tensor | None = None, top: torch.Tensor | None = None,
                     exchange=None) -> torch.Tensor:
    """The moving-cotangent of `warp_plain` written out: the gather's
    transpose, each output voxel's ``w_corner * g`` added into its 8
    source corners of moving row r % B, summed as the kernel sums it
    (`csrc/fixed.cuh`): each float32 term quantized to an int64 at the
    launch's scale (`fixed_scale`, over the whole output's voxels: a slab
    (z0, zg) is quantized as the whole launch at the same max), the
    integers summed (in any order: the same bits), then converted to
    float32; `own` (df's shape, float32: the squaring backward's own terms
    of the df's planes) is added to those planes' sums in float64 before
    that one rounding. A sharded step's slab (its column's ranks each
    launch one slab of an output) passes `top`, the largest
    `abs_max_bits` of the column's slabs of g, in place of its own, and
    `exchange`, which adds into the int64 sums (`moving_shape`) of the
    slab's planes, in place, the other ranks' sums there: those planes
    are then the whole output's, bit for bit. A non-finite g gives NaN
    everywhere. Returns `moving_shape` float32."""
    moving_shape = tuple(moving_shape)
    spatial = moving_shape[1:-1]
    ndims = len(spatial)
    i0, i1, w = _corners(df, spatial, torch.float32, z0, zg)
    base, strides = _flat_index(moving_shape, df)
    c = moving_shape[-1]
    gflat = g.float().reshape(-1, c)
    count = df.shape[0] * math.prod((zg if zg is not None else df.shape[1], *df.shape[2:-1]))
    k, finite = _exponent(abs_max_bits(gflat) if top is None else top, count)
    gflat = torch.where(finite, gflat, gflat.new_zeros(()))
    up, up2 = _factors_of(k)
    acc = torch.zeros((math.prod(moving_shape[:-1]), c), device=df.device, dtype=torch.int64)
    for corner in range(2**ndims):
        idx, weight = _corner(ndims, corner, i0, i1, w, base, strides)
        terms = (gflat * weight.reshape(-1, 1)).mul_(up).mul_(up2).round_()
        acc.index_add_(0, idx.reshape(-1), terms.to(torch.int64))
    acc = acc.view(moving_shape)
    if exchange is not None:
        exchange(acc)
    out = acc.double().mul_(_pow2(-k))
    if own is not None:
        out[:, z0:z0 + df.shape[1]] += own.double()
    return out.float().masked_fill_(~finite, float("nan"))


def _check(moving: torch.Tensor, df: torch.Tensor, ndims: int = 3) -> None:
    if moving.dim() != ndims + 2 or df.dim() != ndims + 2 or df.shape[-1] != ndims:
        raise ValueError(f"warp kernel takes {ndims}D fields: moving {tuple(moving.shape)}, "
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


def _shapes(moving_shape, df_shape, cf: bool):
    """(B, C, S_in, S_out) of a launch; `cf`: the shapes are channels-first."""
    if cf:
        return moving_shape[0], moving_shape[1], tuple(moving_shape[2:]), tuple(df_shape[2:])
    return moving_shape[0], moving_shape[-1], tuple(moving_shape[1:-1]), tuple(df_shape[1:-1])


def max_channels(size) -> int:
    """The most channels a moving volume of spatial `size` may have in a
    launch of the forward or the df-cotangent kernel (`check_rows`): 312
    at the flagship's 160x192x224."""
    return (2**31 - 1) // math.prod(size)


def check_rows(moving_shape, df_shape, cf: bool = False) -> None:
    """Refuse a launch of the forward or the df-cotangent kernel whose
    moving, output or df row holds 2**31 elements or more: they address
    a row in 32 bits (`gather::valid` refuses the plan too)."""
    _, c, s_in, s_out = _shapes(moving_shape, df_shape, cf)
    if max(math.prod(s_in) * c, math.prod(s_out) * max(c, len(s_in))) >= 2**31:
        raise ValueError(f"warp kernel addresses a row in 32 bits: moving "
                         f"{tuple(moving_shape)}, df {tuple(df_shape)} (at most "
                         f"{max_channels(s_in)} channels at {tuple(s_in)})")


def tile_plan(moving_shape, df_shape, cf: bool = False, is_aligned: bool = True) -> dict:
    """The tile plan of the forward kernel's launch on these shapes
    (`kernels/gather.py:warp_plan`); `is_aligned`: the tensors the kernel
    moves 16-byte quads of start on a 16-byte boundary (the map and the
    output in a channel body, the df and the output in a CF launch)."""
    b, c, _, s_out = _shapes(moving_shape, df_shape, cf)
    return gather.warp_plan(s_out, df_shape[0], b, cf, c=c, is_aligned=is_aligned)


def dfgrad_plan(moving_shape, df_shape) -> dict:
    """The tile plan of the df-cotangent kernel's launch: the forward's
    voxel plan over the df's output space (one voxel a thread, ch = 0) at
    any C. The launch's body is `dfgrad_body`'s: one channel, 16-byte
    chunks of the 36 channels where the map and cotangent are 16-byte
    aligned, else single channels."""
    b, _, _, s_out = _shapes(moving_shape, df_shape, False)
    return gather.warp_plan(s_out, df_shape[0], b)


def _launch(lib: str, entry: str, ptrs, moving_shape, df: torch.Tensor, cf: bool = False,
            plan: dict | None = None, body: int | None = None):
    """Call the C entry `entry(ptrs..., B, B_df, C, I0.., O0.., f0..,
    [body,] [plan,] stream)` of kernel library `lib`, one I, O and f per
    spatial axis (the forward kernel and the df-cotangent, which walks the
    same output space, also take a tile plan: `plan`, whose zg is then the
    whole output's first axis for f0; the df-cotangent its `body`); `cf`: the
    shapes are channels-first."""
    b, c, s_in, s_out = _shapes(moving_shape, df.shape, cf)
    nd = len(s_in)
    whole = list(s_out)
    if plan is not None:
        check_rows(moving_shape, df.shape, cf)
        whole[0] = plan["zg"]
    plan = [] if plan is None else [gather.plan_arg(plan)]
    body = [] if body is None else [body]
    f = [_factor(s_in[i], whole[i]) for i in range(nd)]
    fn = getattr(_build.load(lib), entry)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * (3 + 2 * nd)
                   + [ctypes.c_float] * nd + [ctypes.c_int] * len(body)
                   + [ctypes.c_void_p] * (len(plan) + 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(df.device):
        rc = fn(*ptrs, b, df.shape[0], c, *s_in, *s_out, *f, *body, *plan,
                _build.stream_ptr(df))
    _build.check(rc, entry)


def _slab(plan: dict, df: torch.Tensor, z0: int, zg) -> dict:
    """`plan` as the slab launch of planes (2D: lines) z0 .. of zg (whole
    without zg)."""
    if zg is None:
        return plan
    if not 0 <= z0 <= zg - df.shape[1]:
        raise ValueError(f"a slab from {z0} of an axis of {zg} takes a df of at most "
                         f"{zg - z0} along it, got {tuple(df.shape)}")
    return gather.slab(plan, z0, zg)


def _warp_kernel(moving: torch.Tensor, df: torch.Tensor, z0: int = 0,
                 zg=None) -> torch.Tensor:
    """The forward: the CUDA kernel on the card, the plain version on the CPU."""
    if moving.device.type == "cpu":
        return warp_plain(moving, df, z0, zg)
    nd = df.dim() - 2
    _check(moving, df, 2 if nd == 2 else 3)
    moving, df = moving.contiguous(), df.contiguous()
    out = torch.empty((df.shape[0], *df.shape[1:-1], moving.shape[-1]),
                      device=df.device, dtype=torch.float32)
    global launches, launches_2d
    plan = tile_plan(moving.shape, df.shape, is_aligned=gather.aligned(moving, out))
    _launch("warp", "pulpo_warp_2d" if nd == 2 else "pulpo_warp",
            [moving.data_ptr(), df.data_ptr(), out.data_ptr()], moving.shape, df,
            plan=_slab(plan, df, z0, zg))
    if zg is not None:
        _record_slab("warp_2d" if nd == 2 else "warp",
                     f"ch{plan['ch']}" if plan["ch"] else "voxel")
    if nd == 2:
        launches_2d += 1
    else:
        launches += 1
    return out


def warp_cf_plain(moving: torch.Tensor, df: torch.Tensor, z0: int = 0, zg=None) -> torch.Tensor:
    """The CF kernel's plain version: the channels-last warp of the same
    values (a slab's (z0, zg) as `warp_plain`'s), returned as a (B_df, C,
    *S_out) view."""
    out = warp_plain(moving.permute(0, 2, 3, 4, 1), df.permute(0, 2, 3, 4, 1), z0, zg)
    return out.permute(0, 4, 1, 2, 3)


def _warp_cf_kernel(moving: torch.Tensor, df: torch.Tensor, z0: int = 0,
                    zg=None) -> torch.Tensor:
    _check(moving.permute(0, 2, 3, 4, 1), df.permute(0, 2, 3, 4, 1))
    moving, df = moving.contiguous(), df.contiguous()
    out = torch.empty((df.shape[0], moving.shape[1], *df.shape[2:5]),
                      device=df.device, dtype=torch.float32)
    global cf_launches
    plan = tile_plan(moving.shape, df.shape, cf=True, is_aligned=gather.aligned(df, out))
    _launch("warp", "pulpo_warp_cf", [moving.data_ptr(), df.data_ptr(), out.data_ptr()],
            moving.shape, df, cf=True, plan=_slab(plan, df.permute(0, 2, 3, 4, 1), z0, zg))
    if zg is not None:
        _record_slab("warp_cf", "quad" if plan["v"] == 4 else "voxel")
    cf_launches += 1
    return out


def warp_cf(moving: torch.Tensor, df: torch.Tensor, z0: int = 0, zg=None) -> torch.Tensor:
    """Warp a channels-first moving (B, C, *S_in) by a channels-first df
    (B_df, 3, *S_out) into (B_df, C, *S_out) float32: the CF kernel for
    tensors on the card (a gradient through it is the plain version's),
    the plain version on the CPU. Bit-equal to `warp` on the same values.
    With `zg`, a slab launch: df and output are planes z0 .. of a whole
    output of depth zg (axis 2), the moving volume whole."""
    if moving.device.type == "cpu":
        return warp_cf_plain(moving, df, z0, zg)
    return plain_vjp.apply(lambda m, d: _warp_cf_kernel(m, d, z0, zg),
                           lambda m, d: warp_cf_plain(m, d, z0, zg), moving, df)


def warp_dfgrad(moving: torch.Tensor, df: torch.Tensor, g: torch.Tensor, z0: int = 0,
                zg=None) -> torch.Tensor:
    """df-cotangent of the warp for cotangent g (B_df, *S_out, C): the CUDA
    kernel on the card, the plain version on the CPU; a slab's (z0, zg) as
    `warp`'s."""
    if moving.device.type == "cpu":
        return warp_dfgrad_plain(moving, df, g, z0, zg)
    _check(moving, df)
    _check_g(g, df, moving.shape[-1])
    moving, df, g = moving.contiguous(), df.contiguous(), g.contiguous()
    out = torch.empty(df.shape, device=df.device, dtype=torch.float32)
    global dfgrad_launches
    body = dfgrad_body(moving, g)
    _launch("warp_bwd", "pulpo_warp_dfgrad",
            [moving.data_ptr(), df.data_ptr(), g.data_ptr(), out.data_ptr()],
            moving.shape, df, plan=_slab(dfgrad_plan(moving.shape, df.shape), df, z0, zg),
            body=body)
    dfgrad_launches += 1
    if zg is not None:
        _record_slab("warp_dfgrad", f"<{body}>")
    return out


def mgrad_plan(df_shape) -> dict:
    """The plan of the moving-cotangent kernel's launch: the squaring
    backward's march (`kernels/gather.py:squaring_bwd_plan`) over the df's
    output space, one df row a block row."""
    return gather.squaring_bwd_plan(tuple(df_shape[1:-1]), df_shape[0])


def warp_mgrad(moving_shape, df: torch.Tensor, g: torch.Tensor, z0: int = 0,
               zg=None) -> torch.Tensor:
    """moving-cotangent of the warp, of shape `moving_shape`: the CUDA
    kernel on the card (an order-free fixed-point scatter, bit-equal to
    the plain version and from run to run; no host sync), the plain
    version on the CPU. The kernel takes no slab (no path differentiates
    a warped image)."""
    if df.device.type == "cpu":
        return warp_mgrad_plain(moving_shape, df, g, z0, zg)
    if zg is not None:
        raise ValueError("warp_mgrad kernel takes no slab")
    moving_shape = tuple(moving_shape)
    if len(moving_shape) != 5 or df.dim() != 5 or df.shape[-1] != 3 \
            or df.dtype != torch.float32 or df.shape[0] % moving_shape[0] != 0:
        raise ValueError(f"warp_mgrad takes a 3D float32 df with rows a multiple of "
                         f"moving's: moving {moving_shape}, df {tuple(df.shape)} {df.dtype}")
    _check_g(g, df, moving_shape[-1])
    df, g = df.contiguous(), g.contiguous()
    out = torch.empty(moving_shape, device=df.device, dtype=torch.float32)
    work = torch.empty(math.prod(moving_shape) + 1, device=df.device, dtype=torch.int64)
    global mgrad_launches
    _launch("warp_bwd", "pulpo_warp_mgrad",
            [df.data_ptr(), g.data_ptr(), out.data_ptr(), work.data_ptr()], moving_shape, df,
            plan=mgrad_plan(df.shape))
    mgrad_launches += 1
    return out


class Warp(torch.autograd.Function):
    """warp(moving, df) with its backward: the df-cotangent always, the
    moving-cotangent only when moving needs a gradient."""

    @staticmethod
    def forward(ctx, moving, df, z0=0, zg=None):
        ctx.save_for_backward(moving, df)
        ctx.slab = (z0, zg)
        return _warp_kernel(moving, df, z0, zg)

    @staticmethod
    def backward(ctx, g):
        moving, df = ctx.saved_tensors
        g = g.float()
        gm = (warp_mgrad(moving.shape, df, g, *ctx.slab).to(moving.dtype)
              if ctx.needs_input_grad[0] else None)
        gd = (warp_dfgrad(moving, df, g, *ctx.slab).to(df.dtype)
              if ctx.needs_input_grad[1] else None)
        return gm, gd, None, None


def warp(moving: torch.Tensor, df: torch.Tensor, z0: int = 0, zg=None) -> torch.Tensor:
    """Warp `moving` by `df`, differentiable in both: the CUDA kernels for
    tensors on the card, the plain versions for tensors on the CPU. A 2D
    warp (df (B_df, S0, S1, 2)) is differentiated as its plain version.
    With `zg`, a slab launch: df is planes z0 .. of a whole output of depth
    zg (in 2D: lines z0 .. of zg)."""
    if df.shape[-1] == 2:
        return plain_vjp.apply(lambda m, d: _warp_kernel(m, d, z0, zg),
                               lambda m, d: warp_plain(m, d, z0, zg), moving, df)
    return Warp.apply(moving, df, z0, zg)
