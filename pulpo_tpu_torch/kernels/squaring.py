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
mgrad(v, v, g)``, one launch per step at any displacement. A block
marches its tile of source voxels along z (`kernels/gather.py:
squaring_bwd_plan`); a thread merges the terms its voxels send twice to
one cell (the upper-z corners of a plane and the lower-z corners of the
next) and takes the next lane's terms for its own cells, then adds them
to the output with global float atomics.

`integrate_svf` is the autograd Function `IntegrateSVF`: the
1/2**nsteps scale folded into the first step, then one launch per step.
Without a gradient to keep, the steps alternate two buffers; with one,
each step writes a fresh buffer, and the backward runs the steps'
backward in reverse over the kept inputs.

The channels-first step `squaring_step_cf` (the CF instantiation of
`csrc/squaring.cu`) replaces `_squaring_step_cf_pallas`
(warp_local.py:603) and the `squaring_beyond_cf` cascade past its
bound (warp_local.py:629-649, warp_halo.py:1687): the same step on a
(B, 3, S0, S1, S2) field, without the TPU's tile padding, bit-equal to
the channels-last kernel. `integrate_svf_cf` chains it; like the JAX
package's `integrate_svf_cf` (warp_local.py:664-689) it is an eval
path whose gradient replays the plain version (`plain_vjp`).

The 2D step (the 2D instantiation of `csrc/squaring.cu`, counted in
`launches_2d`) replaces the ndims == 2 arm of `_squaring_step_pallas`
(warp_local.py:186-202, `_step_kernel_2d`) and the XLA gather that
`_squaring_step_tiered` takes past its bound (warp_local.py:397-401):
the same step on a (B, S0, S1, 2) field, 4 bilinear corners, exact at
any displacement. The JAX package's 2D backward is XLA's VJP
(`_squaring_step_bwd` takes its Pallas kernel only for 3 components,
warp_local.py:439-446), so a 2D `integrate_svf` is differentiated as
its plain version (`plain_vjp`); `csrc/squaring_bwd.cu` stays 3D.

The step takes each thread's voxel from a tile of the field
(`csrc/gather.cuh`) by the plan that `tile_plan` computes and the launch
passes in (`kernels/gather.py`).

Slab launches (the depth-sharded model, parallel/spatial.py):
`squaring_step(whole, z0=, depth=)` reads the whole field (all-gathered
along its first spatial axis: depth, or H of a 2D field) and writes
planes (2D: lines) z0 .. z0 + depth - 1 of the step, bit-equal to those
of the whole step (forward only in 2D, as the whole 2D step);
`squaring_step_cf(whole_cf, z0=, depth=)` the same on a channels-first
field (B, 3, zg, S1, S2) into a contiguous (B, 3, depth, S1, S2) slab
(the sharded full_res eval decode; forward only, as the whole CF step);
`squaring_step_bwd(whole, g_slab, z0)` takes the cotangent of a 3D
channels-last slab and returns its share of the whole field's cotangent
(the caller sums the shares over the slabs). The plain versions take
the same.

Layout: (B, *S, nd) channels-last float32 (nd = 3, or 2 in 2D); the CF
functions (B, 3, *S).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pulpo_tpu_torch.kernels import _build, gather, plain_vjp
from pulpo_tpu_torch.kernels.warp import (
    _factor,
    warp_dfgrad_plain,
    warp_mgrad_plain,
    warp_plain,
)

launches = 0      # kernel launches of `squaring_step` on 3D fields (one per step)
launches_2d = 0   # kernel launches of `squaring_step` on 2D fields (one per step)
bwd_launches = 0  # kernel launches of `squaring_step_bwd` (one per step)
cf_launches = 0   # kernel launches of `squaring_step_cf` (one per step)


def reset_count() -> None:
    global launches, launches_2d, bwd_launches, cf_launches
    launches = launches_2d = bwd_launches = cf_launches = 0


def squaring_step_plain(vec: torch.Tensor, z0: int = 0, depth: int | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``vec + warp(vec, vec)``; with
    `depth`, planes z0 .. z0 + depth - 1 of it (a slab launch's)."""
    if depth is None:
        return vec + warp_plain(vec, vec)
    part = vec[:, z0:z0 + depth]
    return part + warp_plain(vec, part, z0, vec.shape[1])


def squaring_step_bwd_plain(vec: torch.Tensor, g: torch.Tensor, z0: int = 0) -> torch.Tensor:
    """The backward kernel's plain version: the VJP of
    ``vec + warp(vec, vec)`` for cotangent g, written out as
    ``g + dfgrad(v, v, g) + mgrad(v, v, g)``. A g of fewer planes than vec
    is the cotangent of a slab from z0: the result is then that slab's
    share of the whole cotangent."""
    if g.shape[1] == vec.shape[1]:
        return (g.float() + warp_dfgrad_plain(vec, vec, g)
                + warp_mgrad_plain(vec.shape, vec, g))
    depth, zg = g.shape[1], vec.shape[1]
    part = vec[:, z0:z0 + depth]
    own = g.float() + warp_dfgrad_plain(vec, part, g, z0, zg)
    out = warp_mgrad_plain(vec.shape, part, g, z0, zg)
    out[:, z0:z0 + depth] = own + out[:, z0:z0 + depth]
    return out


def integrate_svf_plain(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling and squaring in plain PyTorch (pulpo_tpu/ops/warp.py:294-305)."""
    assert nsteps >= 0
    vec = vec * (1.0 / (2**nsteps))
    for _ in range(nsteps):
        vec = squaring_step_plain(vec)
    return vec


def _cl(vec_cf: torch.Tensor) -> torch.Tensor:
    return vec_cf.permute(0, 2, 3, 4, 1)


def _cf(vec: torch.Tensor) -> torch.Tensor:
    return vec.permute(0, 4, 1, 2, 3)


def squaring_step_cf_plain(vec_cf: torch.Tensor, z0: int = 0,
                           depth: int | None = None) -> torch.Tensor:
    """The CF kernel's plain version: the channels-last step on the same
    values (with `depth`, its slab from z0), returned as a (B, 3, *S)
    view."""
    return _cf(squaring_step_plain(_cl(vec_cf), z0, depth))


def integrate_svf_cf_plain(vec_cf: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling and squaring of a (B, 3, *S) field in plain PyTorch."""
    return _cf(integrate_svf_plain(_cl(vec_cf), nsteps))


def _check(vec: torch.Tensor, what: str, ndims: int = 3) -> None:
    if vec.dim() != ndims + 2 or vec.shape[-1] != ndims or vec.dtype != torch.float32:
        shape = ", ".join([f"S{i}" for i in range(ndims)] + [str(ndims)])
        raise ValueError(f"{what} takes (B, {shape}) float32, "
                         f"got {tuple(vec.shape)} {vec.dtype}")


def _factors(vec: torch.Tensor) -> list[float]:
    s = vec.shape[1:-1]
    return [_factor(s[i], s[i]) for i in range(len(s))]


def tile_plan(shape, cf: bool = False) -> dict:
    """The tile plan of the step's launch on a field of `shape`
    (channels-last, or channels-first with `cf`; `kernels/gather.py:
    squaring_plan`)."""
    spatial = tuple(shape[2:]) if cf else tuple(shape[1:-1])
    return gather.squaring_plan(spatial, shape[0])


def _launch_step(entry: str, vec: torch.Tensor, out, scale: float, cf: bool,
                 ndims: int = 3, z0: int = 0, depth: int | None = None) -> torch.Tensor:
    """One launch of C entry `entry` of the squaring library on a CUDA
    field of `ndims` spatial axes (channels-last, or channels-first with
    `cf`); with `depth`, the slab launch of planes z0 .. z0 + depth - 1."""
    _check(_cl(vec) if cf else vec, "squaring kernel", ndims)
    if math.prod(vec.shape[1:]) >= 2**31:
        raise ValueError(f"squaring kernel addresses a row in 32 bits, got {tuple(vec.shape)}")
    vec = vec.contiguous()
    shape = tuple(vec.shape)
    zaxis = 2 if cf else 1
    if depth is not None:
        if not 0 <= z0 <= vec.shape[zaxis] - depth:
            raise ValueError(f"a slab of {depth} planes from {z0} takes a field of at "
                             f"least {z0 + depth} planes, got {shape}")
        shape = (*shape[:zaxis], depth, *shape[zaxis + 1:])
    if out is None:
        out = vec.new_empty(shape)
    if tuple(out.shape) != shape or out.dtype != vec.dtype or not out.is_contiguous():
        raise ValueError("squaring kernel writes a contiguous float32 `out` "
                         f"of shape {shape}, got {tuple(out.shape)} {out.stride()}")
    cl = _cl(vec) if cf else vec
    fn = getattr(_build.load("squaring"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * (ndims + 1)
                   + [ctypes.c_float] * (ndims + 1) + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    sizes = list(cl.shape[1:-1])
    plan = tile_plan(vec.shape, cf)
    if depth is not None:
        plan = gather.slab(tile_plan(shape, cf), z0, vec.shape[zaxis])
        sizes[0] = depth
    with torch.cuda.device(vec.device):
        rc = fn(vec.data_ptr(), out.data_ptr(), cl.shape[0], *sizes, *_factors(cl),
                float(scale), gather.plan_arg(plan), _build.stream_ptr(vec))
    _build.check(rc, entry)
    return out


def squaring_step(vec: torch.Tensor, out: torch.Tensor | None = None,
                  scale: float = 1.0, z0: int = 0, depth: int | None = None) -> torch.Tensor:
    """One step ``v + warp(v, v)`` with ``v = scale * vec`` on a 3D
    (B, S0, S1, S2, 3) or 2D (B, S0, S1, 2) field: the CUDA kernel for a
    tensor on the card, the plain version on the CPU. `scale` must be a
    power of two (it is then exact). With `depth`, the slab launch: planes
    (in 2D lines) z0 .. z0 + depth - 1 of the step of the whole field
    `vec`."""
    if vec.device.type == "cpu":
        return squaring_step_plain(vec * scale if scale != 1.0 else vec, z0, depth)
    global launches, launches_2d
    if vec.dim() == 4:
        out = _launch_step("pulpo_squaring_step_2d", vec, out, scale, cf=False, ndims=2, z0=z0,
                           depth=depth)
        launches_2d += 1
        return out
    out = _launch_step("pulpo_squaring_step", vec, out, scale, cf=False, z0=z0, depth=depth)
    launches += 1
    return out


def squaring_step_cf(vec: torch.Tensor, out: torch.Tensor | None = None,
                     scale: float = 1.0, z0: int = 0, depth: int | None = None) -> torch.Tensor:
    """`squaring_step` on a channels-first field (B, 3, S0, S1, S2)
    float32: the CF kernel for a tensor on the card, the plain version on
    the CPU. Bit-equal to the channels-last kernel on the same field.
    With `depth`, the slab launch: planes z0 .. z0 + depth - 1 of the step
    of the whole field `vec`, as a (B, 3, depth, S1, S2) tensor."""
    if vec.device.type == "cpu":
        return squaring_step_cf_plain(vec * scale if scale != 1.0 else vec, z0, depth)
    global cf_launches
    out = _launch_step("pulpo_squaring_step_cf", vec, out, scale, cf=True, z0=z0, depth=depth)
    cf_launches += 1
    return out


def _integrate_kernel(step, vec: torch.Tensor, nsteps: int) -> torch.Tensor:
    """nsteps launches of `step` (`squaring_step` or `squaring_step_cf`),
    the 1/2**nsteps scale folded into the first, alternating two
    contiguous buffers."""
    vec = vec.contiguous()
    bufs = [torch.empty_like(vec, memory_format=torch.contiguous_format) for _ in range(2)]
    cur = step(vec, bufs[0], scale=1.0 / (2**nsteps))
    for k in range(1, nsteps):
        cur = step(cur, bufs[k % 2])
    return cur


def integrate_svf_cf(vec: torch.Tensor, nsteps: int = 7) -> torch.Tensor:
    """Scaling and squaring of a channels-first field (B, 3, S0, S1, S2)
    float32: the CF kernel on the card (a gradient through it is the plain
    version's), the plain version on the CPU. Returns a (B, 3, *S) tensor
    equal bit for bit to `integrate_svf` of the channels-last field."""
    assert nsteps >= 0
    if nsteps == 0:
        return vec.clone()
    if vec.device.type == "cpu":
        return integrate_svf_cf_plain(vec, nsteps)
    _check(_cl(vec), "CF squaring kernel")
    return plain_vjp.apply(lambda v: _integrate_kernel(squaring_step_cf, v, nsteps),
                           lambda v: integrate_svf_cf_plain(v, nsteps), vec)


def squaring_step_bwd(vec: torch.Tensor, g: torch.Tensor, z0: int = 0) -> torch.Tensor:
    """The VJP of one step at `vec` for cotangent g: the CUDA kernel
    (f32 atomics, so the summation order is not fixed) for tensors on
    the card, the plain version on the CPU. A g of fewer planes than vec
    is the cotangent of the slab launch from z0: the result (vec's shape)
    is then that slab's share of the whole cotangent."""
    if vec.device.type == "cpu":
        return squaring_step_bwd_plain(vec, g, z0)
    _check(vec, "squaring backward kernel")
    _check(g, "squaring backward kernel")
    depth = g.shape[1]
    if (g.shape[0] != vec.shape[0] or g.shape[2:] != vec.shape[2:]
            or not 0 <= z0 <= vec.shape[1] - depth or g.device != vec.device):
        raise ValueError(f"cotangent {tuple(g.shape)} on {g.device} is not planes {z0}.. of "
                         f"the field {tuple(vec.shape)} on {vec.device}")
    vec, g = vec.contiguous(), g.contiguous()
    out = torch.empty_like(vec, memory_format=torch.contiguous_format)
    b, s = vec.shape[0], (depth, *vec.shape[2:4])
    fn = _build.load("squaring_bwd").pulpo_squaring_step_bwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    plan = gather.plan_arg(gather.slab(gather.squaring_bwd_plan(s, b), z0, vec.shape[1]))
    global bwd_launches
    with torch.cuda.device(vec.device):
        rc = fn(vec.data_ptr(), g.data_ptr(), out.data_ptr(), b, *s, *_factors(vec), plan,
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
    (the reference VecInt), differentiable. vec: (B, *S, 3) float32, or
    a 2D (B, S0, S1, 2) field, whose gradient is the plain version's (as
    the JAX package's 2D backward is XLA's VJP)."""
    assert nsteps >= 0
    if nsteps == 0:
        return vec.clone()
    if vec.shape[-1] == 2:
        if vec.device.type == "cpu":
            return integrate_svf_plain(vec, nsteps)
        _check(vec, "2D squaring kernel", ndims=2)
        return plain_vjp.apply(lambda v: _integrate_kernel(squaring_step, v, nsteps),
                               lambda v: integrate_svf_plain(v, nsteps), vec)
    if vec.device.type != "cpu":
        _check(vec, "squaring kernel")
    return IntegrateSVF.apply(vec, nsteps)
