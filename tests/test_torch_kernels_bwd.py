"""The backward kernels' plain versions against the JAX package, on the CPU.

On the CPU each wrapper runs its plain version. Those are held against
the XLA VJP of `pulpo_tpu.ops.warp.warp_image` (any displacement, any
resolution, sample-tiled rows) and against the Pallas kernels they
replace, in interpret mode, inside each kernel's halo bound. The
autograd Functions (`Warp`, `IntegrateSVF`, `BoxSum`) are checked
against central differences. The CUDA kernels against their plain
versions: tests/test_torch_gpu.py.

Tolerances (float32): against the XLA VJP and the Pallas kernels rtol
1e-5 / atol 1e-5 (the same terms, summed in another order); against
central differences 1e-3 of the derivative's scale (the difference
quotient's own rounding and curvature).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu_torch.kernels import box_sum, squaring, warp
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return v * (mag / np.abs(v).max())


def _jax_warp_vjp(m, d, g):
    from pulpo_tpu.ops.warp import warp_image

    _, vjp = jax.vjp(warp_image, jnp.asarray(m), jnp.asarray(d))
    gm, gd = vjp(jnp.asarray(g))
    return np.asarray(gm), np.asarray(gd)


# ----------------------------------------------------------------------
# warp cotangents vs the XLA VJP of ops/warp.warp_image
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["same", "sample_tiled", "cross_res", "odd"])
def test_warp_cotangents_plain_match_jax_vjp(case):
    """Both cotangents at displacements past any halo (the XLA gather's
    VJP is exact everywhere): equal rows, B_df = 2B sample-tiled rows
    (the moving cotangent sums the rows that share a moving row), a
    full-res moving image under a level-res df, and odd sizes."""
    rng = np.random.default_rng(1)
    mov_shape, df_shape = {
        "same": ((2, 16, 20, 24, 3), (2, 16, 20, 24, 3)),
        "sample_tiled": ((2, 16, 20, 24, 1), (4, 16, 20, 24, 3)),
        "cross_res": ((1, 16, 20, 24, 1), (2, 8, 10, 12, 3)),
        "odd": ((1, 15, 18, 21, 2), (2, 15, 18, 21, 3)),
    }[case]
    m = rng.random(mov_shape, dtype=np.float32)
    d = _field(df_shape, 4.0, 2)
    g = rng.standard_normal((*df_shape[:-1], mov_shape[-1])).astype(np.float32)
    ref_m, ref_d = _jax_warp_vjp(m, d, g)
    tm, td, tg = (torch.from_numpy(a) for a in (m, d, g))
    np.testing.assert_allclose(warp.warp_dfgrad(tm, td, tg).numpy(), ref_d, **TOL)
    np.testing.assert_allclose(warp.warp_mgrad(tm.shape, td, tg).numpy(), ref_m, **TOL)


def test_warp_dfgrad_plain_matches_pallas_within_halo():
    from pulpo_tpu.kernels.warp_halo import _warp_halo_dfgrad_pallas, halo_bound_ok

    rng = np.random.default_rng(3)
    m = rng.random((2, 8, 10, 12, 2), dtype=np.float32)
    d = _field((4, 8, 10, 12, 3), 1.5, 4)  # sample-tiled rows
    g = rng.standard_normal((4, 8, 10, 12, 2)).astype(np.float32)
    assert bool(halo_bound_ok(jnp.asarray(d), 2))
    ref = _warp_halo_dfgrad_pallas(jnp.asarray(m), jnp.asarray(d), jnp.asarray(g), 2,
                                   interpret=True)
    got = warp.warp_dfgrad(*(torch.from_numpy(a) for a in (m, d, g)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_warp_dfgrad_plain_matches_pallas_at_36_channels():
    """The one-hot segmentation maps' width (C = 36, the OASIS path's), 2
    df rows reading one map, within the halo."""
    from pulpo_tpu.kernels.warp_halo import _warp_halo_dfgrad_pallas, halo_bound_ok

    rng = np.random.default_rng(11)
    m = np.eye(36, dtype=np.float32)[rng.integers(0, 36, (1, 8, 8, 8))]
    d = _field((2, 8, 8, 8, 3), 1.5, 12)
    g = rng.standard_normal((2, 8, 8, 8, 36)).astype(np.float32)
    assert bool(halo_bound_ok(jnp.asarray(d), 2))
    ref = _warp_halo_dfgrad_pallas(jnp.asarray(m), jnp.asarray(d), jnp.asarray(g), 2,
                                   interpret=True)
    got = warp.warp_dfgrad(*(torch.from_numpy(a) for a in (m, d, g)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_warp_mgrad_plain_matches_pallas_within_halo():
    from pulpo_tpu.kernels.warp_halo import _warp_halo_mgrad_pallas, halo_bound_ok

    rng = np.random.default_rng(5)
    d = _field((2, 8, 10, 12, 3), 1.5, 6)
    g = rng.standard_normal((2, 8, 10, 12, 3)).astype(np.float32)
    assert bool(halo_bound_ok(jnp.asarray(d), 2))
    ref = _warp_halo_mgrad_pallas(jnp.asarray(d), jnp.asarray(g), 2, interpret=True)
    got = warp.warp_mgrad((2, 8, 10, 12, 3), torch.from_numpy(d), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------------------
# squaring step backward vs kernels/warp_local.py
# ----------------------------------------------------------------------

def test_squaring_bwd_plain_matches_pallas_subvoxel():
    """Within the 27-tap stencil's bound: _squaring_step_bwd_pallas."""
    from pulpo_tpu.kernels.warp_local import _squaring_step_bwd_pallas, local_bound

    shape = (2, 8, 9, 11, 3)
    v = _field(shape, 0.999 * local_bound(shape[1:-1]), 7)
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    ref = _squaring_step_bwd_pallas(jnp.asarray(v), jnp.asarray(g), interpret=True)
    got = squaring.squaring_step_bwd(torch.from_numpy(v), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mag", [1.2, 5.0])
def test_squaring_bwd_plain_matches_xla_vjp_above_bound(mag):
    """Past the bound: the VJP of the XLA step (what the tiered backward's
    cascades compute exactly)."""
    from pulpo_tpu.kernels.warp_local import _squaring_step_xla

    shape = (1, 15, 18, 21, 3)
    v = _field(shape, mag, 9)
    g = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(_squaring_step_xla, jnp.asarray(v))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    got = squaring.squaring_step_bwd(torch.from_numpy(v), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_integrate_svf_backward_matches_jax_vjp():
    """The whole 7-step integration's VJP (IntegrateSVF.backward running
    the steps' backward in reverse) against jax.vjp of the JAX package's
    integrate_svf. The cotangent grows through the steps; tolerance
    1e-5 of its scale."""
    from pulpo_tpu.ops.warp import integrate_svf as jax_integrate

    shape = (2, 8, 10, 12, 3)
    v = _field(shape, 6.0, 11)
    g = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_integrate(a, nsteps=7), jnp.asarray(v))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    tv = torch.from_numpy(v).requires_grad_(True)
    out = squaring.integrate_svf(tv, 7)
    (got,) = torch.autograd.grad(out, tv, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ----------------------------------------------------------------------
# box sum vs kernels/box_sum.py
# ----------------------------------------------------------------------

@pytest.mark.parametrize("win", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(2, 16, 20, 24), (1, 15, 18, 21)])
def test_box_sum_plain_matches_pallas_and_xla(shape, win):
    from pulpo_tpu.kernels.box_sum import _box_sum_xla, box_sum_nd

    x = np.random.default_rng(win).standard_normal(shape).astype(np.float32)
    got = box_sum.box_sum(torch.from_numpy(x), win).numpy()
    scale = np.abs(got).max()
    np.testing.assert_allclose(got, np.asarray(box_sum_nd(jnp.asarray(x), win,
                                                          impl="interpret")),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, np.asarray(_box_sum_xla(jnp.asarray(x), win)),
                               rtol=0, atol=1e-5 * scale)


# ----------------------------------------------------------------------
# the autograd Functions against central differences
# ----------------------------------------------------------------------

def _directional_check(fn, x, seed, h):
    """<grad of sum(c * fn(x)), u> against the central difference of
    sum(c * fn(x + t u)) at t = +-h, for random c and u."""
    rng = np.random.default_rng(seed)
    x = x.detach().requires_grad_(True)
    out = fn(x)
    c = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32))
    (grad,) = torch.autograd.grad((out * c).sum(), x)
    with torch.no_grad():
        lo = (fn(x - h * u).double() * c).sum()
        hi = (fn(x + h * u).double() * c).sum()
    fd = float((hi - lo) / (2 * h))
    an = float((grad.double() * u).sum())
    scale = float((grad.double().abs() * u.abs()).sum())
    assert abs(fd - an) <= 1e-3 * scale, (fd, an, scale)


def _interior_df(df_shape, in_spatial, seed):
    """A df whose source coordinates sit in [0.3, 0.7] of a voxel cell,
    inside the volume: no clamp ties, no voxel boundaries within reach
    of a small step."""
    rng = np.random.default_rng(seed)
    out_spatial = df_shape[1:-1]
    d = np.empty(df_shape, np.float32)
    for a, (s_out, s_in) in enumerate(zip(out_spatial, in_spatial)):
        src = rng.integers(0, s_in - 1, df_shape[:-1]) + rng.uniform(0.3, 0.7, df_shape[:-1])
        grid = np.arange(s_out).reshape([-1 if i == a else 1 for i in range(3)])
        d[..., a] = (src + 0.5) / (s_in / (s_out - 1)) - grid
    return d


@pytest.mark.parametrize("wrt", ["df", "moving"])
def test_warp_function_backward_central_difference(wrt):
    rng = np.random.default_rng(13)
    m = torch.from_numpy(rng.random((2, 9, 10, 11, 2), dtype=np.float32))
    d = torch.from_numpy(_interior_df((4, 9, 10, 11, 3), (9, 10, 11), 14))
    if wrt == "df":
        _directional_check(lambda a: warp.warp(m, a), d, 15, h=1e-2)
    else:
        _directional_check(lambda a: warp.warp(a, d), m, 16, h=1e-1)


def test_integrate_svf_function_backward_central_difference():
    """A smooth field: the kinks where a source coordinate crosses a
    voxel boundary are small against the step."""
    import torch.nn.functional as F

    coarse = torch.from_numpy(np.random.default_rng(17).standard_normal((1, 3, 3, 3, 3))
                              .astype(np.float32))
    v = F.interpolate(coarse, size=(10, 11, 12), mode="trilinear", align_corners=True)
    v = (v / v.abs().max() * 3.0).permute(0, 2, 3, 4, 1).contiguous()
    _directional_check(lambda a: squaring.integrate_svf(a, 7), v, 18, h=1e-3)


def test_box_sum_function_backward_central_difference():
    x = torch.from_numpy(np.random.default_rng(19).standard_normal((2, 9, 10, 11))
                         .astype(np.float32))
    _directional_check(lambda a: box_sum.box_sum(a, 5), x, 20, h=1e-1)


def test_cpu_backward_wrappers_count_nothing():
    warp.reset_count()
    squaring.reset_count()
    box_sum.reset_count()
    v = torch.from_numpy(_field((1, 6, 7, 8, 3), 2.0, 21)).requires_grad_(True)
    out = squaring.integrate_svf(v, 7)
    img = warp.warp(v[..., :1], out)
    box_sum.box_sum(img[..., 0], 3).sum().backward()
    assert v.grad is not None and bool(torch.isfinite(v.grad).all())
    counts = (warp.launches, warp.dfgrad_launches, warp.mgrad_launches,
              squaring.launches, squaring.bwd_launches, box_sum.launches)
    assert counts == (0,) * 6
