"""The port's warp family against the JAX package's coarse-offset tier,
on the CPU, at LungCT-scale displacements.

`pulpo_tpu/kernels/warp_halo.py:_warp_halo_coarse_pallas` (the TPU
kernel closed by `csrc/warp.cu`) subtracts per-slab integer offsets so
that a fixed stencil covers shifts of tens of voxels; every branch of
`warp_coarse_tier` computes `warp_image`. The port's warp is a gather,
exact at any displacement, so its plain version (what the CUDA kernel
is held to on the card) must equal the coarse tier, in interpret mode,
at shifts up to 20 voxels. The backward passes (`Warp`, `IntegrateSVF`)
are held against the JAX VJPs at large displacement, where the JAX
package itself has no coarse backward and takes the XLA VJP.

Inputs come from numpy seeds. Tolerance: 1e-5 of the reference's scale
(at least 1): the same terms, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.kernels import warp_halo
from pulpo_tpu.ops.warp import integrate_svf as jax_integrate_svf
from pulpo_tpu.ops.warp import warp_image as jax_warp_image
from pulpo_tpu_torch.kernels import squaring, warp

HALO = 3


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _large_field(b_df, shape, amp, seed):
    """The smooth large field of tests/test_kernels.py:TestWarpCoarse,
    with numpy noise: amplitudes `amp`, 0.8 amp and 0.9 amp along the
    three axes."""
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 2 * np.pi, s) for s in shape), indexing="ij")
    df = np.stack([amp * np.sin(0.5 * zz + 0.3) * np.cos(0.4 * yy),
                   0.8 * amp * np.cos(0.6 * xx) * np.sin(0.5 * zz),
                   -0.9 * amp * np.sin(0.4 * yy + 1.0)], -1)[None]
    noise = np.random.default_rng(seed).standard_normal((b_df, *shape, 3))
    return (np.tile(df, (b_df, 1, 1, 1, 1)) + 0.3 * noise).astype(np.float32)


def _moving(b, shape, seed):
    return np.random.default_rng(seed).standard_normal((b, *shape, 1)).astype(np.float32)


@jax.jit
def _coarse_tier(m, d):
    return warp_halo.warp_coarse_tier(m, d, HALO, interpret=True)


@pytest.mark.parametrize("amp", [6.0, 12.0, 20.0])
def test_warp_matches_the_coarse_tier(amp):
    shape = (16, 24, 28)
    m, d = _moving(1, shape, 1), _large_field(2, shape, amp, 2)
    assert np.abs(d).max() > 0.8 * amp
    ref = _coarse_tier(jnp.asarray(m), jnp.asarray(d))
    got = warp.warp(torch.from_numpy(m), torch.from_numpy(d))
    _close(got.numpy(), ref)


def test_warp_matches_the_coarse_kernel_on_a_pure_shift():
    """A 6-voxel z shift, twice the stencil's halo: the per-slab offsets
    absorb it (empty bad mask), so the Pallas kernel alone is exact."""
    shape = (16, 24, 28)
    m = _moving(1, shape, 4)
    d = np.zeros((1, *shape, 3), np.float32)
    d[..., 0] = 6.0
    s0, s1, s2 = shape
    taps = 2 * HALO + 2
    up = warp_halo._round_up
    s1p, s2p = up(s1 + taps - 1, 8), up(s2 + taps - 1, 128)
    bz = warp_halo._halo_bz(s0, s1, s2, taps, 1, s1p, s2p, up(s1, 8), up(s2, 128))
    jd = jnp.asarray(d)
    cz, cyx = warp_halo.coarse_offsets(jd, 1, bz)
    assert int(jnp.max(jnp.abs(cz))) >= 5
    assert not bool(jnp.any(warp_halo.coarse_bad_mask(jd, HALO, cz, cyx, 1, bz)))
    ref = warp_halo._warp_halo_coarse_pallas(jnp.asarray(m), jd, HALO, cz, cyx, interpret=True)
    got = warp.warp(torch.from_numpy(m), torch.from_numpy(d))
    _close(got.numpy(), ref)
    _close(got.numpy(), jax_warp_image(jnp.asarray(m), jd))


def test_warp_matches_the_coarse_tier_with_sample_tiled_rows():
    """b_df = 3 b: df row r reads moving row r % b."""
    shape = (8, 16, 20)
    m, d = _moving(2, shape, 5), _large_field(6, shape, 8.0, 6)
    ref = _coarse_tier(jnp.asarray(m), jnp.asarray(d))
    got = warp.warp(torch.from_numpy(m), torch.from_numpy(d))
    _close(got.numpy(), ref)


def test_warp_backward_matches_the_jax_vjp_at_large_displacement():
    """Both cotangents of the `Warp` Function against jax.vjp of
    `warp_image` (the XLA VJP the JAX package takes past its stencils)."""
    shape = (16, 24, 28)
    m, d = _moving(1, shape, 7), _large_field(2, shape, 12.0, 8)
    cot = np.random.default_rng(9).standard_normal((2, *shape, 1)).astype(np.float32)
    out, vjp = jax.vjp(jax_warp_image, jnp.asarray(m), jnp.asarray(d))
    ref_m, ref_d = vjp(jnp.asarray(cot))
    tm, td = (torch.from_numpy(a).requires_grad_(True) for a in (m, d))
    got = warp.warp(tm, td)
    got_m, got_d = torch.autograd.grad(got, (tm, td), torch.from_numpy(cot))
    _close(got.detach().numpy(), out)
    _close(got_m.numpy(), ref_m)
    _close(got_d.numpy(), ref_d)


def test_integrate_svf_matches_jax_at_large_displacement():
    """`IntegrateSVF` forward and backward against JAX's `integrate_svf`
    on an SVF that integrates to about 10 voxels."""
    shape = (16, 20, 24)
    v = _large_field(1, shape, 10.0, 10) * 0.9
    cot = np.random.default_rng(11).standard_normal((1, *shape, 3)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jax_integrate_svf(a, 7), jnp.asarray(v))
    (ref_v,) = vjp(jnp.asarray(cot))
    assert float(jnp.abs(out).max()) > 8.0
    tv = torch.from_numpy(v).requires_grad_(True)
    got = squaring.integrate_svf(tv, 7)
    (got_v,) = torch.autograd.grad(got, tv, torch.from_numpy(cot))
    _close(got.detach().numpy(), out)
    _close(got_v.numpy(), ref_v)
