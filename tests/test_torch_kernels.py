"""The port's kernels' plain versions against the Pallas kernels, on the CPU.

On the CPU each wrapper runs its plain version; those are held against
the JAX package's Pallas kernels in interpret mode (or, past a
kernel's displacement bound, against what the JAX package runs there).
The CUDA kernels against their plain versions: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu_torch.kernels import squaring, vel_head, warp
from test_torch_threads import one_torch_thread  # noqa: F401


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return v * (mag / np.abs(v).max())


# ----------------------------------------------------------------------
# squaring step vs kernels/warp_local.py
# ----------------------------------------------------------------------

def test_squaring_plain_matches_pallas_subvoxel():
    """Within the 27-tap stencil's bound (max|v| <= local_bound)."""
    from pulpo_tpu.kernels.warp_local import _squaring_step_pallas, local_bound

    shape = (2, 8, 9, 11, 3)
    v = _field(shape, 0.999 * local_bound(shape[1:-1]), 0)
    ref = _squaring_step_pallas(jnp.asarray(v), interpret=True)
    got = squaring.squaring_step(torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mag", [1.2, 4.0])
def test_squaring_plain_matches_tiered_above_bound(mag):
    """Past the bound: the halo-tier cascade (or its gather fallback)."""
    from pulpo_tpu.kernels.warp_local import _squaring_step_tiered

    v = _field((1, 20, 24, 28, 3), mag, 11)  # >= MIN_PALLAS_VOXELS
    ref = _squaring_step_tiered(jnp.asarray(v), interpret=True)
    got = squaring.squaring_step(torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_squaring_scale_is_folded_exactly():
    v = torch.from_numpy(_field((1, 6, 7, 8, 3), 30.0, 2))
    got = squaring.squaring_step(v, scale=1.0 / 128)
    ref = squaring.squaring_step_plain(v * (1.0 / 128))
    assert torch.equal(got, ref)


# ----------------------------------------------------------------------
# dense warp vs kernels/warp_halo.py and ops/warp.warp_image
# ----------------------------------------------------------------------

def test_warp_plain_matches_halo_kernel_within_halo():
    from pulpo_tpu.kernels.warp_halo import _warp_halo_pallas, halo_bound_ok

    rng = np.random.default_rng(3)
    m = rng.random((2, 8, 10, 12, 2), dtype=np.float32)
    d = _field((4, 8, 10, 12, 3), 1.5, 4)  # 4 df rows: sample-tiled
    assert bool(halo_bound_ok(jnp.asarray(d), 2))
    ref = _warp_halo_pallas(jnp.asarray(m), jnp.asarray(d), 2, interpret=True)
    got = warp.warp(torch.from_numpy(m), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_warp_plain_matches_halo_kernel_at_36_channels():
    """The one-hot segmentation maps' width (C = 36, the OASIS path's), 2
    df rows reading one map, within the halo."""
    from pulpo_tpu.kernels.warp_halo import _warp_halo_pallas, halo_bound_ok

    labels = np.random.default_rng(9).integers(0, 36, (1, 8, 8, 8))
    m = np.eye(36, dtype=np.float32)[labels]
    d = _field((2, 8, 8, 8, 3), 1.5, 10)
    assert bool(halo_bound_ok(jnp.asarray(d), 2))
    ref = _warp_halo_pallas(jnp.asarray(m), jnp.asarray(d), 2, interpret=True)
    got = warp.warp(torch.from_numpy(m), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_warp_plain_matches_cascade_beyond_halo():
    """Displacements past every halo tier: the cascade's repair and
    gather branches, and ops/warp.warp_image, agree with the plain warp."""
    from pulpo_tpu.kernels.warp_halo import warp_cascaded
    from pulpo_tpu.ops.warp import warp_image

    rng = np.random.default_rng(5)
    m = rng.random((1, 8, 10, 12, 1), dtype=np.float32)
    d = _field((3, 8, 10, 12, 3), 6.0, 6)
    got = warp.warp(torch.from_numpy(m), torch.from_numpy(d)).numpy()
    ref = warp_cascaded(jnp.asarray(m), jnp.asarray(d), halos=(2, 3), interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(warp_image(jnp.asarray(m), jnp.asarray(d))),
                               rtol=1e-5, atol=1e-6)


def test_warp_plain_cross_resolution_matches_jax():
    from pulpo_tpu.ops.warp import warp_image

    rng = np.random.default_rng(7)
    m = rng.random((2, 15, 18, 21, 1), dtype=np.float32)
    d = _field((4, 8, 9, 11, 3), 3.0, 8)
    got = warp.warp(torch.from_numpy(m), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(warp_image(jnp.asarray(m), jnp.asarray(d))),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# velocity head vs kernels/vel_head.py
# ----------------------------------------------------------------------

def _head_params(n0=8, zdim=3, seed=21):
    """(JAX-layout params, port-layout params) from one numpy draw."""
    rng = np.random.default_rng(seed)
    r = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    j = {
        "k1": r((3, 3, 3, zdim, n0), 0.3), "b1": r((n0,), 0.1),
        "mean1": r((n0,), 0.5), "var1": np.abs(r((n0,))) + 0.1,
        "scale1": r((n0,)) + 1.0, "bias1": r((n0,), 0.2),
        "k2": r((3, 3, 3, n0, n0), 0.2), "b2": r((n0,), 0.1),
        "mean2": r((n0,), 0.5), "var2": np.abs(r((n0,))) + 0.1,
        "scale2": r((n0,)) + 1.0, "bias2": r((n0,), 0.2),
        "k3": r((1, 1, 1, n0, 3), 0.5), "b3": r((3,), 0.1),
    }
    p = {k: torch.from_numpy(np.transpose(v, (4, 3, 0, 1, 2)).copy() if v.ndim == 5 else v)
         for k, v in j.items()}
    return {k: jnp.asarray(v) for k, v in j.items()}, p


def test_vel_head_plain_matches_pallas_f32():
    from pulpo_tpu.kernels.vel_head import velocity_head_fused

    jp, p = _head_params()
    z = np.random.default_rng(1).standard_normal((2, 16, 10, 12, 3)).astype(np.float32)
    ref = velocity_head_fused(jnp.asarray(z), jp, interpret=True)
    got = vel_head.velocity_head(torch.from_numpy(z), p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=3e-5)


def test_vel_head_plain_matches_pallas_bf16():
    """bf16: the two sum in other orders, so an intermediate may round the
    other way; tolerance 2% of the output scale (a few bf16 ulps)."""
    from pulpo_tpu.kernels.vel_head import velocity_head_fused

    jp, p = _head_params(n0=16, seed=22)
    z = np.random.default_rng(2).standard_normal((1, 8, 20, 24, 3)).astype(np.float32)
    zj = jnp.asarray(z, jnp.bfloat16)
    ref = np.asarray(velocity_head_fused(zj, jp, interpret=True), np.float32)
    zt = torch.from_numpy(np.asarray(zj.astype(jnp.float32))).to(torch.bfloat16)
    got = vel_head.velocity_head(zt, p)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert err.max() <= 0.02 * np.abs(ref).max(), err.max()


def test_vel_head_rejects_widths_the_kernel_does_not_take():
    _, p = _head_params(n0=8, zdim=3)
    z = torch.zeros((1, 4, 4, 4, 5))  # zdim 5 > MAX_ZDIM, wrong for k1 too
    with pytest.raises(ValueError):
        vel_head._check(z, p)
    wide = dict(p, k1=torch.zeros(80, 3, 3, 3, 3))
    with pytest.raises(ValueError):
        vel_head._check(torch.zeros((1, 4, 4, 4, 3)), wide)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    for mod in (warp, squaring, vel_head):
        mod.reset_count()
    v = torch.from_numpy(_field((1, 6, 7, 8, 3), 2.0, 9))
    squaring.integrate_svf(v)
    warp.warp(v[..., :1].contiguous(), v)
    vel_head.velocity_head(v, _head_params()[1])
    assert (warp.launches, squaring.launches, vel_head.launches) == (0, 0, 0)

