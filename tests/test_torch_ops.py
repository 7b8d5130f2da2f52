"""The port's ops (pulpo_tpu_torch/ops) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: atol 1e-5 (float32; the two sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.ops import resize as jresize
from pulpo_tpu.ops import warp as jwarp
from pulpo_tpu_torch.ops import resize as presize
from pulpo_tpu_torch.ops import warp as pwarp
from test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _close(got: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("shape,out", [
    ((2, 7, 9, 11, 3), (14, 18, 22)),    # upsample, odd sizes
    ((1, 15, 18, 21, 2), (8, 9, 11)),    # downsample, odd sizes
    ((1, 8, 10, 12, 4), (8, 17, 5)),     # mixed, one axis unchanged
])
def test_resize_linear_matches_jax(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _close(presize.resize_linear(torch.from_numpy(x), out),
           jresize.resize_linear(jnp.asarray(x), out))


@pytest.mark.parametrize("shape", [(2, 8, 10, 12, 3), (1, 15, 7, 9, 1)])
def test_avg_pool_ceil_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    _close(presize.avg_pool_ceil(torch.from_numpy(x)), jresize.avg_pool_ceil(jnp.asarray(x)))


@pytest.mark.parametrize("in_size,out_size", [
    ((8, 9, 11), (15, 18, 21)),   # factor > 1 from axis 0 (15/8), odd sizes
    ((15, 18, 21), (8, 9, 11)),   # factor < 1 from axis 0 (8/15)
    ((5, 6, 7), (10, 12, 14)),    # factor 2
])
def test_resize_vecfield_matches_jax(in_size, out_size):
    """The factor of every axis is the one derived from axis 0, as the
    callers pass it, not out/in per axis."""
    x = np.random.default_rng(2).standard_normal((2, *in_size, 3)).astype(np.float32)
    vel_resize = 1.0 / (out_size[0] / in_size[0])
    got = pwarp.resize_vecfield(torch.from_numpy(x), vel_resize, out_size=out_size)
    ref = jwarp.resize_vecfield(jnp.asarray(x), vel_resize, out_size=out_size)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)


@pytest.mark.parametrize("mag", [0.5, 20.0])
def test_integrate_svf_matches_jax(mag):
    v = np.random.default_rng(3).uniform(-mag, mag, (2, 9, 10, 11, 3)).astype(np.float32)
    ref = jwarp.integrate_svf(jnp.asarray(v), nsteps=7)
    # large fields: early-step rounding noise doubles per squaring step
    _close(pwarp.integrate_svf(torch.from_numpy(v), nsteps=7), ref,
           atol=ATOL * max(1.0, float(np.abs(np.asarray(ref)).max())))


@pytest.mark.parametrize("moving_shape,df_shape", [
    ((2, 9, 10, 11, 1), (2, 9, 10, 11, 3)),   # same resolution
    ((2, 9, 10, 11, 2), (6, 9, 10, 11, 3)),   # sample-tiled rows: r reads r % 2
    ((1, 15, 18, 21, 1), (3, 8, 9, 11, 3)),   # cross-resolution
])
def test_warp_image_matches_jax(moving_shape, df_shape):
    rng = np.random.default_rng(4)
    m = rng.random(moving_shape, dtype=np.float32)
    d = rng.uniform(-4, 4, df_shape).astype(np.float32)
    _close(pwarp.warp_image(torch.from_numpy(m), torch.from_numpy(d)),
           jwarp.warp_image(jnp.asarray(m), jnp.asarray(d)))


def test_batched_level_warp_matches_per_level():
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.random((2, 8, 9, 10, 1), dtype=np.float32))
    dfs = {l: torch.from_numpy(rng.uniform(-2, 2, (2, 8, 9, 10, 3)).astype(np.float32))
           for l in range(3)}
    got = pwarp.batched_level_warp(m, dfs)
    for l in dfs:
        _close(got[l], pwarp.warp_image(m, dfs[l]).numpy(), atol=0)


def test_warp_landmarks_matches_jax():
    rng = np.random.default_rng(6)
    df = rng.uniform(-3, 3, (2, 9, 10, 11, 3)).astype(np.float32)
    lm = np.stack([rng.uniform(0, s - 1, (2, 5)) for s in (9, 10, 11)], -1).astype(np.float32)
    got = pwarp.warp_landmarks(torch.from_numpy(lm), torch.from_numpy(df))
    _close(got, jwarp.warp_landmarks(jnp.asarray(lm), jnp.asarray(df)))
