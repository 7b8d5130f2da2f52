"""The port's N-sample UQ against the JAX package's, on the CPU.

The JAX draws (`jax.random.normal(fold_in(key_i, l), ...)` per sample
i and level l, from `jax.random.split(rng, N)`) are made in the test
and injected into the port, so every UQResult leaf can be compared.
Tolerance atol 1e-4 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.uq.predict import predict_with_uncertainty as jax_uq
from pulpo_tpu_torch.uq.predict import UQResult, auto_chunk, predict_with_uncertainty
from test_torch_model import jax_model_and_variables, port_model
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4)


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    shape = (1, *KW["input_size"], 1)
    return rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)


def comparable(field, a):
    """A leaf as compared: the entropy is the log of the variance, so it
    is compared through the variance it encodes, exp(2H) = 2*pi*e*var +
    1e-12 (an absolute error of the log is a relative error of the
    variance, large where the variance is near 0)."""
    a = np.asarray(a)
    return np.exp(2 * a) if field == "output_entropy" else a


def jax_noise(cfg, rng, N, batch):
    keys = jax.random.split(rng, N)
    return {l: np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k, l), (batch, *cfg.level_sizes[l], cfg.zdim), jnp.float32))
        for k in keys]) for l in range(cfg.latent_levels)}


def test_uq_matches_jax_leaf_by_leaf():
    jm, variables = jax_model_and_variables(seed=1, **KW)
    model = port_model(variables, **KW)
    x, y = _pair()
    lm = np.array([[[3.0, 4.0, 5.0], [10.5, 12.0, 20.0]]], np.float32)
    rng = jax.random.key(9)
    N = 4
    ref = jax_uq(jm, variables, jnp.asarray(x), jnp.asarray(y), N, rng, chunk=2,
                 keep_samples=True, lm=jnp.asarray(lm))
    noise = {l: torch.from_numpy(v) for l, v in jax_noise(jm.cfg, rng, N, 1).items()}
    got = predict_with_uncertainty(model, x, y, N, chunk=2, keep_samples=True,
                                   lm=lm, noise=noise)
    for field in UQResult._fields:
        r, g = getattr(ref, field), getattr(got, field)
        if field == "sample_landmarks":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)
            continue
        assert sorted(r) == sorted(g), field
        for l in r:
            np.testing.assert_allclose(comparable(field, g[l].numpy()), comparable(field, r[l]),
                                       rtol=0, atol=1e-4, err_msg=f"{field}[{l}]")


def test_uq_mask_matches_jax():
    jm, variables = jax_model_and_variables(seed=2, **KW)
    model = port_model(variables, **KW)
    x, y = _pair(1)
    mask = (x > 0.5).astype(np.float32)
    rng = jax.random.key(3)
    ref = jax_uq(jm, variables, jnp.asarray(x), jnp.asarray(y), 2, rng, mask=jnp.asarray(mask))
    noise = {l: torch.from_numpy(v) for l, v in jax_noise(jm.cfg, rng, 2, 1).items()}
    got = predict_with_uncertainty(model, x, y, 2, mask=mask, noise=noise)
    for l in ref.final_df_std:
        np.testing.assert_allclose(got.final_df_std[l].numpy(), np.asarray(ref.final_df_std[l]),
                                   rtol=0, atol=1e-4)


def test_uq_does_not_depend_on_chunk():
    """The port's own draws depend only on (seed, sample, level)."""
    _, variables = jax_model_and_variables(seed=4, **KW)
    model = port_model(variables, **KW)
    x, y = _pair(2)
    a = predict_with_uncertainty(model, x, y, 4, seed=5, chunk=1, keep_samples=True)
    b = predict_with_uncertainty(model, x, y, 4, seed=5, chunk=4, keep_samples=True)
    for field in UQResult._fields:
        da, db = getattr(a, field), getattr(b, field)
        if da is None:
            assert db is None
            continue
        for l in da:
            va, vb = da[l], db[l]
            if field == "outputs":  # first chunk only: 1 sample vs 4
                vb = vb[:, :1]
            np.testing.assert_allclose(comparable(field, va.numpy()),
                                       comparable(field, vb.numpy()), rtol=0, atol=1e-5,
                                       err_msg=f"{field}[{l}]")
    c = predict_with_uncertainty(model, x, y, 4, seed=6, chunk=2)
    assert not torch.equal(c.output_std[0], a.output_std[0])


@pytest.mark.parametrize("per_sample,budget,retained,expect", [
    (10, 1000, 0, 32),    # everything fits
    (10, 105, 0, 8),      # cap 10 -> largest divisor of 32 below it
    (10, 105, 60, 4),     # retention comes off the top
    (10, 5, 0, 1),        # never below one
])
def test_auto_chunk_divides_and_fits(per_sample, budget, retained, expect):
    assert auto_chunk(32, per_sample, budget, retained) == expect


def test_uq_rejects_a_chunk_that_does_not_divide():
    model = port_model(jax_model_and_variables(**KW)[1], **KW)
    x, y = _pair()
    with pytest.raises(ValueError):
        predict_with_uncertainty(model, x, y, 4, chunk=3)
