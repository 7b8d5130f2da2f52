"""The port's ingest (data/ingest.py) on the CPU against
pulpo_tpu.data.ingest on the same batches: z-normalisation batched and
unbatched, min-max, the fixed divisor and a resample, each within 1e-6
of the result's scale (the outputs lie in [0, 1], or are the input over
the divisor)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.data import ingest as jax_ingest
from pulpo_tpu_torch.data import ingest
from test_torch_threads import one_torch_thread  # noqa: F401


def _raw(shape, seed=0):
    """Raw scanner-like intensities: gamma-distributed, a few outliers."""
    rng = np.random.default_rng(seed)
    a = rng.gamma(2.0, 150.0, shape).astype(np.float32)
    a.reshape(-1)[:: max(1, a.size // 7)] *= 40.0
    return a


def _close(got: torch.Tensor, ref, what):
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= 1e-6 * scale, (what, err, scale)


@pytest.mark.parametrize("shape", [(2, 10, 12, 14, 1), (3, 9, 8, 7), (10, 12, 14)],
                         ids=["batched-channel", "batched", "unbatched"])
def test_znorm_clip_minmax(shape):
    raw = _raw(shape)
    for clip in (6.0, 2.5):
        got = ingest.znorm_clip_minmax(torch.from_numpy(raw), clip=clip)
        _close(got, jax_ingest.znorm_clip_minmax(jnp.asarray(raw), clip=clip), (shape, clip))
    if len(shape) >= 4:  # statistics per volume: a volume alone gives its row
        alone = ingest.znorm_clip_minmax(torch.from_numpy(raw[1:2]), clip=clip)
        assert float((alone[0] - got[1]).abs().max()) <= 1e-6


def test_population_deviation():
    """The deviation is numpy's (population), not torch's default."""
    raw = np.asarray([[0.0, 1.0, 2.0, 10.0]], np.float32)
    got = ingest.znorm_clip_minmax(torch.from_numpy(raw), clip=1.0)
    m, s = raw.mean(), raw.std() + 1e-8
    z = np.clip((raw - m) / s, -1.0, 1.0)
    np.testing.assert_allclose(got.numpy(), (z - z.min()) / (z.max() - z.min()), atol=1e-6)


@pytest.mark.parametrize("max_val", [None, 279.82808])
def test_minmax(max_val):
    raw = _raw((2, 8, 9, 10, 1), seed=1)
    got = ingest.minmax(torch.from_numpy(raw), max_val=max_val)
    _close(got, jax_ingest.minmax(jnp.asarray(raw), max_val=max_val), max_val)


@pytest.mark.parametrize("normalize", ["znorm", "minmax", "none"])
def test_ingest_with_a_resample(normalize):
    raw = _raw((2, 12, 10, 9, 1), seed=2)
    got = ingest.ingest(raw, target=(8, 8, 8), normalize=normalize, device="cpu")
    ref = jax_ingest.ingest(raw, target=(8, 8, 8), normalize=normalize)
    _close(got, ref, normalize)
    _close(ingest.resample_volume(torch.from_numpy(raw), (8, 8, 8)),
           jax_ingest.resample_volume(jnp.asarray(raw), (8, 8, 8)), "resample")


def test_ingest_keeps_a_tensor_on_its_device_and_caches_the_pipeline():
    raw = torch.from_numpy(_raw((2, 6, 7, 8, 1), seed=3))
    got = ingest.ingest(raw)  # a CPU tensor stays on the CPU
    assert got.device.type == "cpu"
    _close(got, jax_ingest.ingest(raw.numpy()), "no target")
    assert ingest.make_ingest((8, 8, 8), "znorm", 6.0) is ingest.make_ingest((8, 8, 8), "znorm", 6.0)
    with pytest.raises(ValueError, match="normalize"):
        ingest.make_ingest(None, "zscore", 6.0)
