"""The port's artifact injector (`eval/artifact.py`) and the artifact
experiments of `Evaluate` against the JAX package's, on the CPU.

- `artifact(...)`: every method, 3D and 2D, bit-equal (the same numpy
  and scipy code on the same arrays and generator).
- The artifact tables on the synthetic task with the same weights
  (`compat.from_jax_variables`): `performance_affine` for every method
  rtol 1e-12 (numpy on the host); `performance` and `uncertainty` with
  blurred moving images, the same NaN pattern and |diff| <= 1e-3 (the
  rounded performance table) or rtol 1e-4, atol 1e-6 (the uncertainty
  table, with the JAX Evaluate's draws injected), as in
  tests/test_torch_eval.py.
"""

import jax
import numpy as np
import pytest
import torch

from pulpo_tpu.eval.artifact import artifact as jax_artifact
from pulpo_tpu.eval.evaluator import Evaluate as JaxEvaluate
from pulpo_tpu_torch.eval import evaluator
from pulpo_tpu_torch.eval.artifact import artifact
from pulpo_tpu_torch.eval.evaluator import Evaluate
from test_torch_eval import _same_table
from test_torch_model import jax_model_and_variables, port_model
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_uq import jax_noise

METHODS = ["blur", "noise", "mean", "white", "black", "checkerboard"]
KW = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4)


@pytest.mark.parametrize("ndims", [3, 2])
@pytest.mark.parametrize("method", METHODS)
def test_artifact_is_bit_equal(method, ndims):
    rng = np.random.default_rng(ndims)
    shape = (2, 30, 34, 1) if ndims == 2 else (2, 24, 26, 28, 1)
    img = rng.random(shape, dtype=np.float32)
    box = [(3, 21), (5, 25), (4, 24)][:ndims]
    got = artifact(img, method, *box, rng=np.random.default_rng(7))
    ref = jax_artifact(img, method, *box, rng=np.random.default_rng(7))
    assert got.dtype == ref.dtype and not np.array_equal(got, img)
    np.testing.assert_array_equal(got, ref)


def test_artifact_refuses_a_box_of_the_wrong_rank():
    img = np.zeros((1, 8, 8, 1), np.float32)
    with pytest.raises(ValueError, match="z must be None"):
        artifact(img, "white", (1, 2), (1, 2), (1, 2))
    with pytest.raises(ValueError, match="not recognized"):
        artifact(img, "smudge", (1, 2), (1, 2))


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    jm, variables = jax_model_and_variables(seed=3, **KW)
    out = tmp_path_factory.mktemp("artifact")
    ref, got = JaxEvaluate(), Evaluate(device="cpu")
    ref.set_model(jm, variables, output_dir=out / "jax")
    got.set_model(port_model(variables, **KW), output_dir=out / "port")
    for ev in (ref, got):
        ev.load_data("synthetic", segs=True, lms=True, mask=False)
    return ref, got, out


def test_artifact_box_matches_jax(evaluators):
    ref, got, _ = evaluators
    for spatial in ((160, 192, 224), (16, 20, 24), (160, 192), (40, 50)):
        assert got._artifact_box(spatial) == ref._artifact_box(spatial)


@pytest.mark.parametrize("method", METHODS)
def test_affine_artifact_table_matches_jax(evaluators, method):
    ref, got, out = evaluators
    _same_table(got.performance_affine(artifact=method),
                ref.performance_affine(artifact=method, save=False), rtol=1e-12)
    assert (out / "port" / "loss" / f"loss_table_affine{method}.csv").exists()


def test_performance_and_uncertainty_artifact_tables_match_jax(evaluators, monkeypatch):
    ref, got, out = evaluators
    # each pass draws the training pairs' partners anew: both sides pass alike
    clean = got.performance(save=False)
    _same_table(clean, ref.performance(save=False), rtol=0, atol=1e-3 + 1e-9)
    perf = got.performance(artifact="blur")
    _same_table(perf, ref.performance(artifact="blur", save=False), rtol=0, atol=1e-3 + 1e-9)
    assert not np.array_equal(perf.values, clean.values, equal_nan=True)
    assert (out / "port" / "loss" / "loss_table_deterministicblur.csv").exists()

    N = 3
    requests = sum(len(dl.dataset) for dl in got.loaders)
    key, subs = ref.rng, []
    for _ in range(requests):
        key, sub = jax.random.split(key)
        subs.append(sub)
    draws = iter([{l: torch.from_numpy(v) for l, v in jax_noise(ref.model.cfg, s, N, 1).items()}
                  for s in subs])
    uq = evaluator.predict_with_uncertainty
    monkeypatch.setattr(evaluator, "predict_with_uncertainty",
                        lambda *a, **kw: uq(*a, **kw, noise=next(draws)))
    unc = got.uncertainty(N, artifact="blur")
    _same_table(unc, ref.uncertainty(N, artifact="blur", save=False), rtol=1e-4, atol=1e-6)
    assert next(draws, None) is None
    assert (out / "port" / "uncertainty" / "loss_tableblur.csv").exists()
