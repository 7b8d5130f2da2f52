"""The port's evaluation (metrics, tables, Evaluate, evaluate_cli)
against the JAX package's, on the CPU.

The same weights cross with `compat.from_jax_variables`. Tolerances:
the scalar metrics rtol 1e-12 (the same numpy arithmetic); the
deterministic performance table the same NaN pattern and |diff| <= 1e-3
(both rounded to 3 decimals, so one rounding step apart at most); the
uncertainty table rtol 1e-4 (atol 1e-6 for entries near 0) with the
JAX Evaluate's draws injected into the port's.
"""

import jax
import numpy as np
import pytest
import torch

from pulpo_tpu import routing
from pulpo_tpu.eval import metrics as jax_metrics
from pulpo_tpu.eval.evaluator import Evaluate as JaxEvaluate
from pulpo_tpu_torch import evaluate_cli, train_cli
from pulpo_tpu_torch.eval import evaluator
from pulpo_tpu_torch.eval import metrics
from pulpo_tpu_torch.eval.evaluator import Evaluate
from pulpo_tpu_torch.eval.tables import Table, make_tables, table_jdet
from pulpo_tpu_torch.models.api import combine_dfs
from test_torch_data import _write_lungct
from test_torch_model import jax_model_and_variables, port_model
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_uq import jax_noise

KW = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4)


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_model_and_variables(seed=3, **KW)
    return jm, variables, port_model(variables, **KW)


def _evaluators(models, tmp_path):
    jm, variables, model = models
    ref = JaxEvaluate()
    ref.set_model(jm, variables, output_dir=tmp_path / "jax")
    got = Evaluate(device="cpu")
    got.set_model(model, output_dir=tmp_path / "port")
    return ref, got


def _same_table(got, ref, **tol):
    assert got.columns == [tuple(c) for c in ref.columns]
    assert got.index == list(ref.index)
    r = ref.values.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(r))
    np.testing.assert_allclose(got.values, r, **tol)


_RNG = np.random.default_rng(0)
_LMS = _RNG.random((6, 5, 3)) * 10
METRIC_CASES = {
    "rmse": (_RNG.random((1, 5, 6, 7, 1)), _RNG.random((1, 5, 6, 7, 1))),
    "dsc": (_RNG.random((2, 5, 6, 7, 3)), _RNG.random((2, 5, 6, 7, 3))),
    "global_ncc": (_RNG.random((5, 6, 7)), _RNG.random((5, 6, 7))),
    "lm_mae": (_RNG.random((1, 6, 3)) * 9, _RNG.random((1, 6, 3)) * 9),
    "lm_euclid": (_RNG.random((1, 5, 3)) * 9, _RNG.random((1, 5, 3)) * 9),
    "lms_var": (_LMS,),
    "lms_corr": (_LMS.mean(0), _LMS, _LMS.mean(0) + _RNG.random((5, 3))),
    "jdet_leq0_percent": (_RNG.standard_normal((1, 5, 6, 7)),),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metric_matches_jax(name):
    args = METRIC_CASES[name]
    np.testing.assert_allclose(getattr(metrics, name)(*args), getattr(jax_metrics, name)(*args),
                               rtol=1e-12)


def test_lm_mae_takes_the_lower_middle_element():
    lm1 = np.array([[[0.0, 0, 0], [1, 1, 1]]])
    lm2 = np.array([[[1.0, 0, 0], [1, 1, 4]]])
    assert metrics.lm_mae(lm1, lm2) == 1.0  # of (1, 3), torch.median's convention


def test_table_round_trips_to_csv_and_latex(tmp_path):
    t = Table.from_sets([[1.23456, np.nan, 2e-4], [1.23449, 5.0, 6.0]], ["train"],
                        ["RMSE", "JDet_std", "Var"])
    assert t.shape == (2, 3) and t.round(3)[("train", "RMSE")].tolist() == [1.235, 1.234]
    latex = make_tables(t.round(3), tmp_path, name="demo")
    assert r"\multicolumn{3}{r}{train}" in latex and r"JDet\_std" in latex and "nan" in latex
    assert "2.00e-04" in t.to_latex()
    assert (tmp_path / "demo.tex").read_text() == latex
    rows = (tmp_path / "demo.csv").read_text().splitlines()
    assert rows[0] == ",train,train,train" and rows[1] == ",RMSE,JDet_std,Var"
    assert rows[2].split(",")[1] == "1.235"


def test_table_jdet_matches_jax():
    from pulpo_tpu.eval.tables import table_jdet as jax_table_jdet

    rng = np.random.default_rng(1)
    final = {l: (rng.standard_normal((1, 8, 9, 10, 3)) * 0.5).astype(np.float32) for l in range(2)}
    ind = {l: (rng.standard_normal((1, 8, 9, 10, 3)) * 2).astype(np.float32) for l in range(2)}
    ref = jax_table_jdet(final, ind)
    got = table_jdet({l: torch.from_numpy(v) for l, v in final.items()}, ind)
    assert got.index_name == "Level"
    _same_table(got, ref, rtol=0, atol=1e-3 + 1e-9)


def test_performance_matches_jax(models, tmp_path):
    ref_ev, got_ev = _evaluators(models, tmp_path)
    for ev in (ref_ev, got_ev):
        ev.load_data("synthetic", segs=True, lms=True, mask=False)
    ref = ref_ev.performance(save=False)
    got = got_ev.performance()
    assert got.shape == (2, 18)
    _same_table(got, ref, rtol=0, atol=1e-3 + 1e-9)
    assert (tmp_path / "port" / "loss" / "loss_table_deterministic.csv").exists()
    assert np.isfinite(got[("test", "LM_MAE")][0]) and np.isfinite(got[("val", "Dice")]).all()

    ref_aff = ref_ev.performance_affine(save=False)
    _same_table(got_ev.performance_affine(), ref_aff, rtol=1e-12)


def test_uncertainty_matches_jax_with_its_draws(models, tmp_path, monkeypatch):
    """The JAX Evaluate splits key(0) once per request; those sub-keys'
    draws are rebuilt here and handed to the port's requests in order."""
    jm, _, _ = models
    ref_ev, got_ev = _evaluators(models, tmp_path)
    for ev in (ref_ev, got_ev):
        ev.load_data("synthetic", segs=False, lms=True, mask=False)
    N = 3
    requests = sum(len(dl.dataset) for dl in got_ev.loaders)
    key, subs = jax.random.key(0), []
    for _ in range(requests):
        key, sub = jax.random.split(key)
        subs.append(sub)
    draws = iter([{l: torch.from_numpy(v) for l, v in jax_noise(jm.cfg, s, N, 1).items()}
                  for s in subs])
    uq = evaluator.predict_with_uncertainty
    monkeypatch.setattr(evaluator, "predict_with_uncertainty",
                        lambda *a, **kw: uq(*a, **kw, noise=next(draws)))

    ref = ref_ev.uncertainty(num_samples=N, save=False)
    got = got_ev.uncertainty(num_samples=N)
    assert next(draws, None) is None
    assert ("test", "LM_NCC") in got
    _same_table(got, ref, rtol=1e-4, atol=1e-6)


def test_predict_matches_jax(models, tmp_path, monkeypatch):
    """The reference's tuple schema. A deterministic prediction against
    the JAX Evaluate's; an N = 3 prediction against the port's own
    `predict_with_uncertainty` (held to JAX in test_torch_uq.py) on the
    same draws, its mean SVF combined and integrated."""
    jm, _, model = models
    ref_ev, got_ev = _evaluators(models, tmp_path)
    for ev in (ref_ev, got_ev):
        ev.load_data("synthetic", segs=True, lms=False, mask=False)
    batch = got_ev.sample_data("val")
    ref, _ = ref_ev.predict(batch, num_samples=1, deterministic=True)
    got, got_all = got_ev.predict(batch, num_samples=1, deterministic=True)
    assert got[8] == ref[8] == "deterministic_prediction" and got_all == []
    for i in (0, 1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=0, atol=1e-4)
    for l in range(2):
        np.testing.assert_allclose(got[6][l].numpy(), np.asarray(ref[6][l]), rtol=0, atol=1e-4)

    N = 3
    noise = {l: torch.from_numpy(v) for l, v in
             jax_noise(jm.cfg, jax.random.key(1), N, 1).items()}
    uq = evaluator.predict_with_uncertainty
    monkeypatch.setattr(evaluator, "predict_with_uncertainty",
                        lambda *a, **kw: uq(*a, **kw, noise=noise))
    got, got_all = got_ev.predict(batch, num_samples=N)
    res = uq(model, batch["x"], batch["y"], N, keep_samples=True, noise=noise)
    _, final = combine_dfs(model.cfg, res.avg_dfs)
    assert got[8] == "avg_prediction_over_3_samples" and len(got_all) == 8
    torch.testing.assert_close(got[0], res.mean_outputs[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], final[0], rtol=0, atol=0)
    torch.testing.assert_close(got_all[0][0], res.output_std[0], rtol=0, atol=0)
    torch.testing.assert_close(got_all[6][0], res.sample_final_dfs[0][:, 0], rtol=0, atol=0)
    assert got[2].shape == (1, *KW["input_size"], 4)  # the warped segmentation


def test_lungct_task_matches_jax(models, tmp_path, monkeypatch):
    # the JAX task switches its warp routing for the whole process
    monkeypatch.setattr(routing, "_active", dict(routing._active))
    path = _write_lungct(tmp_path / "LungCT.h5", shape=KW["input_size"])
    ref_ev, got_ev = _evaluators(models, tmp_path)
    for ev in (ref_ev, got_ev):
        ev.load_data("lungct", segs=False, lms=True, mask=False, path=path)
    assert got_ev.loader_names == ["train", "val", "test"]
    ref = ref_ev.performance(save=False)
    got = got_ev.performance()
    _same_table(got, ref, rtol=0, atol=1e-3 + 1e-9)
    assert np.isfinite(got[("test", "LM_Euclid")][0]) and np.isnan(got[("train", "LM_MAE")]).all()


def test_evaluate_cli_on_a_train_cli_run(tmp_path):
    run_dir = train_cli.main([
        "--dataset", "synthetic", "--accelerator", "cpu", "--max_steps", "1",
        "--n0", "2", "--total_levels", "3", "--latent_levels", "2",
        "--run_dir", str(tmp_path), "--skip_eval"])
    # the default command draws the figures first (`--no_visualize` is
    # run in test_torch_oasis.py)
    perf, unc = evaluate_cli.main(["--run_dir", str(run_dir), "--task", "synthetic", "--lms",
                                   "--N", "2", "--accelerator", "cpu"])
    assert perf.shape == (2, 15) and np.isfinite(perf[("train", "RMSE")]).all()
    assert np.isfinite(unc[("val", "Var")]).all()
    out = run_dir / "evaluation"
    assert (out / "loss" / "loss_table_deterministic.tex").exists()
    assert (out / "uncertainty" / "loss_table.csv").exists()
    figures = [f"allvis{s}_{p}" for s in ("train", "val", "test")
               for p in ("deterministic", "sample", "avg_2")]
    assert sorted(f.name for f in (out / "vis").iterdir()) == sorted(
        f + ext for f in figures for ext in (".npz", ".png"))
    assert sorted(f.name for f in (out / "jdet").glob("*.csv")) == sorted(
        f"jdet_{f[len('allvis'):]}.csv" for f in figures)
    args = ["--run_dir", str(run_dir), "--task", "synthetic", "--accelerator", "cpu"]
    assert evaluate_cli.main(args + ["--export", str(tmp_path / "artifact")]) is None
    assert (tmp_path / "artifact").stat().st_size > 0
    with pytest.raises(FileNotFoundError):  # the OASIS reader opens its store
        Evaluate(device="cpu").load_data("oasis", False, False, False,
                                         path=tmp_path / "missing.h5")
