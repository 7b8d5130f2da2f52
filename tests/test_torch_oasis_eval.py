"""The OASIS evaluation of the port (the Dice and landmark columns of
`Evaluate.run_one_model(task="oasis")`, 3D and 2D) and the two CLIs on
the OASIS and BraTS readers, against the JAX package, on the CPU.

Inputs come from small stores written by
`pulpo_tpu.data.synthetic.write_oasis_style_h5` (36 one-hot classes, as
the converted OASIS release) and `test_torch_readers._write_brats`.
Weights cross with `compat.from_jax_variables`; the JAX draws are
injected into the port. Tolerances: the performance table the same NaN
pattern and within 1e-3 (both rounded to 3 decimals), the uncertainty
table rtol 1e-4 (atol 1e-6), as `test_torch_eval.py`.
"""

import jax
import numpy as np
import pytest
import torch

from pulpo_tpu.data.synthetic import write_oasis_style_h5
from pulpo_tpu.eval.evaluator import Evaluate as JaxEvaluate
from pulpo_tpu_torch import evaluate_cli, train_cli
from pulpo_tpu_torch.eval import evaluator
from pulpo_tpu_torch.eval.evaluator import Evaluate
from pulpo_tpu_torch.train.checkpoint import CheckpointManager, read_checkpoint
from pulpo_tpu_torch.train.metrics import read_metrics
from test_torch_eval import _same_table
from test_torch_model import jax_model_and_variables, port_model
from test_torch_readers import _write_brats
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_uq import jax_noise

SEG_DIM = 36  # pulpo_tpu/data/convert.py:100
KW = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4)
KW_2D = dict(input_size=(24, 28), total_levels=3, latent_levels=2, n0=4)


@pytest.fixture(scope="module")
def oasis_store(tmp_path_factory):
    d = tmp_path_factory.mktemp("oasis")
    return {3: write_oasis_style_h5(d / "OASIS.h5", shape=KW["input_size"],
                                    n_per_split=(2, 2, 2, 2), seg_dim=SEG_DIM, seed=4),
            2: write_oasis_style_h5(d / "OASIS_2d.h5", shape=KW_2D["input_size"],
                                    n_per_split=(2, 2, 2, 2), seg_dim=SEG_DIM, seed=5)}


# ----------------------------------------------------------------------
# the OASIS evaluation tables, 3D and 2D
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ndims", [3, 2])
def test_run_one_model_oasis_tables_match_jax(oasis_store, ndims, tmp_path, monkeypatch):
    """`run_one_model(task="oasis", segs=True, lms=True)`: Dice on train,
    val and test_seg, the landmark columns on test_lm; the JAX Evaluate
    splits key(0) once per uncertainty request, and those draws go to
    the port's requests in order."""
    kw = KW if ndims == 3 else KW_2D
    jm, variables = jax_model_and_variables(seed=11, **kw)
    ref_ev = JaxEvaluate()
    ref_ev.set_model(jm, variables, output_dir=tmp_path / "jax")
    got_ev = Evaluate(device="cpu")
    got_ev.set_model(port_model(variables, **kw), output_dir=tmp_path / "port")
    N = 3
    requests = 2 + 2 + 2 + 2
    key, subs = jax.random.key(0), []
    for _ in range(requests):
        key, sub = jax.random.split(key)
        subs.append(sub)
    draws = iter([{l: torch.from_numpy(v) for l, v in jax_noise(jm.cfg, s, N, 1).items()}
                  for s in subs])
    uq = evaluator.predict_with_uncertainty
    monkeypatch.setattr(evaluator, "predict_with_uncertainty",
                        lambda *a, **kw: uq(*a, **kw, noise=next(draws)))
    args = dict(segs=True, lms=True, N=N, task="oasis", data_path=oasis_store[ndims],
                visualize=False)
    ref_perf, ref_unc = ref_ev.run_one_model(**args)
    perf, unc = got_ev.run_one_model(**args)
    assert next(draws, None) is None
    assert got_ev.loader_names == ["train", "val", "test_seg", "test_lm"]
    _same_table(perf, ref_perf, rtol=0, atol=1e-3 + 1e-9)
    _same_table(unc, ref_unc, rtol=1e-4, atol=1e-6)
    assert np.isfinite(perf[("test_seg", "Dice")]).all() and np.isnan(perf[("test_lm", "Dice")]).all()
    assert np.isfinite(perf[("test_lm", "LM_Euclid")][0]) and np.isfinite(unc[("test_lm", "LM_NCC")][0])
    assert (tmp_path / "port" / "loss" / "loss_table_deterministic.csv").exists()
    assert (tmp_path / "port" / "uncertainty" / "loss_table.tex").exists()


# ----------------------------------------------------------------------
# the CLIs on the readers
# ----------------------------------------------------------------------

CLI_NET = ["--n0", "2", "--total_levels", "3", "--latent_levels", "2", "--accelerator", "cpu"]


def test_train_cli_oasis_with_segs_trains_and_evaluates(oasis_store, tmp_path):
    run_dir = train_cli.main(["--dataset", "oasis", "--segs", "--recon_loss", "ncc", "dice",
                              "--lms", "--data_path", str(oasis_store[3]), "--max_steps", "2",
                              "--run_dir", str(tmp_path)] + CLI_NET)
    cfg = CheckpointManager.load_config(run_dir)
    assert cfg.input_size == KW["input_size"] and cfg.segs and cfg.routing == ()
    assert cfg.recon_loss == ("ncc", "dice") and cfg.dataset == "oasis"
    rows = read_metrics(run_dir)
    assert rows and all(np.isfinite(r["val/total_loss"]) for r in rows if "val/total_loss" in r)
    assert read_checkpoint(run_dir, "latest")["step"] == 2
    perf = (run_dir / "evaluation" / "loss" / "loss_table_deterministic.csv").read_text()
    assert "test_seg" in perf and "Dice" in perf and "LM_MAE" in perf

    perf, unc = evaluate_cli.main(["--run_dir", str(run_dir), "--task", "oasis", "--segs",
                                   "--lms", "--N", "2", "--data_path", str(oasis_store[3]),
                                   "--accelerator", "cpu", "--no_visualize"])
    assert np.isfinite(perf[("test_seg", "Dice")]).all()
    assert np.isfinite(unc[("test_lm", "LM_VAR")][0])
    assert (run_dir / "evaluation" / "uncertainty" / "loss_table.csv").exists()


def test_train_cli_oasis_2d_evaluates(oasis_store, tmp_path):
    """`--ndims 2 --dataset oasis` evaluates without `--skip_eval`."""
    run_dir = train_cli.main(["--dataset", "oasis", "--ndims", "2", "--segs", "--lms",
                              "--data_path", str(oasis_store[2]), "--max_steps", "1",
                              "--run_dir", str(tmp_path)] + CLI_NET)
    assert CheckpointManager.load_config(run_dir).input_size == KW_2D["input_size"]
    perf = (run_dir / "evaluation" / "loss" / "loss_table_deterministic.csv").read_text()
    assert "test_lm" in perf and "Dice" in perf


def test_train_cli_default_dataset_is_brats(tmp_path):
    store = _write_brats(tmp_path / "BraTS.h5", shape=(16, 20, 24))
    run_dir = train_cli.main(["--data_path", str(store), "--max_steps", "2", "--lms",
                              "--run_dir", str(tmp_path)] + CLI_NET)
    cfg = CheckpointManager.load_config(run_dir)
    assert cfg.dataset == "brats" and cfg.input_size == (16, 20, 24) and cfg.routing == ()
    assert read_checkpoint(run_dir, "latest")["step"] == 2
    perf = (run_dir / "evaluation" / "loss" / "loss_table_deterministic.csv").read_text()
    assert perf.splitlines()[0] == ",train,train,train,train,train,val,val,val,val,val," \
        "test,test,test,test,test"
    run_dir = train_cli.main(["--data_path", str(store), "--max_steps", "1", "--interpatient",
                              "--skip_eval", "--run_dir", str(tmp_path)] + CLI_NET)
    assert CheckpointManager.load_config(run_dir).interpatient
