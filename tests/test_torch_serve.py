"""The port's serving artifact (pulpo_tpu_torch/serve.py) and profiling
utilities, on the CPU.

Export, then load: every entry is bit-equal to the live model (the same
plain versions in the same order). `predict_deterministic` is held
against the JAX model's deterministic forward on the same weights
within 1e-5, on the tiny configuration of tests/test_serve.py.
"""

import json
import time
import zipfile

import jax
import numpy as np
import pytest
import torch

from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.serve import ServedModel, export_model
from pulpo_tpu_torch.uq.predict import predict_with_uncertainty
from pulpo_tpu_torch.utils.profiling import StepTimer, trace

CFG = dict(input_size=(16, 16, 16), total_levels=3, latent_levels=2, n0=4,
           dataset="synthetic")


@pytest.fixture(scope="module")
def live():
    model = PULPoModel(PULPoConfig(**CFG), device="cpu")
    model.init(0)
    rng = np.random.default_rng(1)
    x, y = (rng.random((1, *CFG["input_size"], 1), dtype=np.float32) for _ in range(2))
    return model, torch.from_numpy(x), torch.from_numpy(y)


def _equal(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_export_roundtrip_is_bit_equal_to_the_live_model(live, tmp_path):
    model, x, y = live
    path = str(tmp_path / "model.pulpo")
    export_model(model, path, batch_size=1, N=4, chunk=2)
    served = ServedModel(path, device="cpu")
    assert served.config == model.cfg
    outs = model.apply_eval(x, y, deterministic=True)
    _equal(served.predict_deterministic(x, y), (outs[7][0], outs[6][0]))
    res = predict_with_uncertainty(model, x, y, 4, seed=7, chunk=2)
    _equal(served.uq(x, y, 7), (res.mean_outputs[0], res.final_dfs[0], res.output_std[0],
                                res.output_entropy[0]))
    _equal(served.predict_mean(x, y, 7), (res.mean_outputs[0], res.final_dfs[0]))
    other = served.uq(x, y, 8)
    assert not torch.equal(other[2], res.output_std[0])


def test_manifest(live, tmp_path):
    model, _, _ = live
    path = str(tmp_path / "model.pulpo")
    export_model(model, path, batch_size=1, N=4)
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["manifest.json", "weights.pt"]
        m = json.loads(zf.read("manifest.json"))
    assert m["format_version"] == 1 and m["baked_weights"] and m["N"] == 4
    assert m["chunk"] is None and m["batch_size"] == 1 and m["dtype"] == "float32"
    assert m["torch_version"] == torch.__version__
    assert PULPoConfig(**m["config"]) == model.cfg
    assert m["entries"] == {"predict_deterministic": {"needs_seed": False},
                            "predict_mean": {"needs_seed": True}, "uq": {"needs_seed": True}}
    assert m["kernels"] == {
        "warp": "pulpo_tpu_torch/csrc/warp.cu", "squaring": "pulpo_tpu_torch/csrc/squaring.cu",
        "vel_head": "pulpo_tpu_torch/csrc/vel_head.cu",
        "conv_chain": "pulpo_tpu_torch/csrc/conv_unit.cu",
        "pos_head": "pulpo_tpu_torch/csrc/conv_unit.cu"}


def test_unbaked_weights_are_an_argument(live, tmp_path):
    model, x, y = live
    path = str(tmp_path / "model.pulpo")
    export_model(model, path, N=2, bake_weights=False)
    with zipfile.ZipFile(path) as zf:
        assert zf.namelist() == ["manifest.json"]
    served = ServedModel(path, device="cpu")
    sd = model.state_dict()
    outs = model.apply_eval(x, y, deterministic=True)
    _equal(served.predict_deterministic(sd, x, y), (outs[7][0], outs[6][0]))
    res = predict_with_uncertainty(model, x, y, 2, seed=3)
    _equal(served.predict_mean(sd, x, y, 3), (res.mean_outputs[0], res.final_dfs[0]))
    with pytest.raises(TypeError):
        served.predict_deterministic(x, y)


def test_an_input_of_another_shape_raises(live, tmp_path):
    model, x, y = live
    path = str(tmp_path / "model.pulpo")
    export_model(model, path, N=2)
    served = ServedModel(path, device="cpu")
    with pytest.raises(ValueError, match="exported for"):
        served.predict_deterministic(x[:, :8], y[:, :8])
    with pytest.raises(ValueError, match="exported for"):
        served.uq(torch.cat([x, x]), torch.cat([y, y]), 0)


def test_served_model_without_a_card_raises_unless_cpu_is_asked(live, tmp_path, monkeypatch):
    model, _, _ = live
    path = str(tmp_path / "model.pulpo")
    export_model(model, path, N=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServedModel(path)


def test_predict_deterministic_matches_jax(tmp_path):
    from pulpo_tpu.config import PULPoConfig as JaxConfig
    from pulpo_tpu.models.api import PULPoModel as JaxModel

    jcfg = JaxConfig(**CFG)
    jmodel = JaxModel(jcfg)
    variables = jmodel.init(jax.random.key(0))
    cfg = PULPoConfig(**CFG)
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(jax.device_get(variables), cfg))
    path = str(tmp_path / "model.pulpo")
    export_model(model, path, N=2)
    rng = np.random.default_rng(2)
    x, y = (rng.random((1, *CFG["input_size"], 1), dtype=np.float32) for _ in range(2))
    warped, df = ServedModel(path, device="cpu").predict_deterministic(x, y)
    ref = jmodel.module.apply(variables, x, y, deterministic=True, train=False)
    np.testing.assert_allclose(warped.numpy(), np.asarray(ref[7][0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(df.numpy(), np.asarray(ref[6][0]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ndims", [3, 2])
def test_evaluate_cli_exports_a_served_model(tmp_path, ndims):
    """A one-step train_cli run, exported through `evaluate_cli --export`:
    the artifact's `predict_deterministic` equals `apply_eval` of the
    run's weights bit for bit, and its manifest names the kernels of the
    run's dimension (the 2D network runs the 2D warp and squaring only)."""
    from pulpo_tpu_torch import evaluate_cli, train_cli
    from pulpo_tpu_torch.eval.evaluator import Evaluate

    run_dir = train_cli.main([
        "--dataset", "synthetic", "--accelerator", "cpu", "--max_steps", "1", "--n0", "2",
        "--total_levels", "3", "--latent_levels", "2", "--ndims", str(ndims),
        "--run_dir", str(tmp_path), "--skip_eval"])
    path = tmp_path / "model.pulpo"
    assert evaluate_cli.main(["--run_dir", str(run_dir), "--accelerator", "cpu",
                              "--export", str(path), "--N", "2"]) is None
    served = ServedModel(str(path), device="cpu")
    model = Evaluate(device="cpu").load_model(run_dir)
    assert served.config == model.cfg and served.manifest["N"] == 2
    kernels = {3: {"warp", "squaring", "vel_head", "conv_chain", "pos_head"},
               2: {"warp_2d", "squaring_2d"}}[ndims]
    assert set(served.manifest["kernels"]) == kernels
    rng = np.random.default_rng(3)
    x, y = (rng.random((1, *model.cfg.input_size, 1), dtype=np.float32) for _ in range(2))
    outs = model.apply_eval(x, y, deterministic=True)
    _equal(served.predict_deterministic(x, y), (outs[7][0], outs[6][0]))


def test_step_timer_and_trace_on_the_cpu(tmp_path):
    timer = StepTimer(warmup=1)
    assert timer.report() == "step: no timed steps"
    for _ in range(3):
        timer.tic()
        time.sleep(0.01)
        dt = timer.toc({"a": [torch.ones(2)]})
        assert dt >= 0.01
    assert len(timer.times) == 2
    assert 0.01 <= timer.p50 and 0.01 <= timer.mean
    assert timer.report("req").startswith("req: mean ")
    with trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
