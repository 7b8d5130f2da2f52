"""The OASIS path of the port (segmentations, the Dice loss and table
column, landmarks, the 2D evaluation) and the two CLIs on the OASIS and
BraTS readers, against the JAX package, on the CPU.

Inputs come from numpy seeds and from small stores written by
`pulpo_tpu.data.synthetic.write_oasis_style_h5` (36 one-hot classes, as
the converted OASIS release) and `test_torch_readers._write_brats`.
Weights cross with `compat.from_jax_variables`; the JAX draws are
injected into the port. Tolerances (port in float32):

- the warp of a 36-channel segmentation and its df-cotangent against
  `pulpo_tpu.ops.warp.warp_image` and `jax.grad` through it: 1e-5 of
  scale (the same gathers; the cotangent sums 36 channel products);
  `transform_segmentation` at 36 channels: 1e-5 of scale;
- the Dice term's gradient to the final dfs through
  `transform_segmentation` (36 channels) against `jax.grad`: 1e-5 of
  scale;
- one segmentation training step (NCC + Dice, dice_factor 50) against
  the JAX step taken in float64, as `test_torch_train.py` takes it:
  losses rtol 1e-4, parameters after one Adam step 2 * lr, BatchNorm
  statistics 1e-5, and gradients within 1e-2 of each leaf's scale, not
  1e-3: on this pair (two smooth volumes and their 36-class label maps,
  as the store writer makes them) the float32 down-path gradients are
  rounding-bound at that level. The port's own float32 gradients move
  by 6.6e-3 of scale when only the order of the batch's two pairs is
  reversed, and the JAX step's float32 gradients are 1.2e-2 off its
  float64 ones;
- `Evaluate.run_one_model(task="oasis")` tables against the JAX
  Evaluate's on the same weights and draws, 3D and 2D: the performance
  table the same NaN pattern and within 1e-3 (both rounded to 3
  decimals), the uncertainty table rtol 1e-4 (atol 1e-6), as
  `test_torch_eval.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.data.synthetic import (
    blobby_segmentation,
    random_smooth_volume,
    write_oasis_style_h5,
)
from pulpo_tpu.eval.evaluator import Evaluate as JaxEvaluate
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.models.api import transform_segmentation as jax_transform_segmentation
from pulpo_tpu.ops import losses as jax_losses
from pulpo_tpu.ops import warp as jax_warp
from pulpo_tpu.train.step import compute_losses as jax_compute_losses
from pulpo_tpu.train.step import create_train_state as jax_create_train_state
from pulpo_tpu.train.step import make_train_step as jax_make_train_step
from pulpo_tpu_torch import PULPoConfig, evaluate_cli, train_cli
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.eval import evaluator
from pulpo_tpu_torch.eval.evaluator import Evaluate
from pulpo_tpu_torch.models.api import transform_segmentation
from pulpo_tpu_torch.ops import losses as port_losses
from pulpo_tpu_torch.ops import warp as port_warp
from pulpo_tpu_torch.train import make_train_step
from pulpo_tpu_torch.train.checkpoint import CheckpointManager, read_checkpoint
from pulpo_tpu_torch.train.metrics import read_metrics
from pulpo_tpu_torch.train.step import compute_grads
from test_torch_eval import _same_table
from test_torch_model import jax_model_and_variables, port_model
from test_torch_readers import _write_brats
from test_torch_train import _close_metrics, _eps, _port_from_jax
from test_torch_uq import jax_noise

SEG_DIM = 36  # pulpo_tpu/data/convert.py:100
KW = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4)
KW_2D = dict(input_size=(24, 28), total_levels=3, latent_levels=2, n0=4)
SEG_KW = dict(KW, batch_size=2, segs=True, recon_loss=("ncc", "dice"), dice_factor=50)


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * scale, err_msg=what)


def _onehot(shape, seed):
    labels = np.random.default_rng(seed).integers(0, SEG_DIM, shape)
    return np.eye(SEG_DIM, dtype=np.float32)[labels]


def _smooth_df(shape, mag, seed):
    b, *size, c = shape
    coarse = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (b, 3, 4, 5, c)).astype(np.float32))
    from pulpo_tpu_torch.ops.resize import resize_linear

    v = resize_linear(coarse, tuple(size)).numpy()
    return (v * np.float32(mag / np.abs(v).max())).astype(np.float32)


@pytest.fixture(scope="module")
def oasis_store(tmp_path_factory):
    d = tmp_path_factory.mktemp("oasis")
    return {3: write_oasis_style_h5(d / "OASIS.h5", shape=KW["input_size"],
                                    n_per_split=(2, 2, 2, 2), seg_dim=SEG_DIM, seed=4),
            2: write_oasis_style_h5(d / "OASIS_2d.h5", shape=KW_2D["input_size"],
                                    n_per_split=(2, 2, 2, 2), seg_dim=SEG_DIM, seed=5)}


# ----------------------------------------------------------------------
# the segmentation warp at 36 channels
# ----------------------------------------------------------------------

def test_segmentation_warp_and_its_df_cotangent_match_jax():
    seg = _onehot((2, *KW["input_size"]), 1)
    df = _smooth_df((4, *KW["input_size"], 3), 3.0, 2)  # row r reads seg row r % 2
    g = np.random.default_rng(3).standard_normal((4, *KW["input_size"], SEG_DIM))
    g = g.astype(np.float32)
    s_t = torch.from_numpy(seg)
    d_t = torch.from_numpy(df).requires_grad_(True)
    out = port_warp.warp_image(s_t, d_t)
    (gd,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), d_t)
    ref_out = jax_warp.warp_image(jnp.asarray(seg), jnp.asarray(df))
    ref_gd = jax.grad(lambda d: jnp.sum(jax_warp.warp_image(jnp.asarray(seg), d) * g))(
        jnp.asarray(df))
    assert out.shape == (4, *KW["input_size"], SEG_DIM)
    _close(out.detach().numpy(), ref_out, 1e-5)
    _close(gd.numpy(), ref_gd, 1e-5)


@pytest.mark.parametrize("df_resolution", ["level_res", "full_res"])
def test_transform_segmentation_at_36_channels_matches_jax(df_resolution):
    cfg = PULPoConfig(**KW, df_resolution=df_resolution)
    seg = _onehot((1, *KW["input_size"]), 6)
    dfs = {l: _smooth_df((1, *cfg.df_size(l), 3), 2.0, 7 + l) for l in range(2)}
    got = transform_segmentation(cfg, {l: torch.from_numpy(v) for l, v in dfs.items()},
                                 torch.from_numpy(seg))
    ref = jax_transform_segmentation(JaxConfig(**KW, df_resolution=df_resolution),
                                     {l: jnp.asarray(v) for l, v in dfs.items()},
                                     jnp.asarray(seg))
    for l in ref:
        assert tuple(got[l].shape) == tuple(ref[l].shape)
        _close(got[l].numpy(), ref[l], 1e-5, f"level {l}")


def test_dice_gradient_through_transform_segmentation_matches_jax():
    cfg, jcfg = PULPoConfig(**SEG_KW), JaxConfig(**SEG_KW)
    seg_x, seg_y = _onehot((2, *KW["input_size"]), 12), _onehot((2, *KW["input_size"]), 13)
    y = np.random.default_rng(14).random((2, *KW["input_size"], 1), dtype=np.float32)
    dfs = {l: _smooth_df((2, *cfg.df_size(l), 3), 2.0, 15 + l) for l in range(2)}
    w = {l: 1.0 for l in range(2)}

    def port_loss(d):
        segs = transform_segmentation(cfg, d, torch.from_numpy(seg_x))
        total, _ = port_losses.hierarchical_reconstruction_loss(
            segs, torch.from_numpy(y), w, ("dice",), cfg.window_size, dice_factor=50.0,
            y_hat_seg=segs, seg_y=torch.from_numpy(seg_y))
        return total

    def jax_loss(d):
        segs = jax_transform_segmentation(jcfg, d, jnp.asarray(seg_x))
        total, _ = jax_losses.hierarchical_reconstruction_loss(
            segs, jnp.asarray(y), w, ("dice",), jcfg.window_size, dice_factor=50.0,
            y_hat_seg=segs, seg_y=jnp.asarray(seg_y))
        return total

    d_t = {l: torch.from_numpy(v).requires_grad_(True) for l, v in dfs.items()}
    total = port_loss(d_t)
    got = torch.autograd.grad(total, [d_t[l] for l in range(2)])
    ref_total, ref = jax.value_and_grad(jax_loss)({l: jnp.asarray(v) for l, v in dfs.items()})
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    for l in range(2):
        _close(got[l].numpy(), ref[l], 1e-5, f"level {l}")


# ----------------------------------------------------------------------
# one segmentation training step against the JAX step in float64
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_seg_step():
    """The JAX `make_train_step` at SEG_KW on one batch with one-hot
    segmentations, in float64 from the float32 initial state (why:
    `test_torch_train.jax_step_result`): its states, metrics, gradients
    and draws."""
    jcfg = JaxConfig(**SEG_KW)
    jm = JaxModel(jcfg)
    state, tx = jax_create_train_state(jm, seed=0)
    rng = np.random.default_rng(8)
    vols = [random_smooth_volume(rng, jcfg.input_size) for _ in range(4)]
    onehot = np.eye(SEG_DIM, dtype=np.float32)
    batch = {"x": np.stack(vols[:2])[..., None], "y": np.stack(vols[2:])[..., None],
             "seg_x": np.stack([onehot[blobby_segmentation(v, SEG_DIM)] for v in vols[:2]]),
             "seg_y": np.stack([onehot[blobby_segmentation(v, SEG_DIM)] for v in vols[2:]])}
    to_np = lambda t: jax.tree.map(np.asarray, t)
    before = {"params": to_np(state.params), "batch_stats": to_np(state.batch_stats)}
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(
            lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
            else a, t)
        state = state.replace(params=f64(state.params), batch_stats=f64(state.batch_stats),
                              opt_state=f64(state.opt_state))
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        _, sample_rng = jax.random.split(state.rng)  # as train_step splits it

        @jax.jit
        def grads_and_draws(params, batch_stats):
            def loss_fn(p):
                outs, _ = jm.apply_train({"params": p, "batch_stats": batch_stats},
                                         jb["x"], jb["y"], sample_rng)
                total, _ = jax_compute_losses(jcfg, outs, jb["x"], jb["y"], jb["seg_x"],
                                              jb["seg_y"])
                return total, outs[:3]
            return jax.grad(loss_fn, has_aux=True)(params)

        grads, outs3 = grads_and_draws(state.params, state.batch_stats)
        new_state, metrics = jax.jit(jax_make_train_step(jm, tx))(state, jb)
        return dict(
            batch=batch, before=before,
            after={"params": to_np(new_state.params),
                   "batch_stats": to_np(new_state.batch_stats)},
            grads={"params": to_np(grads), "batch_stats": before["batch_stats"]},
            metrics=to_np(metrics), noise=_eps(outs3))


def test_segmentation_train_step_matches_jax(jax_seg_step):
    r = jax_seg_step
    cfg = PULPoConfig(**SEG_KW)
    model, state, tx = _port_from_jax(r["before"], cfg)
    grads, _, metrics = compute_grads(model, r["batch"], noise=r["noise"])
    ref_grads = {k: v.float() for k, v in from_jax_variables(r["grads"], cfg).items()}
    top = max(float(ref_grads[n].abs().max()) for n in grads)
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-2 * top)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 1e-2 * scale, (name, err, scale)

    state, metrics = make_train_step(model, tx)(state, r["batch"], noise=r["noise"])
    _close_metrics(metrics, r["metrics"])
    # the Dice term is in the loss: it differs from the NCC-only loss
    ncc_only = PULPoConfig(**dict(SEG_KW, recon_loss=("ncc",)))
    m2, _, _ = _port_from_jax(r["before"], ncc_only)
    _, _, m_ncc = compute_grads(m2, r["batch"], noise=r["noise"])
    assert abs(float(metrics["reconstruction_loss"]) - float(m_ncc["reconstruction_loss"])) > 1
    after = from_jax_variables(r["after"], cfg)
    got = model.state_dict()
    for name, ref in after.items():
        atol = 1e-5 if "running_" in name else 2 * cfg.lr
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


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
