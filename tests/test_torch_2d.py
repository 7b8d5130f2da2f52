"""The 2D configuration (ndims = 2) of the port against the JAX
package's, on the CPU.

Inputs come from numpy seeds; weights from one JAX init, with randomised
BatchNorm statistics for the eval tests; the
posterior draws are JAX's, injected into the port. Each JAX function
that reaches a Pallas kernel runs it in interpret mode. Tolerances
(port in float32):

- the squaring step's plain version against the 2D arm of
  `_squaring_step_pallas` on a sub-voxel field: 1e-5 of the field's
  scale (the stencil sums 9 hat-weighted taps, the gather 4 corners);
  past the stencil's bound against `_squaring_step_xla`, the gather the
  JAX package takes there: 1e-6 of scale (the same operations);
- the box sum's plain version against the 2D arm of `_box_sum_pallas`:
  1e-6 of scale (the same shifted adds in the same order);
- the warp and a 7-step integration against `pulpo_tpu.ops.warp`: 1e-5
  of scale; resize and pooling: 1e-6; the losses: rtol 1e-5;
- `apply_eval` and every `UQResult` leaf: atol 1e-4 (as the 3D tests);
- one training step against the JAX step taken in float64 (as
  `test_torch_train.py`): losses rtol 1e-4, gradients 1e-3 of each
  leaf's scale, parameters after one Adam step 2 * lr, BatchNorm
  statistics 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.compat.torch_import import import_torch_state_dict
from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.kernels.box_sum import _box_sum_pallas
from pulpo_tpu.kernels.warp_local import _squaring_step_pallas, _squaring_step_xla
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.ops import losses as jax_losses
from pulpo_tpu.ops import resize as jax_resize
from pulpo_tpu.ops import warp as jax_warp
from pulpo_tpu.train.step import create_train_state as jax_create_train_state
from pulpo_tpu.train.step import make_train_step as jax_make_train_step
from pulpo_tpu.uq.predict import predict_with_uncertainty as jax_uq
from pulpo_tpu_torch import PULPoConfig, train_cli
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.data.loader import DataLoader
from pulpo_tpu_torch.data.synthetic import SyntheticDataset
from pulpo_tpu_torch.kernels import box_sum, squaring, warp
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.ops import losses, resize
from pulpo_tpu_torch.ops import warp as port_warp
from pulpo_tpu_torch.train import create_train_state, make_train_step
from pulpo_tpu_torch.train.checkpoint import read_checkpoint, state_payload
from pulpo_tpu_torch.train.loop import Trainer
from pulpo_tpu_torch.train.metrics import read_metrics
from pulpo_tpu_torch.train.step import compute_grads
from pulpo_tpu_torch.uq.predict import UQResult, predict_with_uncertainty
from chip_smoke import payload_difference
from test_torch_model import NAMES, port_model
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_trainer import _SamePair
from test_torch_uq import comparable, jax_noise

KW = dict(input_size=(24, 28), total_levels=3, latent_levels=2, n0=4)
# the flagship network on the neurite-OASIS 2D slice, and the JAX
# train_cli's synthetic 2D default (pulpo_tpu/train_cli.py:107)
FLAGSHIP_2D = dict(input_size=(160, 192), total_levels=5, latent_levels=4, n0=32,
                   compute_dtype="bfloat16", dataset="synthetic")
CLI_2D = dict(input_size=(64, 64), total_levels=3, latent_levels=2, n0=8,
              dataset="synthetic")


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return v * np.float32(mag / np.abs(v).max())


def _smooth(shape, mag, seed):
    """A smooth (B, S0, S1, 2) field with max |v| = mag."""
    b, *size, c = shape
    coarse = torch.from_numpy(_field((b, 4, 5, c), 1.0, seed))
    v = resize.resize_linear(coarse, tuple(size)).numpy()
    return (v * np.float32(mag / np.abs(v).max())).astype(np.float32)


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * scale, err_msg=what)


# ----------------------------------------------------------------------
# config
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [FLAGSHIP_2D, CLI_2D], ids=["flagship-2d", "cli-64x64"])
def test_config_derives_what_the_jax_config_derives(kw):
    got, ref = PULPoConfig(**kw), JaxConfig(**kw)
    assert got.ndims == ref.ndims == 2
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    for name in ("zdim", "lk_offset", "num_channels", "global_level_sizes", "level_sizes",
                 "floor_level_sizes", "window_size", "kl_weight_dict", "recon_weight_dict",
                 "regularization_weight_dict"):
        assert getattr(got, name) == getattr(ref, name), name
    assert [got.df_size(l) for l in range(got.latent_levels)] == \
        [ref.df_size(l) for l in range(ref.latent_levels)]
    if kw is FLAGSHIP_2D:
        assert got.level_sizes == {0: (80, 96), 1: (40, 48), 2: (20, 24), 3: (10, 12)}
        assert got.window_size == {0: 9, 1: 7, 2: 5, 3: 3}


# ----------------------------------------------------------------------
# the two 2D Pallas arms
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 24, 28, 2), (1, 40, 48, 2)])
def test_squaring_step_matches_the_pallas_2d_arm(shape):
    v = _smooth(shape, 0.3, seed=1)
    ref = _squaring_step_pallas(jnp.asarray(v), interpret=True)
    _close(squaring.squaring_step_plain(torch.from_numpy(v)).numpy(), ref, 1e-5)
    # past the stencil's bound the JAX package takes the XLA gather
    v = _smooth(shape, 4.0, seed=2)
    ref = _squaring_step_xla(jnp.asarray(v))
    _close(squaring.squaring_step_plain(torch.from_numpy(v)).numpy(), ref, 1e-6)


@pytest.mark.parametrize("win", [3, 5, 7, 9])
def test_box_sum_matches_the_pallas_2d_arm(win):
    x = np.random.default_rng(win).random((2, 20, 24), dtype=np.float32)
    ref = _box_sum_pallas(jnp.asarray(x), win, True)
    got = box_sum.box_sum(torch.from_numpy(x), win)
    _close(got.numpy(), ref, 1e-6)
    assert box_sum.launches_2d == box_sum.launches == 0  # the CPU runs the plain version


# ----------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------

def test_warp_and_integration_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((2, 24, 28, 1), dtype=np.float32)
    df = _field((4, 24, 28, 2), 3.0, seed=4)  # row r reads moving row r % 2
    _close(port_warp.warp_image(torch.from_numpy(img), torch.from_numpy(df)).numpy(),
           jax_warp.warp_image(jnp.asarray(img), jnp.asarray(df)), 1e-5)
    # cross resolution: a full-size moving image warped by a half-size df
    half = _field((2, 12, 14, 2), 2.0, seed=5)
    _close(port_warp.warp_image(torch.from_numpy(img), torch.from_numpy(half)).numpy(),
           jax_warp.warp_image(jnp.asarray(img), jnp.asarray(half)), 1e-5)
    v = _smooth((2, 24, 28, 2), 6.0, seed=6)
    ref = jax_warp.integrate_svf(jnp.asarray(v), 7)
    _close(port_warp.integrate_svf(torch.from_numpy(v), 7).numpy(), ref, 1e-5)
    assert squaring.launches_2d == warp.launches_2d == 0
    _close(port_warp.resize_vecfield(torch.from_numpy(v), 0.5, (48, 56)).numpy(),
           jax_warp.resize_vecfield(jnp.asarray(v), 0.5, (48, 56)), 1e-6)
    lm = np.array([[[3.0, 4.0], [10.5, 20.7]], [[1.2, 2.0], [22.0, 26.9]]], np.float32)
    np.testing.assert_allclose(
        port_warp.warp_landmarks(torch.from_numpy(lm), torch.from_numpy(v)).numpy(),
        jax_warp.warp_landmarks(jnp.asarray(lm), jnp.asarray(v)), rtol=0, atol=1e-6)


def test_2d_gradients_are_the_plain_versions():
    """A 2D warp and integration are differentiated as their plain
    versions (as the JAX package's 2D backward is XLA's VJP): the same
    gradients as `jax.grad` through `pulpo_tpu.ops.warp`."""
    rng = np.random.default_rng(7)
    img = rng.random((1, 24, 28, 1), dtype=np.float32)
    df = _smooth((1, 24, 28, 2), 3.0, seed=8)
    g = rng.standard_normal((1, 24, 28, 1)).astype(np.float32)
    m_t = torch.from_numpy(img).requires_grad_(True)
    d_t = torch.from_numpy(df).requires_grad_(True)
    gm, gd = torch.autograd.grad((port_warp.warp_image(m_t, d_t) * torch.from_numpy(g)).sum(),
                                 (m_t, d_t))
    rm, rd = jax.grad(lambda m, d: jnp.sum(jax_warp.warp_image(m, d) * g), (0, 1))(
        jnp.asarray(img), jnp.asarray(df))
    _close(gm.numpy(), rm, 1e-5)
    _close(gd.numpy(), rd, 1e-5)
    v = _smooth((1, 24, 28, 2), 6.0, seed=9)
    gv = rng.standard_normal(v.shape).astype(np.float32)
    v_t = torch.from_numpy(v).requires_grad_(True)
    (got,) = torch.autograd.grad((port_warp.integrate_svf(v_t, 7) * torch.from_numpy(gv)).sum(),
                                 v_t)
    ref = jax.grad(lambda u: jnp.sum(jax_warp.integrate_svf(u, 7) * gv))(jnp.asarray(v))
    _close(got.numpy(), ref, 1e-4)


def test_resize_and_pooling_on_two_axes_match_jax():
    x = np.random.default_rng(10).random((2, 23, 28, 3), dtype=np.float32)
    xt = torch.from_numpy(x)
    _close(resize.avg_pool_ceil(xt).numpy(), jax_resize.avg_pool_ceil(jnp.asarray(x)), 1e-6)
    for out in ((12, 14), (46, 56), (40, 31)):
        _close(resize.resize_linear(xt, out).numpy(),
               jax_resize.resize_linear(jnp.asarray(x), out), 1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(11)
    y_pred = rng.random((2, 24, 28, 1), dtype=np.float32)
    y_true = rng.random((2, 24, 28, 1), dtype=np.float32)
    df = _smooth((2, 24, 28, 2), 2.0, seed=12)
    mu, sigma = rng.standard_normal((2, 12, 14, 2)), rng.random((2, 12, 14, 2)) + 0.5
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))
    for win in (3, 9):
        np.testing.assert_allclose(
            float(losses.ncc_loss(t(y_pred), t(y_true), win, 0.05)),
            float(jax_losses.ncc_loss(j(y_pred), j(y_true), win, 0.05)), rtol=1e-5)
    np.testing.assert_allclose(losses.jacobian_det(t(df)).numpy(),
                               np.asarray(jax_losses.jacobian_det(j(df))), rtol=1e-5, atol=1e-6)
    for name, got, ref in (
            ("jdet_std", losses.jdet_std(t(df), 0.025), jax_losses.jdet_std(j(df), 0.025)),
            ("l2_reg", losses.l2_reg(t(df), 0.025), jax_losses.l2_reg(j(df), 0.025)),
            ("l2_loss", losses.l2_loss(t(y_pred), t(y_true)),
             jax_losses.l2_loss(j(y_pred), j(y_true))),
            ("kl", losses.kl_two_gauss_diag_cov(t(mu), t(sigma), t(0 * mu), t(1 + 0 * mu)),
             jax_losses.kl_two_gauss_diag_cov(j(mu), j(sigma), j(0 * mu), j(1 + 0 * mu))),
            ("kl_nondiagonal", losses.kl_nondiagonal(t(mu), t(sigma)),
             jax_losses.kl_nondiagonal(j(mu), j(sigma)))):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, err_msg=name)


# ----------------------------------------------------------------------
# the model and the UQ request
# ----------------------------------------------------------------------

TRAIN_KW = dict(KW, batch_size=2)


@pytest.fixture(scope="module")
def jax_2d():
    """One JAX init of the 2D model (each init compiles anew): the train
    state at TRAIN_KW, and its weights with BatchNorm statistics
    randomised as `jax_model_and_variables` does, for the eval tests."""
    jm = JaxModel(JaxConfig(**TRAIN_KW))
    state, tx = jax_create_train_state(jm, seed=0)
    rng = np.random.default_rng(102)
    stats = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.2).astype(np.float32), state.batch_stats)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: np.abs(a) + 0.5 if path[-1].key == "var" else a, stats)
    variables = {"params": jax.tree.map(np.asarray, state.params), "batch_stats": stats}
    return jm, state, tx, variables


def test_from_jax_variables_carries_2d_kernels(jax_2d):
    variables = jax_2d[3]
    cfg = PULPoConfig(**KW)
    sd = from_jax_variables(variables, cfg)
    k = variables["params"]["downpath"]["down_block_0"]["ConvUnit_0"]["TorchConv_0"]["Conv_0"]
    w = sd["downpath.down_blocks.0._op.0._op.0.weight"]
    assert tuple(w.shape) == (4, 2, 3, 3)  # flax (3, 3, I, O) -> (O, I, 3, 3)
    np.testing.assert_array_equal(w.numpy(), np.transpose(np.asarray(k["kernel"]), (3, 2, 0, 1)))
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(sd)  # strict: every name and shape of the 2D network
    assert all(v.dim() in (1, 4) for v in sd.values())
    back = import_torch_state_dict(model.state_dict(), JaxConfig(**KW))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_deterministic_forward_matches_jax(jax_2d):
    jm, _, _, variables = jax_2d
    model = port_model(variables, **KW)
    rng = np.random.default_rng(13)
    x, y = (rng.random((2, *KW["input_size"], 1), dtype=np.float32) for _ in range(2))
    ref = jm.apply_eval(variables, jnp.asarray(x), jnp.asarray(y), deterministic=True)
    got = model.apply_eval(x, y, deterministic=True)
    for name, dr, dg in zip(NAMES, ref, got):
        assert sorted(dr) == sorted(dg), name
        for l in dr:
            np.testing.assert_allclose(dg[l].numpy(), np.asarray(dr[l]), rtol=0, atol=1e-4,
                                       err_msg=f"{name}[{l}]")


def test_uq_matches_jax_leaf_by_leaf(jax_2d):
    jm, _, _, variables = jax_2d
    model = port_model(variables, **KW)
    rng = np.random.default_rng(14)
    x, y = (rng.random((1, *KW["input_size"], 1), dtype=np.float32) for _ in range(2))
    mask = (x > 0.4).astype(np.float32)
    lm = np.array([[[3.0, 4.0], [10.5, 20.0], [20.2, 26.9]]], np.float32)
    key = jax.random.key(5)
    N = 4
    ref = jax_uq(jm, variables, jnp.asarray(x), jnp.asarray(y), N, key, mask=jnp.asarray(mask),
                 chunk=2, keep_samples=True, lm=jnp.asarray(lm))
    noise = {l: torch.from_numpy(v) for l, v in jax_noise(jm.cfg, key, N, 1).items()}
    got = predict_with_uncertainty(model, x, y, N, mask=mask, chunk=2, keep_samples=True,
                                   lm=lm, noise=noise)
    for field in UQResult._fields:
        r, g = getattr(ref, field), getattr(got, field)
        if field == "sample_landmarks":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)
            continue
        assert sorted(r) == sorted(g), field
        for l in r:
            assert tuple(g[l].shape) == tuple(r[l].shape), (field, l)
            np.testing.assert_allclose(comparable(field, g[l].numpy()), comparable(field, r[l]),
                                       rtol=0, atol=1e-4, err_msg=f"{field}[{l}]")


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step_2d(jax_2d):
    """The JAX `make_train_step` at TRAIN_KW on one batch, evaluated in
    float64 from the float32 initial state (why: test_torch_train.py),
    with its gradients and draws. The gradients are the step's own:
    Adam's first moment after one step from zero is (1 - b1) * g."""
    jm, state, tx, _ = jax_2d
    jcfg = jm.cfg
    rng = np.random.default_rng(15)
    batch = {k: rng.random((2, *jcfg.input_size, 1), dtype=np.float32) for k in ("x", "y")}
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

        draws = jax.jit(lambda p, bs: jm.apply_train(
            {"params": p, "batch_stats": bs}, jb["x"], jb["y"], sample_rng)[0][:3])
        mus, sigmas, samples = draws(state.params, state.batch_stats)
        new_state, metrics = jax.jit(jax_make_train_step(jm, tx))(state, jb)
        grads = jax.tree.map(lambda m: m / 0.1, new_state.opt_state[0].mu)
        noise = {l: torch.from_numpy(np.array((samples[l] - mus[l]) / sigmas[l]))
                 for l in mus}
        return dict(batch=batch, before=before,
                    after={"params": to_np(new_state.params),
                           "batch_stats": to_np(new_state.batch_stats)},
                    grads={"params": to_np(grads), "batch_stats": before["batch_stats"]},
                    metrics=to_np(metrics), noise=noise)


def test_one_train_step_matches_jax(jax_step_2d):
    r = jax_step_2d
    cfg = PULPoConfig(**TRAIN_KW)
    model = PULPoModel(cfg, device="cpu")
    state, tx = create_train_state(model, seed=0)
    model.load_state_dict(from_jax_variables(r["before"], cfg))

    grads, _, _ = compute_grads(model, r["batch"], noise=r["noise"])
    ref_grads = {k: v.float() for k, v in from_jax_variables(r["grads"], cfg).items()}
    top = max(float(ref_grads[n].abs().max()) for n in grads)
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-2 * top)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 1e-3 * scale, (name, err, scale)

    state, metrics = make_train_step(model, tx)(state, r["batch"], noise=r["noise"])
    for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(r["metrics"][k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert state.step == 1 and not state.nan_flag
    after = from_jax_variables(r["after"], cfg)
    got = model.state_dict()  # the committed BatchNorm statistics among them
    for name, ref in after.items():
        atol = 1e-5 if "running_" in name else 2 * cfg.lr
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


def test_synthetic_2d_pairs_match_jax():
    from pulpo_tpu.data.synthetic import SyntheticDataset as JaxSynthetic

    a = SyntheticDataset(shape=(64, 64), n=3, lms=True, seed=4)
    b = JaxSynthetic(shape=(64, 64), n=3, lms=True, seed=4)
    pa, pb = a.get_pair(1, np.random.default_rng(2)), b.get_pair(1, np.random.default_rng(2))
    for k in ("x", "y", "lm_x", "lm_y"):
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert pa["x"].shape == (64, 64, 1) and pa["lm_x"].shape == (5, 2)


def test_train_cli_trains_the_2d_configuration(tmp_path):
    """The ROADMAP repro: `train_cli --ndims 2 --dataset synthetic` on the
    CPU trains with finite losses (the 64x64 synthetic default)."""
    run_dir = train_cli.main([
        "--accelerator", "cpu", "--dataset", "synthetic", "--ndims", "2", "--total_levels",
        "3", "--latent_levels", "2", "--n0", "8", "--max_steps", "2", "--skip_eval",
        "--run_dir", str(tmp_path)])
    cfg = PULPoConfig.from_json((run_dir / "config.json").read_text())
    assert cfg.input_size == (64, 64) and cfg.ndims == 2
    rows = read_metrics(run_dir)  # validation after every step (8 pairs x 0.1 < 1)
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
            assert np.isfinite(r[f"val/{k}"]), (r["step"], k)
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    assert "latest.pt" in ckpts and not any("nan" in n for n in ckpts)
    assert read_checkpoint(run_dir, "latest")["step"] == 2


def test_trainer_resumes_a_2d_run_bit_exactly(tmp_path):
    """2 steps in one run equal 1 step, then a resumed run of 1 step."""
    cfg = PULPoConfig(**KW, dataset="synthetic", batch_size=2, max_epochs=2)
    ds = _SamePair(cfg.input_size)
    loaders = lambda: (DataLoader(ds, 2), DataLoader(ds, 2, seed=1))
    whole = Trainer(cfg, run_dir=tmp_path, experiment="whole", device="cpu")
    ref = whole.fit(*loaders(), max_steps=2)
    first = Trainer(cfg, run_dir=tmp_path, experiment="first", device="cpu")
    first.fit(*loaders(), max_steps=1)
    second = Trainer(cfg, run_dir=tmp_path, experiment="second", device="cpu")
    (second.run_dir / "checkpoints").mkdir()
    (first.run_dir / "checkpoints" / "latest.pt").replace(
        second.run_dir / "checkpoints" / "latest.pt")
    got = second.fit(*loaders(), max_steps=2, resume=True)
    for t in (whole, first, second):
        t.close()
    assert got.step == 2
    assert payload_difference(state_payload(got), state_payload(ref)) is None
