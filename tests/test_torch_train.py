"""The port's training path against the JAX package's, on the CPU.

Weights cross with `from_jax_variables`; the posterior draws are the
JAX step's own, recovered from its outputs as ``(samples - mus) /
sigmas`` and fed to the port through `noise=`. The one-step reference
is the JAX step evaluated in float64 (see `jax_step_result`).
Tolerances (port in float32): losses and metrics rtol 1e-4; gradients
within 1e-3 of each leaf's largest magnitude;
params after one Adam step atol 2*lr (Adam's first step is
``lr * sign(g)``, so a gradient within an ulp of 0 may flip a parameter
by 2*lr); BatchNorm statistics atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.train.step import compute_losses as jax_compute_losses
from pulpo_tpu.train.step import create_train_state as jax_create_train_state
from pulpo_tpu.train.step import make_eval_step as jax_make_eval_step
from pulpo_tpu.train.step import make_train_step as jax_make_train_step
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.models.blocks import BatchNorm
from pulpo_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from pulpo_tpu_torch.train.step import compute_grads
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4, batch_size=2)
METRICS = ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss")
LEVEL_METRICS = ("levels/kl", "levels/recon", "levels/reg",
                 "levels/mean_posterior_mu", "levels/mean_posterior_sigma")


def _batch(size, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"x": rng.random((b, *size, 1), dtype=np.float32),
            "y": rng.random((b, *size, 1), dtype=np.float32)}


def _eps(outs):
    """The draws behind a JAX forward: (samples - mus) / sigmas per level."""
    mus, sigmas, samples = outs[0], outs[1], outs[2]
    return {l: torch.from_numpy(np.asarray((samples[l] - mus[l]) / sigmas[l]))
            for l in mus}


def _close_metrics(got, ref, rtol=1e-4, atol=1e-6):
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, atol=atol,
                                   err_msg=k)
    for k in LEVEL_METRICS:
        for l in ref[k]:
            np.testing.assert_allclose(float(got[k][l]), float(ref[k][l]), rtol=rtol,
                                       atol=atol, err_msg=f"{k}[{l}]")
    assert bool(got["nan_flag"]) == bool(ref["nan_flag"])


def _port_from_jax(variables, cfg):
    model = PULPoModel(cfg, device="cpu")
    state, tx = create_train_state(model, seed=0)
    model.load_state_dict(from_jax_variables(variables, cfg))
    return model, state, tx


# ----------------------------------------------------------------------
# train-mode BatchNorm
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_train_batchnorm_matches_flax(dtype, atol):
    """Batch statistics (fast biased variance in float32), flax's
    normalisation order and the running update 0.9 * old + 0.1 * batch.
    bf16 outputs: a few bf16 ulps at values of order 3."""
    rng = np.random.default_rng(0)
    c = 6
    x = (rng.standard_normal((2, 5, 6, 7, c)) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) + 1).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = (np.abs(rng.standard_normal(c)) + 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)
    ref, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean0, "var": var0}},
                        xj, mutable=["batch_stats"])

    mod = BatchNorm(c)
    with torch.no_grad():
        for t, v in ((mod.weight, scale), (mod.bias, bias), (mod.running_mean, mean0),
                     (mod.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(dtype)
    got = mod(xt, train=True)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0, atol=atol)
    new_mean, new_var = mod.pending
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=1e-5)
    # the buffers are left for the step to commit
    np.testing.assert_array_equal(mod.running_mean.numpy(), mean0)


# ----------------------------------------------------------------------
# one whole step against pulpo_tpu.train.step
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step_result():
    """The JAX package's `make_train_step` at KW on one batch, evaluated
    in float64 from the float32 initial state: its state before and
    after, its metrics, its gradients (the same loss, `jax.grad`) and its
    draws.

    Why float64: in float32 the JAX package's own down-path gradients
    are off by up to ~5 % of their scale on this host (XLA:CPU's long
    float32 reductions in the batch statistics and their backward),
    while the port's float32 gradients are within 1e-5 of the float64
    ones. The port is held to the exact arithmetic, not to that
    rounding."""
    jcfg = JaxConfig(**KW)
    jm = JaxModel(jcfg)
    state, tx = jax_create_train_state(jm, seed=0)
    batch = _batch(jcfg.input_size)
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
                total, _ = jax_compute_losses(jcfg, outs, jb["x"], jb["y"], None, None)
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


def test_one_train_step_matches_jax(jax_step_result):
    """Gradients within 1e-3 of each leaf's largest magnitude. A conv
    bias that feeds a train BatchNorm has gradient 0 exactly (the batch
    mean removes it); its rounding noise is held to 1e-3 of 1 % of the
    network's largest gradient."""
    r = jax_step_result
    cfg = PULPoConfig(**KW)
    model, state, tx = _port_from_jax(r["before"], cfg)

    grads, _, _ = compute_grads(model, r["batch"], noise=r["noise"])
    ref_grads = {k: v.float() for k, v in from_jax_variables(r["grads"], cfg).items()}
    assert set(grads) <= set(ref_grads)
    top = max(float(ref_grads[n].abs().max()) for n in grads)
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-2 * top)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 1e-3 * scale, (name, err, scale)

    step = make_train_step(model, tx)
    state, metrics = step(state, r["batch"], noise=r["noise"])
    _close_metrics(metrics, r["metrics"])
    assert state.step == 1 and not state.nan_flag and state.opt_state.count == 1

    after = from_jax_variables(r["after"], cfg)
    got = model.state_dict()
    lr = cfg.lr
    for name, ref in after.items():
        atol = 1e-5 if "running_" in name else 2 * lr
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


# ----------------------------------------------------------------------
# NaN guard, loss curve, eval step, remat
# ----------------------------------------------------------------------

def _tiny(**kw):
    base = dict(input_size=(12, 14, 16), total_levels=3, latent_levels=2, n0=2,
                batch_size=2)
    base.update(kw)
    return PULPoConfig(**base)


def test_nan_guard_fires_and_freezes_state():
    """As tests/test_train.py: the state entering the NaN step is kept,
    the step count still advances, and the latch stays set."""
    cfg = _tiny()
    model = PULPoModel(cfg, device="cpu")
    state, tx = create_train_state(model, seed=0)
    step = make_train_step(model, tx)
    good = _batch(cfg.input_size)
    bad = _batch(cfg.input_size, seed=1)
    bad["x"][0] = np.nan

    state, metrics = step(state, good)
    assert not bool(metrics["nan_flag"])
    entering = {k: v.clone() for k, v in model.state_dict().items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    draw = state.rng.get_state().clone()

    state, metrics = step(state, bad)
    assert bool(metrics["nan_flag"]) and state.nan_flag
    for k, v in model.state_dict().items():
        assert torch.equal(v, entering[k]), k
    assert all(torch.equal(state.opt_state.mu[k], mu[k]) for k in mu)
    assert state.opt_state.count == 1 and state.step == 2
    assert not torch.equal(state.rng.get_state(), draw)  # the seed advanced

    state, metrics = step(state, good)  # sticky: a clean step stays frozen
    assert bool(metrics["nan_flag"]) and state.step == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, entering[k]), k


def test_loss_decreases_on_a_fixed_pair():
    """Overfit one pair for 20 steps (as tests/test_train.py), after an
    eval forward in the same process (its inference-mode caches must not
    leak into the train graph)."""
    cfg = _tiny()
    model = PULPoModel(cfg, device="cpu")
    state, tx = create_train_state(model, seed=0)
    batch = _batch(cfg.input_size)
    model.apply_eval(batch["x"], batch["y"], seed=1)
    step = make_train_step(model, tx)
    w0 = model.state_dict()["downpath.down_blocks.0._op.0._op.0.weight"].clone()
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch)
        losses.append(float(metrics["total_loss"]))
    assert np.isfinite(losses).all() and not state.nan_flag
    assert not torch.equal(w0, model.state_dict()["downpath.down_blocks.0._op.0._op.0.weight"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_eval_step_matches_jax():
    """Eval BatchNorm with non-trivial running statistics, eval velocity
    head, the same losses."""
    jm = JaxModel(JaxConfig(**KW))
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(2)))
    rng = np.random.default_rng(102)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.abs(rng.standard_normal(a.shape)) * 0.2 + 0.5
                         if path[-1].key == "var" else rng.standard_normal(a.shape) * 0.2
                         ).astype(np.float32), v["batch_stats"])
    variables = {"params": v["params"], "batch_stats": stats}
    cfg = PULPoConfig(**KW)
    model, _, _ = _port_from_jax(variables, cfg)
    batch = _batch(cfg.input_size, seed=3)
    rng = jax.random.key(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, ref_imgs = jax_make_eval_step(jm)(variables["params"], variables["batch_stats"],
                                           jb, rng)
    outs = jm.apply_eval(variables, jb["x"], jb["y"], rng)
    got, imgs = make_eval_step(model)(batch, noise=_eps(outs))
    _close_metrics(got, jax.tree.map(np.asarray, ref))
    np.testing.assert_allclose(imgs["y_pred"].numpy(), np.asarray(ref_imgs["y_pred"]),
                               rtol=0, atol=1e-4)


def test_dice_loss_warps_the_segmentation():
    """recon_loss with dice: `transform_segmentation` feeds the loss and
    the step stays finite."""
    cfg = _tiny(recon_loss=("ncc", "dice"), segs=True)
    model = PULPoModel(cfg, device="cpu")
    state, tx = create_train_state(model, seed=0)
    batch = _batch(cfg.input_size)
    labels = np.random.default_rng(3).integers(0, 4, (2, *cfg.input_size))
    onehot = np.eye(4, dtype=np.float32)[labels]
    batch["seg_x"], batch["seg_y"] = onehot, onehot[:, ::-1].copy()
    state, metrics = make_train_step(model, tx)(state, batch)
    assert np.isfinite(float(metrics["total_loss"])) and not state.nan_flag


@pytest.mark.parametrize("knob", [dict(remat=True), dict(remat_down=(0,))])
def test_remat_raises(knob):
    """A remat config trains: its step raises nothing and gives the plain
    step's loss (bit for bit: tests/test_torch_remat.py)."""
    losses = []
    for kw in (knob, {}):
        cfg = _tiny(**kw)
        model = PULPoModel(cfg, device="cpu")
        state, tx = create_train_state(model, seed=0)
        state, metrics = make_train_step(model, tx)(state, _batch(cfg.input_size))
        assert state.step == 1 and not state.nan_flag
        losses.append(metrics["total_loss"])
    assert torch.equal(losses[0], losses[1])
