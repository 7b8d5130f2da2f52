"""The port's DIF-VoxelMorph baseline (`models/voxelmorph.py`), its
evaluation tables and `compare_models` against the JAX package's, on
the CPU, at the 12x14x16 size of tests/test_vxm.py.

Weights cross with `compat.vxm_from_jax_variables` (and, for the PULPo
models of `compare_models`, `compat.from_jax_variables`); the draws are
the JAX package's own, injected into the port. Tolerances:
- the deterministic forward and `predict` (N = 3 with the JAX draws):
  every output within 1e-5 of its scale (its largest magnitude);
- one training step's loss and gradients against the JAX loss taken in
  float64 (as tests/test_torch_train.py does: XLA:CPU's float32
  gradients are not a reference at 1e-5): the loss rtol 1e-5, each
  gradient leaf within 1e-4 of its largest magnitude;
- the tables: the same NaN pattern, the rounded tables (performance,
  `compare_models`) |diff| <= 1e-3 (one rounding step at 3 decimals),
  the unrounded uncertainty table rtol 1e-4 (atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.eval.evaluator import Evaluate as JaxEvaluate
from pulpo_tpu.models.voxelmorph import VxmModel as JaxVxm
from pulpo_tpu_torch.compat import vxm_from_jax_variables
from pulpo_tpu_torch.eval.evaluator import Evaluate
from pulpo_tpu_torch.models.voxelmorph import VxmModel, make_vxm_train_step, vxm_grads
from test_torch_eval import _same_table
from test_torch_model import jax_model_and_variables, port_model
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_uq import jax_noise

SIZE = (12, 14, 16)
HALF = (6, 7, 8)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _pair(seed=0, b=1):
    rng = np.random.default_rng(seed)
    return (rng.random((b, *SIZE, 1), dtype=np.float32),
            rng.random((b, *SIZE, 1), dtype=np.float32))


def jax_draws(key, n, b=1):
    """The JAX `predict`'s draws: one normal of the SVF's shape a key."""
    return np.stack([np.asarray(jax.random.normal(k, (b, *HALF, 3), jnp.float32))
                     for k in jax.random.split(key, n)])


@pytest.fixture(scope="module")
def vxm():
    jm = JaxVxm(SIZE)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    model = VxmModel(SIZE, device="cpu")
    model.load_state_dict(vxm_from_jax_variables(variables))
    return jm, variables, model


def test_vxm_weights_cross_and_init_from_a_seed(vxm):
    _, variables, model = vxm
    sd = model.state_dict()
    assert len(sd) == 2 * 12 and sd["convs.0.weight"].shape == (16, 2, 3, 3, 3)
    np.testing.assert_array_equal(
        sd["flow_mu.weight"].numpy(),
        np.transpose(variables["params"]["flow_mu"]["Conv_0"]["kernel"], (4, 3, 0, 1, 2)))
    a, b = VxmModel(SIZE, device="cpu"), VxmModel(SIZE, device="cpu")
    torch.testing.assert_close(a.init(3), b.init(3), rtol=0, atol=0)
    assert not torch.equal(a.init(4)["convs.0.weight"], b.state_dict()["convs.0.weight"])


@pytest.mark.parametrize("deterministic", [True, False])
def test_vxm_forward_matches_jax(vxm, deterministic):
    jm, variables, model = vxm
    x, y = _pair()
    key = jax.random.key(5)
    ref = jm.apply(variables, x, y, rng=key, deterministic=deterministic)
    eps = None if deterministic else np.asarray(jax.random.normal(key, (1, *HALF, 3)))
    got = model.apply(x, y, deterministic=deterministic, eps=eps)
    assert got[0].shape == x.shape and got[1].shape == (1, *SIZE, 3)
    for g, r in zip((*got[:2], *got[2]), (*ref[:2], *ref[2])):
        assert _rel(g.numpy(), r) <= 1e-5


def test_vxm_predict_matches_jax_with_its_draws(vxm):
    jm, variables, model = vxm
    x, y = _pair(1)
    key, N = jax.random.key(1), 3
    ref = jm.predict(variables, x, y, N, key)
    got = model.predict(x, y, N, eps=jax_draws(key, N))
    assert got[4].shape == (N, 1, *SIZE, 1) and got[2].shape == (1, *SIZE)
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= 1e-5
    assert float(got[2].max()) > 0  # the samples spread


def test_vxm_train_step_matches_jax_in_float64(vxm):
    """The JAX VoxelMorph-diff loss and its gradients, evaluated in
    float64 from the float32 weights, against the port's float32 step on
    the same draws; then one Adam step of the port changes the weights."""
    from pulpo_tpu.ops.losses import kl_nondiagonal

    jm, variables, model = vxm
    x, y = _pair(2)
    eps = np.asarray(jax.random.normal(jax.random.key(7), (1, *HALF, 3)))

    with jax.enable_x64():
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        e64 = jnp.asarray(eps, jnp.float64)

        def loss_fn(params):
            # the JAX step's loss (pulpo_tpu/models/voxelmorph.py:150-158) with
            # the draw injected: mu + sigma * eps, as the module computes z
            moved, _df, (mu, sigma, _z) = _apply_with_eps(jm, params, x, y, e64)
            recon = jnp.mean((moved - jnp.asarray(y, jnp.float64)) ** 2) / (2 * 0.02**2)
            kl = kl_nondiagonal(mu, sigma, prior_lambda=20.0) / float(jnp.size(mu))
            return recon + kl

        ref_loss, ref_grads = jax.value_and_grad(loss_fn)(p64)
    grads, metrics = vxm_grads(model, {"x": x, "y": y}, torch.from_numpy(eps))
    np.testing.assert_allclose(float(metrics["total_loss"]), float(ref_loss), rtol=1e-5)
    ref = vxm_from_jax_variables({"params": jax.tree.map(np.asarray, ref_grads)})
    assert sorted(ref) == sorted(grads)
    for name, g in grads.items():
        assert _rel(g.numpy(), ref[name].numpy()) <= 1e-4, name

    tx = torch.optim.Adam(model.module.parameters(), lr=1e-4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        m = make_vxm_train_step(model, tx, seed=0)({"x": x, "y": y})
        assert np.isfinite(float(m["total_loss"]))
        assert all(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    finally:
        model.load_state_dict(before)


def _apply_with_eps(jm, params, x, y, eps):
    """The JAX module's forward with an injected draw: `jax.random.normal`
    patched to return `eps` while the module is applied."""
    normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=None: eps.astype(dtype or eps.dtype)
    try:
        return jm.module.apply({"params": params}, jnp.asarray(x, jnp.float64),
                               jnp.asarray(y, jnp.float64), rng=jax.random.key(0))
    finally:
        jax.random.normal = normal


class _Shim:
    class cfg:
        input_size = SIZE
        ndims = 3


def _vxm_evaluators(vxm, tmp_path, lms):
    _, variables, model = vxm
    ref, got = JaxEvaluate(), Evaluate(device="cpu")
    for ev in (ref, got):
        ev.model = _Shim()
        ev.load_data(task="synthetic", segs=False, lms=lms, mask=False)
    ref.load_vxm(variables, SIZE, output_dir=tmp_path / "jax")
    ref.vxm = vxm[0]  # the same JAX model, whose compiled programs the module shares
    got.load_vxm(model.state_dict(), SIZE, output_dir=tmp_path / "port")
    return ref, got


def _inject_vxm_draws(got, requests, N, monkeypatch):
    """The JAX Evaluate's keys (key(0) split once per request) as draws,
    handed to the port's `predict` calls in order."""
    key, draws = jax.random.key(0), []
    for _ in range(requests):
        key, sub = jax.random.split(key)
        draws.append(jax_draws(sub, N))
    draws = iter(draws)
    predict = got.vxm.predict
    monkeypatch.setattr(got.vxm, "predict",
                        lambda x, y, n, seed=0: predict(x, y, n, eps=next(draws)))
    return draws


@pytest.mark.parametrize("artifact", ["", "blur"])
def test_vxm_tables_match_jax(vxm, tmp_path, monkeypatch, artifact):
    ref_ev, got_ev = _vxm_evaluators(vxm, tmp_path, lms=True)
    _same_table(got_ev.performance_vxm(1, artifact=artifact),
                ref_ev.performance_vxm(1, artifact=artifact, save=False), rtol=0, atol=1e-3 + 1e-9)
    N = 3
    requests = sum(len(dl.dataset) for dl in got_ev.loaders)
    draws = _inject_vxm_draws(got_ev, 2 * requests, N, monkeypatch)
    _same_table(got_ev.performance_vxm(N, artifact=artifact),
                ref_ev.performance_vxm(N, artifact=artifact, save=False), rtol=0, atol=1e-3 + 1e-9)
    got = got_ev.uncertainty_vxm(N, artifact=artifact)
    _same_table(got, ref_ev.uncertainty_vxm(N, artifact=artifact, save=False),
                rtol=1e-4, atol=1e-6)
    assert next(draws, None) is None
    assert np.isfinite(got[("test", "LM_NCC")]).all() and np.isfinite(got[("val", "NCC")]).all()
    for sub in ("loss", "uncertainty"):
        assert (tmp_path / "port" / sub / f"loss_table_vxm{artifact}.csv").exists()


def test_compare_models_matches_jax(tmp_path, monkeypatch):
    """Two PULPo weight sets as two runs (`load_model` patched on both
    sides), their N = 2 mean-SVF predictions on the JAX draws."""
    kw = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4)
    jm, va = jax_model_and_variables(seed=11, **kw)
    # a second weight set on the same JAX model (one compile of its programs)
    vb = {"params": jax.tree.map(lambda a: a * np.float32(0.8), va["params"]),
          "batch_stats": va["batch_stats"]}
    runs = {"run_a": (jm, va), "run_b": (jm, vb)}
    ref_ev, got_ev = JaxEvaluate(), Evaluate(device="cpu")

    def jax_load(rd):
        jm, variables = runs[rd]
        return ref_ev.set_model(jm, variables, output_dir=tmp_path / "jax_eval")

    def port_load(rd):
        return got_ev.set_model(port_model(runs[rd][1], **kw), output_dir=tmp_path / "port_eval")

    monkeypatch.setattr(ref_ev, "load_model", jax_load)
    monkeypatch.setattr(got_ev, "load_model", port_load)
    N, cfg = 2, jm.cfg
    key, draws = jax.random.key(0), []
    for _ in range(2 * 8):  # two models x 8 pairs
        key, sub = jax.random.split(key)
        draws.append({l: torch.from_numpy(v).flatten(0, 1)  # (N * B, ...), sample-major
                      for l, v in jax_noise(cfg, sub, N, 1).items()})
    draws = iter(draws)
    from pulpo_tpu_torch.models.api import PULPoModel

    predict = PULPoModel.predict
    monkeypatch.setattr(PULPoModel, "predict",
                        lambda self, x, y, n, seed=0: predict(self, x, y, n, noise=next(draws)))
    kw_cmp = dict(model_names=["A", "B"], task="synthetic", segs=True, N=N)
    ref = ref_ev.compare_models(["run_a", "run_b"], output_dir=tmp_path / "jax_cmp", **kw_cmp)
    got = got_ev.compare_models(["run_a", "run_b"], output_dir=tmp_path / "cmp", **kw_cmp)
    assert next(draws, None) is None
    assert got.index == ["A", "B"] and got.shape == (2, 12)
    _same_table(got, ref, rtol=0, atol=1e-3 + 1e-9)
    assert not np.isnan(got[("val", "Dice")]).any() and not np.isnan(got[("test", "RMSE")]).any()
    assert (tmp_path / "cmp" / "loss_table.csv").exists()
    assert (tmp_path / "cmp" / "loss_table.tex").exists()
