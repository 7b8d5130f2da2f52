"""The port's depth-sharded forward and training step
(pulpo_tpu_torch/parallel/spatial.py) on the CPU.

The ranks are four processes over gloo (tests/torch_spatial_worker.py,
which imports no JAX), launched once, meeting at a `file://`
rendezvous under the test's temporary directory. They run the forward
at mesh (data 1, space 4) and the training step at mesh (2, 2). The
references are the JAX package's `make_spatial_forward` on 4 and
`make_spatial_train_step` on 2 x 2 of conftest's 8 virtual devices
(the step in float64, with SGD, so that the update is the gradient),
and the port's own unsharded forward and step on the same weights,
inputs and draws.

The configurations: input 16 x 14 x 16, n0 2, 3 levels (the JAX tests'
`tests/test_parallel.py:124,219`), whose coarsest level (depth 4, slabs
of one plane at space 4) runs replicated, and 4 levels, whose two
coarsest levels (depths 4 and 2) do. The weights are the port's initial
ones, imported into flax (`jax_variables`). The 4-level forward is held
to the port's unsharded forward only (itself held to the JAX forward by
tests/test_torch_model.py).

Tolerances:
- the sharded forward (its slabs joined) against the JAX sharded
  forward: 1e-5 of each output's scale (the JAX test holds its own
  sharded forward to its unsharded one at rtol 1e-4, atol 1e-5);
- against the port's unsharded forward, deterministic and sampled from
  the same seed: 2e-6 of scale (the halo convs and the band resizes sum
  the same float32 terms in another order; measured <= 6e-7);
- the (2, 2) step against the float64 JAX step: losses rtol 1e-4,
  gradients within 1e-3 of each leaf's scale (XLA:CPU's float32 step is
  ~5 % off, tests/test_torch_train.py; the port's float32 step is held
  as tests/test_torch_parallel.py holds the data-parallel one), running
  statistics atol 1e-5;
- against the port's unsharded step: losses rtol 1e-5, gradients within
  2e-5 of each leaf's scale plus the unsharded step's own float32 error
  on that leaf (its distance from the float64 JAX gradient), the rule of
  tests/test_torch_parallel.py at twice its 1e-5: the slabs' halo convs,
  partial losses and summed squaring cotangents reorder more float32
  sums than the data-parallel split does. The leaves that move most are
  the conv biases that feed a train BatchNorm, whose exact gradient is 0
  (their scale is 1 % of the largest leaf's); measured 1.7e-5 at most.
  Running statistics within 1e-5 of scale;
- the ranks' gradients, statistics, metrics and updated states: bit-equal.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pulpo_tpu.compat.torch_import import import_torch_state_dict
from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.parallel.spatial import make_2d_mesh as jax_make_2d_mesh
from pulpo_tpu.parallel.spatial import make_spatial_forward as jax_make_spatial_forward
from pulpo_tpu.parallel.spatial import make_spatial_train_step as jax_make_spatial_train_step
from pulpo_tpu.parallel.spatial import replicated as jax_replicated
from pulpo_tpu.parallel.spatial import volume_batch_spec as jax_volume_batch_spec
from pulpo_tpu.train.step import TrainState as JaxTrainState
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.parallel import spatial
from pulpo_tpu_torch.train.step import compute_grads
from test_torch_threads import one_torch_thread  # noqa: F401

HERE = pathlib.Path(__file__).resolve().parent
SIZE = (16, 14, 16)
FORWARD = [dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2),
           dict(input_size=SIZE, total_levels=4, latent_levels=3, n0=2)]
STEP = dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2, batch_size=2)
LOSSES = ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss")
WORLD = 4

to_np = lambda t: jax.tree.map(np.asarray, t)


def jax_variables(kw: dict, seed: int) -> dict:
    """Flax variables of the port's initial weights from `seed` (the JAX
    init's compile costs more than every forward of these tests)."""
    model = PULPoModel(PULPoConfig(**kw), device="cpu")
    model.init(seed)
    return to_np(import_torch_state_dict(model.state_dict(), JaxConfig(**kw)))


@pytest.fixture(scope="module")
def jax_forward():
    """Per FORWARD config: the weights and one pair; for the first, the
    JAX sharded forward's level-0 final df and warped image at mesh
    (1, 4) (the second is held to the port's unsharded forward, which
    tests/test_torch_model.py holds to the JAX one: one JAX compile
    fewer)."""
    if jax.device_count() < WORLD:
        pytest.skip("needs 4 JAX devices")
    mesh = jax_make_2d_mesh(1, 4)
    out = []
    for i, kw in enumerate(FORWARD):
        variables = jax_variables(kw, i)
        rng = np.random.default_rng(10 + i)
        x, y = (rng.random((1, *SIZE, 1), dtype=np.float32) for _ in "xy")
        case = dict(variables=variables, x=x, y=y)
        if i == 0:
            df, warped = jax_make_spatial_forward(JaxModel(JaxConfig(**kw)), mesh)(
                jax.device_put(variables, jax_replicated(mesh)),
                jax.device_put(x, jax_volume_batch_spec(mesh)),
                jax.device_put(y, jax_volume_batch_spec(mesh)), jax.random.key(1))
            case.update(df=np.asarray(df), warped=np.asarray(warped))
        out.append(case)
    return out


@pytest.fixture(scope="module")
def jax_step():
    """The JAX sharded step at STEP on a (2, 2) mesh, in float64 with
    SGD(0.1) from the float32 initial state: the state before, the
    gradients ((before - after) / 0.1), the statistics after, the
    metrics and the step's draws."""
    jm = JaxModel(JaxConfig(**STEP))
    variables = jax_variables(STEP, 0)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"], opt_state=None,
                          rng=jax.random.key(0))
    rng = np.random.default_rng(1)
    batch = {k: rng.random((2, *SIZE, 1), dtype=np.float32) for k in "xy"}
    before = {"params": to_np(state.params), "batch_stats": to_np(state.batch_stats)}
    tx = optax.sgd(0.1)
    mesh = jax_make_2d_mesh(2, 2)
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(
            lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        params, stats = f64(state.params), f64(state.batch_stats)
        state = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        _, sample_rng = jax.random.split(state.rng)  # as train_step splits it
        outs, _ = jax.jit(jm.apply_train)({"params": params, "batch_stats": stats},
                                          jb["x"], jb["y"], sample_rng)
        noise = {l: np.asarray((outs[2][l] - outs[0][l]) / outs[1][l], np.float32)
                 for l in outs[0]}
        start = to_np(params)  # the step donates the state
        step = jax_make_spatial_train_step(jm, tx, mesh)
        new_state, metrics = step(jax.device_put(state, jax_replicated(mesh)),
                                  jax.device_put(jb, jax_volume_batch_spec(mesh)))
        grads = jax.tree.map(lambda a, b: (a - np.asarray(b)) / 0.1, start,
                             to_np(new_state.params))
    return dict(batch=batch, before=before, noise=noise, metrics=to_np(metrics),
                grads={"params": grads, "batch_stats": before["batch_stats"]},
                stats=to_np(new_state.batch_stats))


def _run_workers(tmp: pathlib.Path, inp: pathlib.Path, mode: str, world: int) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    for attempt in range(2):
        out = tmp / f"out{attempt}"
        out.mkdir()
        url = (tmp / f"rendezvous{attempt}").as_uri()
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_spatial_worker.py"), mode, str(r), str(world),
             url, str(inp), str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=tmp) for r in range(world)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=600)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n(timed out)")
        if all(p.returncode == 0 for p in procs):
            return [torch.load(out / f"rank_{r}.pt", weights_only=False) for r in range(world)]
        transient = any("timed out" in o.lower() or "timeout" in o.lower() for o in logs)
        if not (transient and attempt == 0):
            raise AssertionError("a worker failed:\n" + "\n----\n".join(o[-4000:] for o in logs))
    raise AssertionError("unreachable")


@pytest.fixture(scope="module")
def ranks(jax_forward, jax_step, tmp_path_factory):
    """The four ranks' outputs, from the JAX weights, inputs and draws."""
    tmp = tmp_path_factory.mktemp("spatial")
    inp = tmp / "input.pt"
    tensors = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    forward = [{"cfg": kw, "state_dict": from_jax_variables(c["variables"], PULPoConfig(**kw)),
                "x": torch.from_numpy(c["x"]), "y": torch.from_numpy(c["y"]), "seed": 3}
               for kw, c in zip(FORWARD, jax_forward)]
    step = {"cfg": STEP, "state_dict": from_jax_variables(jax_step["before"], PULPoConfig(**STEP)),
            "batch": tensors(jax_step["batch"]), "noise": tensors(jax_step["noise"])}
    torch.save({"forward": forward, "step": step}, inp)
    return _run_workers(tmp, inp, "spatial", WORLD)


def _joined(ranks, i, key):
    """The four slabs of forward case i joined along depth."""
    return [torch.cat([r["forward"][i][key][k] for r in ranks], dim=1) for k in (0, 1)]


def _close(got, ref, rel, what):
    ref = torch.as_tensor(np.array(ref)).double()
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    assert err <= rel * scale, (what, err, scale)


# ----------------------------------------------------------------------
# the forward at mesh (1, 4)
# ----------------------------------------------------------------------

def test_sharded_forward_matches_the_jax_sharded_forward(jax_forward, ranks):
    df, warped = _joined(ranks, 0, "det")
    ref = jax_forward[0]
    assert df.shape == (1, *SIZE, 3) and warped.shape == (1, *SIZE, 1)
    _close(df, ref["df"], 1e-5, "df")
    _close(warped, ref["warped"], 1e-5, "warped")


@pytest.mark.parametrize("case", [0, 1], ids=["3-levels", "4-levels-replicated"])
def test_sharded_forward_matches_the_unsharded_port(jax_forward, ranks, case):
    """Deterministic, and sampled from the same seed: each rank's draws
    are its block of the whole draw."""
    kw = FORWARD[case]
    model = PULPoModel(PULPoConfig(**kw), device="cpu")
    model.load_state_dict(from_jax_variables(jax_forward[case]["variables"], PULPoConfig(**kw)))
    x, y = jax_forward[case]["x"], jax_forward[case]["y"]
    for key, outs in (("det", model.apply_eval(x, y, deterministic=True)),
                      ("sampled", model.apply_eval(x, y, seed=3))):
        df, warped = _joined(ranks, case, key)
        _close(df, outs[6][0], 2e-6, (key, "df"))
        _close(warped, outs[7][0], 2e-6, (key, "warped"))


def test_levels_that_do_not_split_run_replicated():
    """The rule: equal slabs of an even number of planes; the JAX test
    configurations' coarse levels at space 4 run replicated."""
    assert [spatial.splits(d, 4) for d in (16, 8, 4, 2)] == [True, True, False, False]
    assert [spatial.splits(d, 2) for d in (160, 80, 40, 20, 10)] == [True] * 4 + [False]
    assert not spatial.splits(16, 1)
    mesh = spatial.Mesh2D((2, 4), 6, *(None,) * 3)
    assert spatial.volume_batch_spec(mesh, (4, 16)) == (slice(2, 4), slice(8, 12))
    assert spatial.volume_batch_spec(mesh, (4, 4)) == (slice(2, 4), slice(0, 4))


# ----------------------------------------------------------------------
# the step at mesh (2, 2)
# ----------------------------------------------------------------------

def _scaled_close(got: dict, ref: dict, rel: float, what: str, slack: dict | None = None):
    """Each leaf of `got` within `rel` of its scale (at least 1 % of the
    largest leaf) of `ref`, plus `slack[leaf]` where given."""
    top = max(float(ref[n].abs().max()) for n in got)
    for name, g in got.items():
        r = ref[name].double()
        scale = max(float(r.abs().max()), 1e-2 * top)
        err = float((g.double() - r).abs().max())
        allowed = rel * scale + (0.0 if slack is None else slack[name])
        assert err <= allowed, (what, name, err, scale)


def test_sharded_step_matches_the_jax_sharded_step(jax_step, ranks):
    cfg = PULPoConfig(**STEP)
    got = ranks[0]
    ref = {k: v.float() for k, v in from_jax_variables(jax_step["grads"], cfg).items()}
    _scaled_close(got["grads"], ref, 1e-3, "gradients")
    for k in LOSSES:
        np.testing.assert_allclose(float(got["metrics"][k]), float(jax_step["metrics"][k]),
                                   rtol=1e-4, err_msg=k)
    stats = from_jax_variables({"params": jax_step["before"]["params"],
                                "batch_stats": jax_step["stats"]}, cfg)
    for name, value in got["stats"].items():
        np.testing.assert_allclose(value.numpy(), stats[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_sharded_step_matches_the_unsharded_port_step(jax_step, ranks):
    cfg = PULPoConfig(**STEP)
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(jax_step["before"], cfg))
    noise = {l: torch.from_numpy(v) for l, v in jax_step["noise"].items()}
    grads, stats, metrics = compute_grads(model, jax_step["batch"], noise=noise)
    exact = from_jax_variables(jax_step["grads"], cfg)
    own = {n: float((g.double() - exact[n].double()).abs().max()) for n, g in grads.items()}
    got = ranks[0]
    _scaled_close(got["grads"], grads, 2e-5, "gradients", slack=own)
    for name, r in stats.items():
        scale = max(float(r.abs().max()), 1e-6)
        assert float((got["stats"][name] - r).abs().max()) <= 1e-5 * scale, name
    for k in LOSSES:
        np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)
    for k in ("levels/kl", "levels/recon", "levels/reg", "levels/mean_posterior_mu",
              "levels/mean_posterior_sigma"):
        for l, v in metrics[k].items():
            np.testing.assert_allclose(float(got["metrics"][k][l]), float(v), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k}[{l}]")
    assert float(got["metrics"]["nan_flag"]) == 0.0
    assert float(got["step_metrics"]["total_loss"]) == float(got["metrics"]["total_loss"])
    assert set(got["traffic"]) == {"halo", "gather", "reduce"}


def test_the_ranks_agree_bit_for_bit(ranks):
    a = ranks[0]
    for r in ranks[1:]:
        for key in ("grads", "stats", "after"):
            for n, v in a[key].items():
                assert torch.equal(v, r[key][n]), (key, n)
        assert all(torch.equal(v, r["metrics"][k]) for k, v in a["metrics"].items()
                   if not isinstance(v, dict))


def test_the_step_updates_the_weights(jax_step, ranks):
    before = from_jax_variables(jax_step["before"], PULPoConfig(**STEP))
    after = ranks[0]["after"]
    assert any(not torch.equal(after[n], v) for n, v in before.items() if "running" not in n)


# ----------------------------------------------------------------------
# what the sharded paths do not take
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw,what", [
    (dict(df_resolution="full_res"), "full_res"), (dict(input_size=(16, 14)), "2D"),
    (dict(remat=True), "remat"), (dict(remat_down=(0,)), "remat"),
    (dict(recon_loss=("ncc", "dice")), "Dice"), (dict(regularizer="jdet"), "jdet")])
def test_unsupported_configurations_raise(kw, what):
    cfg = PULPoConfig(**{**dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2), **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1") as err:
        with spatial.sharded(spatial.make_2d_mesh(1, 1), cfg):
            pass
    assert what in str(err.value)
