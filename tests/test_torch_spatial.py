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

Two more steps at mesh (2, 2), in the same launch: the 4-level network
(its depth-2 coarsest level replicated at space 2) with NCC + Dice
(dice_factor 50) on one-hot maps of 36 classes, and with the `jdet`
regularizer: losses that are not sums of per-voxel terms, built on
partial statistics summed over the ranks (parallel/spatial.py's weight
rule). They are held to the same bounds as the L2 step, but that their
gradients are held to the float64 gradient rather than to the unsharded
step's: within 2e-5 of each leaf's scale plus the unsharded step's own
float32 error on that leaf, the larger of its distance from the float64
gradient and its spread (how far it moves when x and y move by one
float32 ulp). The leaves whose float64 gradient is zero to rounding
(below 1e-8 of the largest leaf's; the 26 conv biases that feed a train
BatchNorm, at most 1.7e-15 of it, every other leaf at least 1.2e-3)
allow the distance plus twice the spread: their float32 value is
rounding noise alone, held at the floor scale. Why not the sharded step
against the unsharded one: on 1 (Dice) and 5 (jdet) of a step's 122
leaves, all with a real gradient (the first two levels' BatchNorm
weights and biases, a decoder BatchNorm bias), the two steps sit on either side of the
float64 gradient, up to 1.61 times 2e-5 of scale plus the unsharded
step's distance apart. Measured, of each leaf's scale, the sharded /
the unsharded step's distance from the float64 gradient: Dice 2.06e-5 /
1.81e-5; jdet 2.88e-5 / 6.78e-6, 3.84e-5 / 9.95e-6, 3.64e-5 / 3.01e-5,
3.05e-5 / 1.96e-5, 1.32e-4 / 2.04e-4. The cause is float32 rounding:
these leaves sum a cotangent over every voxel of a level through the
train BatchNorm's fast variance (a difference of two moments), and the
unsharded step itself moves 5.5e-6 to 9.2e-5 of scale there when its
inputs move by one ulp (4.6e-5 and 2.6e-5 on the two leaves where its
distance is smallest). The sharded step is the closer one on 80 % (Dice)
and 83 % (jdet) of all leaves, and its farthest leaf is 0.57 and 0.64
times as far as the unsharded step's. The weight rule
itself: `soft_dice_loss` and `jdet_std` under `sharded` at (2, 2) and
(1, 4), on a split and a replicated level, each rank's term summed over
its space column and averaged over the data row, and its gradients
joined over the slabs (summed over a replicated level's column) and
averaged over the data row, within 1e-6 of scale of the unsharded
function's value and input gradient (float32 sums in another order).

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
  tests/test_torch_parallel.py at twice its 1e-5: the slabs' halo convs
  and partial losses reorder more float32 sums than the data-parallel
  split does (the squaring backward's slabs sum exactly, in fixed
  point, to the unsharded one's). The leaves that move most are
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
from pulpo_tpu_torch.kernels import squaring
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.ops import losses
from pulpo_tpu_torch.parallel import spatial
from pulpo_tpu_torch.train.step import compute_grads
from test_torch_threads import one_torch_thread  # noqa: F401

HERE = pathlib.Path(__file__).resolve().parent
SIZE = (16, 14, 16)
FORWARD = [dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2),
           dict(input_size=SIZE, total_levels=4, latent_levels=3, n0=2)]
STEP = dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2, batch_size=2)
# the 4-level step: the coarsest level (depth 2) runs replicated at space 2; its
# in-plane sizes (3, 3) keep the Jacobian determinant's voxel scale (s - 2) / 2
# nonzero there (at a size of 2 the determinant is 1 everywhere: std 0, whose
# square root has no derivative)
SEG_SIZE = (16, 18, 20)
STEP4 = dict(input_size=SEG_SIZE, total_levels=4, latent_levels=3, n0=2, batch_size=2)
SEG_STEPS = {"dice": dict(STEP4, segs=True, recon_loss=("ncc", "dice"), dice_factor=50),
             "jdet": dict(STEP4, regularizer="jdet")}
SEG_CLASSES = 36
RULE_MESHES = ((2, 2), (1, 4))
# the weight rule's levels: (24, 12, 16) splits at space 2 and 4, its
# coarsest level (6, 3, 4) at neither
RULE_CFG = dict(input_size=(24, 12, 16), total_levels=3, latent_levels=2, n0=2)
RULE_LEVELS = {"split": (24, 12, 16), "replicated": (6, 3, 4)}
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
    rng = np.random.default_rng(1)
    batch = {k: rng.random((2, *SIZE, 1), dtype=np.float32) for k in "xy"}
    return _jax_sharded_step(STEP, jax_variables(STEP, 0), batch)


def _onehot(seed: int) -> np.ndarray:
    labels = np.random.default_rng(seed).integers(0, SEG_CLASSES, (2, *SEG_SIZE))
    return np.eye(SEG_CLASSES, dtype=np.float32)[labels]


@pytest.fixture(scope="module")
def jax_seg_steps():
    """SEG_STEPS' JAX sharded steps on a (2, 2) mesh, as `jax_step`: one
    set of weights and one pair (with one-hot maps for the Dice step)."""
    variables = jax_variables(STEP4, 2)
    rng = np.random.default_rng(4)
    pair = {k: rng.random((2, *SEG_SIZE, 1), dtype=np.float32) for k in "xy"}
    segs = {"seg_x": _onehot(5), "seg_y": _onehot(6)}
    noise = None
    out = {}
    for name, kw in SEG_STEPS.items():
        batch = dict(pair, **segs) if name == "dice" else pair
        out[name] = _jax_sharded_step(kw, variables, batch, noise)
        noise = out[name]["noise"]  # the same network and key: the same draws
    return out


def _jax_sharded_step(kw: dict, variables: dict, batch: dict, noise=None) -> dict:
    jm = JaxModel(JaxConfig(**kw))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"], opt_state=None,
                          rng=jax.random.key(0))
    before = {"params": to_np(state.params), "batch_stats": to_np(state.batch_stats)}
    tx = optax.sgd(0.1)
    mesh = jax_make_2d_mesh(2, 2)
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(
            lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        params, stats = f64(state.params), f64(state.batch_stats)
        state = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        if noise is None:
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


def rule_inputs() -> dict:
    """The weight-rule tests' global inputs, by (loss, level): the Dice
    term's prediction (in (0, 1)) and one-hot target, the jdet term's
    displacement field (voxels, about one voxel)."""
    rng = np.random.default_rng(20)
    out = {}
    for level, size in RULE_LEVELS.items():
        pred = rng.random((2, *size, SEG_CLASSES), dtype=np.float32)
        target = np.eye(SEG_CLASSES, dtype=np.float32)[rng.integers(0, SEG_CLASSES, (2, *size))]
        df = rng.standard_normal((2, *size, 3)).astype(np.float32)
        out[("dice", level)] = (torch.from_numpy(pred), torch.from_numpy(target))
        out[("jdet", level)] = (torch.from_numpy(df), None)
    return out


INTEGRATE_STEPS = 4


def integrate_inputs() -> dict:
    """The sharded integration's field (voxels, up to 2.5: its steps'
    terms reach across slabs) and cotangent, at the weight rule's split
    level."""
    rng = np.random.default_rng(21)
    shape = (2, *RULE_LEVELS["split"], 3)
    v = rng.uniform(-2.5, 2.5, shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return {"v": torch.from_numpy(v), "g": torch.from_numpy(g)}


@pytest.fixture(scope="module")
def ranks(jax_forward, jax_step, jax_seg_steps, tmp_path_factory):
    """The four ranks' outputs, from the JAX weights, inputs and draws."""
    tmp = tmp_path_factory.mktemp("spatial")
    inp = tmp / "input.pt"
    tensors = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    forward = [{"cfg": kw, "state_dict": from_jax_variables(c["variables"], PULPoConfig(**kw)),
                "x": torch.from_numpy(c["x"]), "y": torch.from_numpy(c["y"]), "seed": 3}
               for kw, c in zip(FORWARD, jax_forward)]
    step = {"cfg": STEP, "state_dict": from_jax_variables(jax_step["before"], PULPoConfig(**STEP)),
            "batch": tensors(jax_step["batch"]), "noise": tensors(jax_step["noise"])}
    seg_steps = [{"name": name, "cfg": kw,
                  "state_dict": from_jax_variables(jax_seg_steps[name]["before"],
                                                   PULPoConfig(**kw)),
                  "batch": tensors(jax_seg_steps[name]["batch"]),
                  "noise": tensors(jax_seg_steps[name]["noise"])}
                 for name, kw in SEG_STEPS.items()]
    rule = {"cfg": RULE_CFG, "meshes": RULE_MESHES, "inputs": rule_inputs()}
    integrate = dict(integrate_inputs(), cfg=RULE_CFG, meshes=RULE_MESHES, nsteps=INTEGRATE_STEPS)
    torch.save({"forward": forward, "step": step, "seg_steps": seg_steps, "rule": rule,
                "integrate": integrate}, inp)
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
    _held_to_jax(ranks[0], jax_step, PULPoConfig(**STEP))


def _held_to_jax(got: dict, jax_step: dict, cfg: PULPoConfig) -> None:
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
    _held_to_port(ranks[0], jax_step, PULPoConfig(**STEP))
    got = ranks[0]
    assert float(got["metrics"]["nan_flag"]) == 0.0
    assert float(got["step_metrics"]["total_loss"]) == float(got["metrics"]["total_loss"])
    assert set(got["traffic"]) == {"halo", "gather", "reduce"}


def _held_to_port(got: dict, jax_step: dict, cfg: PULPoConfig, to_exact: bool = False) -> None:
    """`got` against the port's unsharded step. `to_exact` (the Dice and
    jdet steps, module doc): the gradients are held to the float64
    gradient instead, within 2e-5 of scale plus the unsharded step's own
    float32 error on that leaf, the larger of its distance from the
    float64 gradient and its spread (how far it moves when x and y move
    by one float32 ulp); on a leaf whose float64 gradient is zero to
    rounding, its distance plus twice its spread."""
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(jax_step["before"], cfg))
    noise = {l: torch.from_numpy(v) for l, v in jax_step["noise"].items()}
    grads, stats, metrics = compute_grads(model, jax_step["batch"], noise=noise)
    exact = {n: v.double() for n, v in from_jax_variables(jax_step["grads"], cfg).items()}
    own = {n: float((g.double() - exact[n]).abs().max()) for n, g in grads.items()}
    if not to_exact:
        _scaled_close(got["grads"], grads, 2e-5, "gradients", slack=own)
    else:
        batch = {k: v * np.float32(1 + 2.0**-23) if k in "xy" else v
                 for k, v in jax_step["batch"].items()}
        ulp, _, _ = compute_grads(model, batch, noise=noise)
        spread = {n: float((ulp[n] - g).abs().max()) for n, g in grads.items()}
        top = max(float(exact[n].abs().max()) for n in grads)
        zero = {n for n in grads if float(exact[n].abs().max()) <= 1e-8 * top}
        slack = {n: own[n] + 2 * spread[n] if n in zero else max(own[n], spread[n])
                 for n in grads}
        _scaled_close(got["grads"], {n: exact[n] for n in grads}, 2e-5, "gradients", slack=slack)
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
# the Dice step and the jdet step at mesh (2, 2), the weight rule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SEG_STEPS))
def test_sharded_seg_step_matches_the_jax_sharded_step(jax_seg_steps, ranks, name):
    _held_to_jax(ranks[0]["seg_steps"][name], jax_seg_steps[name],
                 PULPoConfig(**SEG_STEPS[name]))


@pytest.mark.parametrize("name", list(SEG_STEPS))
def test_sharded_seg_step_matches_the_unsharded_port_step(jax_seg_steps, ranks, name):
    got = ranks[0]["seg_steps"][name]
    _held_to_port(got, jax_seg_steps[name], PULPoConfig(**SEG_STEPS[name]), to_exact=True)
    assert float(got["metrics"]["nan_flag"]) == 0.0
    # the partial statistics are all-reduced; the one-hot maps gathered
    want = {"halo", "gather", "reduce", "stats"} | ({"gather_seg"} if name == "dice" else set())
    assert set(got["traffic"]) == want


@pytest.mark.parametrize("name", list(SEG_STEPS))
def test_the_ranks_agree_bit_for_bit_on_the_seg_steps(ranks, name):
    a = ranks[0]["seg_steps"][name]
    for r in ranks[1:]:
        b = r["seg_steps"][name]
        for key in ("grads", "stats"):
            for n, v in a[key].items():
                assert torch.equal(v, b[key][n]), (key, n)
        for k, v in a["metrics"].items():
            pairs = v.items() if isinstance(v, dict) else [(None, v)]
            for l, t in pairs:
                assert torch.equal(t, b["metrics"][k] if l is None else b["metrics"][k][l]), k


@pytest.mark.parametrize("level", list(RULE_LEVELS))
@pytest.mark.parametrize("loss", ["dice", "jdet"])
@pytest.mark.parametrize("shape", RULE_MESHES, ids=["2x2", "1x4"])
def test_partial_statistics_follow_the_weight_rule(ranks, shape, loss, level):
    """Each rank's term summed over its space column and averaged over
    the data row is the unsharded value; its gradients joined over the
    slabs (a replicated level's summed over the column) and averaged over
    the data row are the unsharded input gradient."""
    x, other = rule_inputs()[(loss, level)]
    data = shape[0]
    assert spatial.splits(x.shape[1], shape[1]) == (level == "split")
    value, grad = 0.0, torch.zeros(x.shape, dtype=torch.float64)
    for r, out in enumerate(ranks):
        term, g = out["rule"][(shape, loss, level)]
        rows, planes = spatial.volume_batch_spec(spatial.Mesh2D(shape, r, *(None,) * 3), x.shape)
        value += float(term) / data
        grad[rows, planes] += g.double() / data
    xr = x.clone().requires_grad_(True)
    ref = (losses.soft_dice_loss(xr, other, dice_factor=50.0) if loss == "dice"
           else losses.jdet_std(xr, lamb=0.025))
    (ref_grad,) = torch.autograd.grad(ref, xr)
    assert abs(value - float(ref)) <= 1e-6 * abs(float(ref)), (value, float(ref))
    _close(grad, ref_grad, 1e-6, "gradient")


@pytest.mark.parametrize("shape", RULE_MESHES, ids=["2x2", "1x4"])
def test_sharded_integration_backward_is_the_whole_one(ranks, shape):
    """The sharded scaling and squaring's slabs joined are the unsharded
    integration and its input gradient bit for bit (each step backward's
    fixed-point sums exchanged over the column, `spatial._column`), and a
    rank sends fewer bytes for them than one float32 all-reduce of the
    whole field a step would move (the planes its terms reach only)."""
    inp = integrate_inputs()
    v = inp["v"].clone().requires_grad_(True)
    ref = squaring.integrate_svf(v, INTEGRATE_STEPS)
    (ref_grad,) = torch.autograd.grad(ref, v, inp["g"])
    y, grad = torch.zeros_like(ref), torch.zeros_like(ref_grad)
    for r, out in enumerate(ranks):
        ys, gs, sent = out["integrate"][shape]
        rows, planes = spatial.volume_batch_spec(spatial.Mesh2D(shape, r, *(None,) * 3), v.shape)
        y[rows, planes], grad[rows, planes] = ys, gs
        whole = ys.numel() * shape[1]
        assert 0 < sent < INTEGRATE_STEPS * 4 * whole, (r, sent)
    assert torch.equal(y, ref.detach())
    assert torch.equal(grad, ref_grad)


# ----------------------------------------------------------------------
# what the sharded paths take, and what they do not
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(recon_loss=("ncc", "dice")), dict(segs=True),
                                dict(regularizer="jdet"), dict(df_resolution="full_res"),
                                dict(remat=True), dict(remat_down=(0,)),
                                dict(input_size=(16, 14))],
                         ids=["dice", "segs", "jdet", "full_res", "remat", "remat_down", "2D"])
def test_segmentation_and_jdet_configurations_are_taken(kw):
    cfg = PULPoConfig(**{**dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2), **kw})
    with spatial.sharded(spatial.make_2d_mesh(1, 1), cfg):
        assert spatial.active()


# levels of 2 x 2 and 1 x 1 planes: at 16 x 2 x 2 the 8 x 1 x 1 and 4 x 1 x 1
# levels share the plane (1, 1), by which a tensor's level is read
@pytest.mark.parametrize("kw,what", [(dict(input_size=(16, 2, 2)), "share the plane")])
def test_unsupported_configurations_raise(kw, what):
    cfg = PULPoConfig(**{**dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2), **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1") as err:
        with spatial.sharded(spatial.make_2d_mesh(1, 1), cfg):
            pass
    assert what in str(err.value)
