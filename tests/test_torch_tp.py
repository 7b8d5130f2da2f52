"""The port's output-channel split (pulpo_tpu_torch/parallel/tp.py) on
the CPU: the eval forward and the training step.

Two ranks over gloo (tests/torch_spatial_worker.py `tp`, no JAX),
launched once, split the JAX test's model (`tests/test_parallel.py:321`:
12 x 14 x 16, n0 4, 3 levels, B = 1) at model 2. They run
`predict_deterministic` and a train forward, `create_train_state` on the
split model, and the training step (`compute_grads`, and one
`make_train_step` update) under `tp.sharded`; the same step with
`remat=True`; and the 2D configuration (16 x 20, n0 4, 3 levels: its
split forward and step) and the full_res forward on the channels-first
decode. The references are the JAX package's rules, its forward with the
sharded weights and its training step (`make_train_step`, jitted on the
state whose params and batch statistics `shard_params` placed) on 2 of
conftest's 8 virtual devices, in float64 with SGD(0.1) so that the update
is the gradient, and the port's own unsplit forward and step. The weights
are the port's initial ones (`tests/test_torch_spatial.py:jax_variables`),
the step's draws the JAX step's.

Tolerances:
- the rules: the same tensors, name for name through
  `compat.from_jax_variables`;
- the split forward against the JAX sharded forward: rtol 2e-5, atol
  2e-5 (the JAX test's, for its own sharded forward against the
  replicated one);
- against the port's replicated eval forward (3D, 2D, full_res): 1e-6
  of scale (the 3D eval units run as the conv-unit kernel's plain
  version on the CPU, the replicated forward as its ConvUnits; the split
  convs sum the same float32 terms; measured <= 5e-7); the train forward
  and its BatchNorm statistics: 1e-5 of scale (a split conv may sum its
  channels' terms in another order, and the batch statistics carry that
  through every level; measured 3.4e-6);
- the split step (each split leaf's gradient and statistics joined in
  rank order) against the float64 JAX step: the bounds of
  tests/test_torch_spatial.py's sharded step (losses rtol 1e-4,
  gradients 1e-3 of each leaf's scale, running statistics atol 1e-5);
- against the port's unsplit step, and the `remat=True` split step
  against the unsplit remat step: that file's `_held_to_port` (losses
  rtol 1e-5, gradients within 2e-5 of each leaf's scale plus the unsplit
  step's own distance from the float64 gradient, statistics 1e-5 of
  scale). The leaves that move are the conv biases that feed a train
  BatchNorm, whose exact gradient is 0: each rank's split conv sums its
  channels' float32 terms and the input cotangent is the sum of the
  ranks' partials;
- the 2D split step against the port's unsplit 2D step (no JAX step):
  gradients within 2e-5 of each leaf's scale (at least 1 % of the
  largest leaf's) plus twice the unsplit step's spread on that leaf (how
  far it moves when x and y move by one float32 ulp: the zero-gradient
  biases have no float64 reference here); measured, of the largest
  leaf, 1.8e-6 at most against a spread of 2.7e-6 there; statistics 1e-5
  of scale, losses rtol 1e-5;
- the two ranks: bit-equal outputs, losses and metrics, replicated
  leaves' gradients (each rank's own: no average over the ranks is
  taken), and replicated weights after the Adam update;
- `create_train_state` on the split model: each rank's slices joined in
  rank order equal the unsplit init bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.parallel.tp import make_model_mesh as jax_make_model_mesh
from pulpo_tpu.parallel.tp import param_sharding_rules as jax_param_sharding_rules
from pulpo_tpu.parallel.tp import shard_params as jax_shard_params
from pulpo_tpu.train.step import TrainState as JaxTrainState
from pulpo_tpu.train.step import make_train_step as jax_make_train_step
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.parallel import tp
from pulpo_tpu_torch.parallel.mesh import Mesh
from pulpo_tpu_torch.train.step import compute_grads
from test_torch_spatial import _held_to_jax, _held_to_port, _run_workers, _scaled_close
from test_torch_spatial import jax_variables
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(input_size=(12, 14, 16), total_levels=3, latent_levels=2, n0=4, batch_size=1)
REMAT = dict(KW, remat=True)
KW_2D = dict(input_size=(16, 20), total_levels=3, latent_levels=2, n0=4, batch_size=1)
# the channels-first decode: full_res, no "transformed" feedback
FULLRES = dict(KW, df_resolution="full_res",
               feedback=("samples", "velocity_fields", "individual_dfs", "combined_dfs",
                         "final_dfs"))
WORLD = 2

to_np = lambda t: jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def jax_tp():
    """The weights and pair, the JAX rule as a 0/1 mask of each leaf's
    shape, and the JAX `predict_deterministic` with sharded weights."""
    if jax.device_count() < WORLD:
        pytest.skip("needs 2 JAX devices")
    jm = JaxModel(JaxConfig(**KW))
    variables = jax_variables(KW, 0)
    rng = np.random.default_rng(1)
    x, y = (rng.random((1, *KW["input_size"], 1), dtype=np.float32) for _ in "xy")
    mesh = jax_make_model_mesh(WORLD)
    rules = jax_param_sharding_rules(variables, mesh)
    mask = jax.tree.map(
        lambda a, r: np.full(np.shape(a), float(r.spec != jax.sharding.PartitionSpec()),
                             np.float32),
        variables, rules, is_leaf=lambda r: hasattr(r, "spec"))
    sharded = jm.predict_deterministic(jax_shard_params(variables, mesh), x, y)
    return dict(variables=variables, x=x, y=y, mask=to_np(mask), sharded=to_np(sharded))


@pytest.fixture(scope="module")
def jax_step(jax_tp):
    """One JAX `make_train_step` step on the pair, jitted on the state
    whose params and batch statistics `shard_params` placed on 2 devices,
    in float64 with SGD(0.1) from the float32 initial state: the state
    before, the gradients ((before - after) / 0.1), the statistics
    after, the metrics, the step's draws and the new params' specs."""
    variables = jax_tp["variables"]
    batch = {"x": jax_tp["x"], "y": jax_tp["y"]}
    jm = JaxModel(JaxConfig(**KW))
    tx = optax.sgd(0.1)
    mesh = jax_make_model_mesh(WORLD)
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(
            lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        v64 = f64(variables)
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        rng = jax.random.key(0)
        _, sample_rng = jax.random.split(rng)  # as train_step splits it
        outs, _ = jax.jit(jm.apply_train)(v64, jb["x"], jb["y"], sample_rng)
        noise = {l: np.asarray((outs[2][l] - outs[0][l]) / outs[1][l], np.float32)
                 for l in outs[0]}
        placed = jax_shard_params(v64, mesh)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=placed["params"],
                              batch_stats=placed["batch_stats"],
                              opt_state=tx.init(placed["params"]), rng=rng)
        new_state, metrics = jax.jit(jax_make_train_step(jm, tx))(state, jb)
        grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / 0.1,
                             to_np(v64["params"]), to_np(new_state.params))
        specs = {tuple(l.sharding.spec)[-1:] for l in jax.tree.leaves(new_state.params)}
    return dict(batch=batch, before=variables, noise=noise, metrics=to_np(metrics),
                grads={"params": grads, "batch_stats": variables["batch_stats"]},
                stats=to_np(new_state.batch_stats), specs=specs)


def _port_case(kw: dict, seed: int) -> tuple[dict, dict, dict]:
    """The port's initial weights from `seed`, a pair and draws, for the
    configurations without a JAX reference."""
    cfg = PULPoConfig(**kw)
    model = PULPoModel(cfg, device="cpu")
    model.init(seed)
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.random((1, *cfg.input_size, 1), dtype=np.float32))
             for k in "xy"}
    noise = {l: torch.from_numpy(rng.standard_normal((1, *cfg.level_sizes[l], cfg.zdim),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    return model.state_dict(), batch, noise


@pytest.fixture(scope="module")
def tp_input(jax_tp, jax_step):
    """What the ranks take: the JAX test's weights and pair; the 2D and
    full_res forwards' weights and pairs; the steps' weights, batches
    and draws (the JAX step's for the 3D steps)."""
    state_dict = from_jax_variables(jax_tp["variables"], PULPoConfig(**KW))
    x, y = torch.from_numpy(jax_tp["x"]), torch.from_numpy(jax_tp["y"])
    noise = {l: torch.from_numpy(v) for l, v in jax_step["noise"].items()}
    sd2, batch2, noise2 = _port_case(KW_2D, 3)
    sdf, _, _ = _port_case(FULLRES, 4)
    forwards = [{"name": "2d", "cfg": KW_2D, "state_dict": sd2, **batch2},
                {"name": "full_res", "cfg": FULLRES, "state_dict": sdf, "x": x, "y": y}]
    steps = [{"name": "step", "cfg": KW, "state_dict": state_dict, "batch": {"x": x, "y": y},
              "noise": noise, "update": True},
             {"name": "remat", "cfg": REMAT, "state_dict": state_dict,
              "batch": {"x": x, "y": y}, "noise": noise},
             {"name": "2d", "cfg": KW_2D, "state_dict": sd2, "batch": batch2, "noise": noise2,
              "update": True}]
    return {"cfg": KW, "state_dict": state_dict, "x": x, "y": y,
            "forwards": {c["name"]: c for c in forwards}, "steps": {c["name"]: c for c in steps}}


@pytest.fixture(scope="module")
def ranks(tp_input, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inp = tmp / "input.pt"
    torch.save(dict(tp_input, forwards=list(tp_input["forwards"].values()),
                    steps=list(tp_input["steps"].values())), inp)
    return _run_workers(tmp, inp, "tp", WORLD)


def _joined(split, tensors: list[dict]) -> dict:
    """The ranks' `tensors` (one dict each) as one rank would hold them
    unsplit: each tensor named in `split` joined in rank order."""
    return {n: torch.cat([t[n] for t in tensors], 0) if n in split else tensors[0][n]
            for n in tensors[0]}


def _step(ranks, name: str) -> dict:
    """Case `name`'s step as one rank would hold it unsplit."""
    recs = [r["steps"][name] for r in ranks]
    split = recs[0]["split"]
    return dict(recs[0], grads=_joined(split, [r["grads"] for r in recs]),
                stats=_joined(split, [r["stats"] for r in recs]))


def _unsplit(kw: dict, state_dict: dict) -> PULPoModel:
    model = PULPoModel(PULPoConfig(**kw), device="cpu")
    model.load_state_dict(state_dict)
    return model


def _within(got, ref, rel: float, what) -> None:
    err = float((got - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), (what, err)


# ----------------------------------------------------------------------
# the rules and the eval forward
# ----------------------------------------------------------------------

def test_the_rule_picks_the_jax_rules_tensors_name_for_name(jax_tp, ranks):
    mask = from_jax_variables(jax_tp["mask"], PULPoConfig(**KW))
    jax_split = {n for n, m in mask.items() if bool(m.any())}
    assert {n for n, m in mask.items() if bool(m.any()) != bool(m.all())} == set()
    rules = ranks[0]["rules"]
    assert set(rules) == set(mask)
    assert {n for n, d in rules.items() if d == 0} == jax_split
    assert all(d in (0, None) for d in rules.values())
    # the 3-channel heads stay whole, every n0-wide conv is split
    assert rules["autoencoder.decoders.0.velocity_field._op.2.weight"] is None
    assert rules["downpath.down_blocks.0._op.0._op.0.weight"] == 0


def test_shard_params_keeps_each_ranks_slice(jax_tp, ranks):
    cfg = PULPoConfig(**KW)
    full = from_jax_variables(jax_tp["variables"], cfg)
    for r in ranks:
        for name, shape in r["shapes"].items():
            n = full[name].shape[0] // WORLD if r["rules"][name] == 0 else full[name].shape[0]
            assert shape == (n, *full[name].shape[1:]), name


def test_split_forward_matches_the_jax_sharded_forward(jax_tp, ranks):
    got = ranks[0]
    for i, key in enumerate(("warped", "dfs")):
        for l, v in got[key].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jax_tp["sharded"][i][l], np.float32),
                                       rtol=2e-5, atol=2e-5, err_msg=f"{key}[{l}]")


def test_split_forward_matches_the_port_replicated_forward(jax_tp, ranks):
    cfg = PULPoConfig(**KW)
    model = _unsplit(KW, from_jax_variables(jax_tp["variables"], cfg))
    warped, dfs = model.predict_deterministic(jax_tp["x"], jax_tp["y"])
    for key, ref in (("warped", warped), ("dfs", dfs)):
        for l, r in ref.items():
            _within(ranks[0][key][l], r, 1e-6, (key, l))


def test_the_ranks_agree_and_a_train_forward_runs(jax_tp, ranks):
    """Both ranks' eval and train forwards are bit-equal; the train
    forward matches the unsplit one (the same seed's draws), and so do
    its BatchNorm statistics, joined in rank order."""
    a, b = ranks
    for key in ("warped", "dfs"):
        assert all(torch.equal(a[key][l], b[key][l]) for l in a[key])
    for i, d in enumerate(a["train_outs"]):
        assert all(torch.equal(v, b["train_outs"][i][l]) for l, v in d.items())
    model = _unsplit(KW, from_jax_variables(jax_tp["variables"], PULPoConfig(**KW)))
    with torch.no_grad():
        outs, stats = model.apply_train(jax_tp["x"], jax_tp["y"])
    for i, d in enumerate(outs):
        for l, ref in d.items():
            got = a["train_outs"][i][l]
            assert bool(torch.isfinite(got).all()), (i, l)
            _within(got, ref, 1e-5, (i, l))
    split = {n for n, d in a["rules"].items() if d == 0}
    joined = _joined(split, [r["train_stats"] for r in ranks])
    for name, ref in stats.items():
        _within(joined[name], ref, 1e-5, name)


@pytest.mark.parametrize("name,kw", [("2d", KW_2D), ("full_res", FULLRES)])
def test_split_forward_of_other_configurations_matches_the_unsplit_forward(tp_input, ranks,
                                                                          name, kw):
    """The 2D network's units run as its library convs at the slice; the
    full_res forward decodes on the channels-first fields."""
    case = tp_input["forwards"][name]
    warped, dfs = _unsplit(kw, case["state_dict"]).predict_deterministic(case["x"], case["y"])
    for r in ranks:
        got_w, got_d = r["forwards"][name]
        for l in warped:
            _within(got_w[l], warped[l], 1e-6, (name, "warped", l))
            _within(got_d[l], dfs[l], 1e-6, (name, "dfs", l))


# ----------------------------------------------------------------------
# the training step
# ----------------------------------------------------------------------

def test_create_train_state_keeps_each_ranks_slice_of_the_unsplit_init(ranks):
    model = PULPoModel(PULPoConfig(**KW), device="cpu")
    init = model.init(5)
    joined = _joined({n for n, d in ranks[0]["rules"].items() if d == 0},
                     [r["init"] for r in ranks])
    assert all(torch.equal(joined[n], v) for n, v in init.items())
    for r in ranks:
        assert all(r["adam_shapes"][n] == r["shapes"][n] for n in r["adam_shapes"])


def test_the_jax_step_keeps_the_params_split(jax_step):
    assert jax_step["specs"] == {("model",), ()}


def test_split_step_matches_the_jax_step(jax_step, ranks):
    _held_to_jax(_step(ranks, "step"), jax_step, PULPoConfig(**KW))


@pytest.mark.parametrize("name,kw", [("step", KW), ("remat", REMAT)])
def test_split_step_matches_the_port_unsplit_step(jax_step, ranks, name, kw):
    """The remat step against the unsplit remat step: its checkpointed
    regions recompute their all-gathers under the forward's mesh."""
    got = _step(ranks, name)
    _held_to_port(got, jax_step, PULPoConfig(**kw))
    assert float(got["metrics"]["nan_flag"]) == 0.0
    want = {"gather", "reduce"} | ({"gather_recomputed"} if name == "remat" else set())
    assert set(got["traffic"]) == want


def test_split_2d_step_matches_the_port_unsplit_step(tp_input, ranks):
    case = tp_input["steps"]["2d"]
    model = _unsplit(KW_2D, case["state_dict"])
    grads, stats, metrics = compute_grads(model, case["batch"], noise=case["noise"])
    moved = {k: v * (1 + 2.0**-23) for k, v in case["batch"].items()}
    ulp, _, _ = compute_grads(model, moved, noise=case["noise"])
    spread = {n: float((ulp[n] - g).abs().max()) for n, g in grads.items()}
    got = _step(ranks, "2d")
    _scaled_close(got["grads"], grads, 2e-5, "2D gradients",
                  slack={n: 2 * v for n, v in spread.items()})
    for name, r in stats.items():
        _within(got["stats"][name], r, 1e-5, name)
    for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["step", "remat", "2d"])
def test_the_ranks_agree_bit_for_bit_on_the_steps(ranks, name):
    """The replicated leaves' gradients (as each rank computed them: no
    average over the ranks is taken), every metric and, after the Adam
    update made inside `tp.sharded`, the replicated weights."""
    a, b = (r["steps"][name] for r in ranks)
    assert a["split"] == b["split"] and a["split"]
    replicated = [n for n in a["grads"] if n not in a["split"]]
    assert replicated
    assert all(torch.equal(a["grads"][n], b["grads"][n]) for n in replicated)
    for k, v in a["metrics"].items():
        for l, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            assert torch.equal(t, b["metrics"][k] if l is None else b["metrics"][k][l]), k
    if "after" in a:
        assert float(a["step_metrics"]["nan_flag"]) == 0.0
        assert all(torch.equal(v, b["after"][n]) for n, v in a["after"].items()
                   if n not in a["split"])
        assert any(not torch.equal(v, ranks[0]["steps"][name]["before"][n])
                   for n, v in a["after"].items())


def test_the_rule_on_other_meshes_and_tensors():
    """At n = 1 every float tensor of >= 2 output channels is split (in
    one piece), as the JAX rule marks it; an integer tensor and one of
    fewer than 2n channels never."""
    model = PULPoModel(PULPoConfig(**KW), device="cpu")
    rules = tp.param_sharding_rules(model, Mesh(size=1, rank=0))
    assert set(rules.values()) == {0}
    assert tp.param_sharding_rules({"w": torch.zeros(3, 2), "n": torch.zeros(4, dtype=torch.int64)},
                                   Mesh(size=2, rank=0)) == {"w": None, "n": None}
