"""The port's data parallelism (parallel/, the step's mesh, the Trainer
and train_cli under data_parallel > 1) and the UQ encode's chunking, on
the CPU.

The two-rank runs are two processes over gloo (tests/torch_dp_worker.py,
which imports no JAX), meeting at a `file://` rendezvous under the
test's temporary directory, so that pytest-xdist workers share no port.
Both ranks start from the JAX model's float32 initial weights and take
the draws that the JAX data-parallel step takes (each replica's
`fold_in(sample_rng, i)`, recovered as ``(samples - mus) / sigmas``).

Tolerances:
- the world-2 step against the port's single-process step on the same
  global batch (B = 2, one row a rank) and draws: losses and new
  BatchNorm statistics within 1e-5 of their scale; gradients within
  1e-5 of each leaf's scale plus the single-process step's own float32
  error on that leaf (its distance from the float64 JAX gradient of the
  same batch), as a world-2 gradient within 1e-5 of the exact one would
  be. A gradient leaf's scale is at least 1 % of the largest: the conv
  biases that feed a train BatchNorm have gradient 0 in exact
  arithmetic. Why the allowance: the two sides sum the same float32
  terms in another order, and on this batch that alone moves three
  leaves by 1.2e-5 to 2.3e-5 of their scale, while the world-2 gradient
  is no further from the exact one than the single-process gradient is;
- the world-2 step against the JAX `make_dp_train_step` on a 2-device
  CPU mesh, evaluated in float64 (XLA:CPU's float32 down-path gradients
  are ~5 % off; tests/test_torch_train.py): losses rtol 1e-4, gradients
  within 1e-3 of each leaf's scale, parameters after one Adam step atol
  2 * lr, BatchNorm statistics atol 1e-5;
- the two ranks' results: bit-equal;
- the multihost index helpers: equal to the JAX ones;
- the encode chunk: the unchunked mean, deviation and entropy within
  1e-5 of scale.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chip_smoke import payload_difference
from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.parallel import multihost as jax_multihost
from pulpo_tpu.parallel.dp import make_dp_train_step as jax_make_dp_train_step
from pulpo_tpu.parallel.dp import replicate_state as jax_replicate_state
from pulpo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pulpo_tpu.parallel.mesh import shard_batch_spec as jax_shard_batch_spec
from pulpo_tpu.train.step import compute_losses as jax_compute_losses
from pulpo_tpu.train.step import create_train_state as jax_create_train_state
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.models.blocks import BatchNorm
from pulpo_tpu_torch.parallel import multihost
from pulpo_tpu_torch.parallel.mesh import Mesh, fold_in, make_mesh, shard_batch_spec
from pulpo_tpu_torch.train.loop import Trainer
from pulpo_tpu_torch.train.metrics import read_metrics
from pulpo_tpu_torch.train.step import compute_grads
from pulpo_tpu_torch.uq.predict import predict_with_uncertainty
from test_torch_threads import one_torch_thread  # noqa: F401

HERE = pathlib.Path(__file__).resolve().parent
KW = dict(input_size=(12, 14, 16), total_levels=3, latent_levels=2, n0=4, batch_size=2)
LOSSES = ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss")
WORLD = 2

try:  # jax >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


# ----------------------------------------------------------------------
# the JAX reference and the two ranks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dp():
    """The JAX data-parallel step at KW on a 2-device CPU mesh, in
    float64 from the float32 initial state: the state before and after,
    the metrics, the averaged gradients and each row's draws."""
    if jax.device_count() < WORLD:
        pytest.skip("needs 2 JAX devices")
    jcfg = JaxConfig(**KW)
    jm = JaxModel(jcfg, bn_axis_name="data")
    state, tx = jax_create_train_state(jm, seed=0)
    rng = np.random.default_rng(0)
    batch = {k: rng.random((WORLD, *jcfg.input_size, 1), dtype=np.float32) for k in "xy"}
    to_np = lambda t: jax.tree.map(np.asarray, t)
    before = {"params": to_np(state.params), "batch_stats": to_np(state.batch_stats)}
    mesh = jax_make_mesh(WORLD)
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(
            lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
            else a, t)
        state = state.replace(params=f64(state.params), batch_stats=f64(state.batch_stats),
                              opt_state=f64(state.opt_state))
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        _, sample_rng = jax.random.split(state.rng)  # as train_step splits it

        def grads_and_draws(params, batch_stats, b, key):
            key = jax.random.fold_in(key, jax.lax.axis_index("data"))

            def loss_fn(p):
                outs, _ = jm.apply_train({"params": p, "batch_stats": batch_stats},
                                         b["x"], b["y"], key)
                total, _ = jax_compute_losses(jcfg, outs, b["x"], b["y"], None, None)
                return total, outs[:3]

            g, outs3 = jax.grad(loss_fn, has_aux=True)(params)
            return jax.lax.pmean(g, "data"), outs3

        grads, (mus, sigmas, samples) = jax.jit(shard_map(
            grads_and_draws, mesh=mesh, in_specs=(P(), P(), P("data"), P()),
            out_specs=(P(), P("data")), check_vma=False))(
                state.params, state.batch_stats, jb, sample_rng)
        noise = {l: np.asarray((samples[l] - mus[l]) / sigmas[l], np.float32) for l in mus}
        step = jax_make_dp_train_step(jm, tx, mesh)
        new_state, metrics = step(jax_replicate_state(state, mesh),
                                  jax.device_put(jb, jax_shard_batch_spec(mesh)))
        return dict(
            batch=batch, before=before, noise=noise,
            after={"params": to_np(new_state.params),
                   "batch_stats": to_np(new_state.batch_stats)},
            grads={"params": to_np(grads), "batch_stats": before["batch_stats"]},
            metrics=to_np(metrics))


def _run_workers(tmp: pathlib.Path, inp: pathlib.Path) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    for attempt in range(2):
        out = tmp / f"out{attempt}"
        out.mkdir()
        url = (tmp / f"rendezvous{attempt}").as_uri()
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_dp_worker.py"), str(r), str(WORLD), url,
             str(inp), str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=tmp) for r in range(WORLD)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=600)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n(timed out)")
        if all(p.returncode == 0 for p in procs):
            return [torch.load(out / f"rank_{r}.pt", weights_only=False) | {"dir": out}
                    for r in range(WORLD)]
        transient = any("timed out" in o.lower() or "timeout" in o.lower() for o in logs)
        if not (transient and attempt == 0):
            raise AssertionError("a worker failed:\n" + "\n----\n".join(o[-4000:] for o in logs))
    raise AssertionError("unreachable")


@pytest.fixture(scope="module")
def ranks(jax_dp, tmp_path_factory):
    """Both ranks' outputs (tests/torch_dp_worker.py) from the JAX initial
    weights, batch and draws."""
    cfg = PULPoConfig(**KW)
    tmp = tmp_path_factory.mktemp("dp")
    inp = tmp / "input.pt"
    torch.save({"cfg": KW, "state_dict": from_jax_variables(jax_dp["before"], cfg),
                "batch": {k: torch.from_numpy(v) for k, v in jax_dp["batch"].items()},
                "noise": {l: torch.from_numpy(v) for l, v in jax_dp["noise"].items()}}, inp)
    return _run_workers(tmp, inp)


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


# ----------------------------------------------------------------------
# (a) world 2 against one process on the same global batch
# ----------------------------------------------------------------------

def test_world2_step_matches_the_single_process_step(jax_dp, ranks):
    cfg = PULPoConfig(**KW)
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(jax_dp["before"], cfg))
    noise = {l: torch.from_numpy(v) for l, v in jax_dp["noise"].items()}
    grads, stats, metrics = compute_grads(model, jax_dp["batch"], noise=noise)
    exact = from_jax_variables(jax_dp["grads"], cfg)
    own_error = {n: float((g.double() - exact[n].double()).abs().max()) for n, g in grads.items()}
    got = ranks[0]
    _scaled_close(got["grads"], grads, 1e-5, "gradients", slack=own_error)
    for name, r in stats.items():
        scale = max(float(r.abs().max()), 1e-6)
        assert float((got["stats"][name] - r).abs().max()) <= 1e-5 * scale, name
    for k in LOSSES:
        np.testing.assert_allclose(got["metrics"][k], float(metrics[k]), rtol=1e-5, err_msg=k)
    for k in ("levels/kl", "levels/recon", "levels/reg"):
        for l, v in metrics[k].items():
            np.testing.assert_allclose(got["metrics"][k][l], float(v), rtol=1e-5, atol=1e-7)
    assert got["metrics"]["nan_flag"] == 0.0


def test_the_ranks_agree_bit_for_bit(ranks):
    """Averaged gradients and metrics, BatchNorm statistics and the state
    after the step are the same on both ranks."""
    a, b = ranks
    for key in ("grads", "stats", "after"):
        assert a[key].keys() == b[key].keys()
        for n, v in a[key].items():
            assert torch.equal(v, b[key][n]), (key, n)
    assert a["metrics"] == b["metrics"] and a["step_metrics"] == b["step_metrics"]


# ----------------------------------------------------------------------
# (b) world 2 against the JAX data-parallel step
# ----------------------------------------------------------------------

def test_world2_step_matches_the_jax_dp_step(jax_dp, ranks):
    cfg = PULPoConfig(**KW)
    got = ranks[0]
    ref_grads = {k: v.float() for k, v in from_jax_variables(jax_dp["grads"], cfg).items()}
    _scaled_close(got["grads"], ref_grads, 1e-3, "gradients")
    ref = jax_dp["metrics"]
    for k in LOSSES:
        np.testing.assert_allclose(got["step_metrics"][k], float(ref[k]), rtol=1e-4, err_msg=k)
    for k in ("levels/kl", "levels/recon", "levels/reg"):
        for l in ref[k]:
            np.testing.assert_allclose(got["step_metrics"][k][l], float(ref[k][l]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{k}[{l}]")
    after = from_jax_variables(jax_dp["after"], cfg)
    for name, r in after.items():
        atol = 1e-5 if "running_" in name else 2 * cfg.lr
        np.testing.assert_allclose(got["after"][name].numpy(), r.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


# ----------------------------------------------------------------------
# (c) the Trainer and train_cli under world size 2
# ----------------------------------------------------------------------

def test_trainer_writes_from_rank_0_only_and_keeps_the_ranks_equal(ranks):
    a, b = ranks[0]["trainer"], ranks[1]["trainer"]
    assert a["run_dirs"] == b["run_dirs"]
    assert [pathlib.Path(d).name for d in a["run_dirs"]] == ["version_0", "version_1"]
    assert a["writes"] == ["MetricWriter", "MetricWriter"]
    assert b["writes"] == ["_Silent", "_Silent"]
    assert a["steps"] == b["steps"] == [2, 1]
    assert payload_difference(a["fitted"], b["fitted"]) is None
    assert payload_difference(a["resumed"], b["resumed"]) is None
    assert a["fitted"]["step"] == 2 and a["resumed"]["step"] == 3
    runs = pathlib.Path(a["run_dirs"][0]).parent
    assert sorted(p.name for p in runs.iterdir()) == ["version_0", "version_1"]
    first = pathlib.Path(a["run_dirs"][0])
    rows = read_metrics(first)
    assert [r["step"] for r in rows] == [1, 2]  # one line a step: one writer
    for r in rows:
        assert all(np.isfinite(r[f"val/{k}"]) for k in LOSSES)
    latest = torch.load(first / "checkpoints" / "latest.pt", weights_only=True)
    assert payload_difference(latest, a["fitted"]) is None


def test_train_cli_runs_data_parallel(ranks):
    a, b = ranks[0]["cli"], ranks[1]["cli"]
    assert a == b
    run_dir = pathlib.Path(a)
    assert sorted(p.name for p in run_dir.parent.iterdir()) == ["version_0"]
    cfg = PULPoConfig.from_json((run_dir / "config.json").read_text())
    assert cfg.data_parallel == WORLD and cfg.batch_size == 2
    rows = read_metrics(run_dir)
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["val/total_loss"]) for r in rows)


# ----------------------------------------------------------------------
# (d) a world size other than data_parallel
# ----------------------------------------------------------------------

def test_data_parallel_other_than_the_world_size_raises(ranks, tmp_path):
    for r in ranks:
        assert r["mismatch"] is not None and "world of 3" in r["mismatch"]
    with pytest.raises(ValueError, match="world of 2 processes.*has 1"):
        Trainer(PULPoConfig(**KW, data_parallel=2), run_dir=tmp_path, device="cpu")
    assert not any(tmp_path.iterdir())


# ----------------------------------------------------------------------
# mesh and multihost helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_shard_helpers_equal_the_jax_ones(rank, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    for epoch in (0, 3):
        got = multihost.shard_dataset_indices(37, 5, epoch, 8, rank=rank, world_size=2)
        ref = jax_multihost.shard_dataset_indices(37, 5, epoch, 8)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert multihost.process_shard(8, rank, 2) == jax_multihost.process_shard(8)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_shard(7, rank, 2)


def test_initialize_without_an_address_starts_nothing(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_mesh_of_one_process():
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.active) == (1, 0, False)
    assert multihost.make_global_mesh(1) == mesh
    assert shard_batch_spec(mesh, 3) == slice(0, 3)
    with pytest.raises(ValueError, match="data=4 replicas need a world of 4"):
        make_mesh(4)
    local = multihost.local_to_global({"x": np.zeros((2, 3)), "y": np.ones((2, 1)),
                                       "seg_x": None}, Mesh(size=2, rank=1), device="cpu",
                                      global_batch=4)
    assert set(local) == {"x", "y"} and local["x"].shape == (2, 3)
    with pytest.raises(ValueError, match="global batch 6"):
        multihost.local_to_global({"x": np.zeros((2, 3))}, Mesh(size=2, rank=0),
                                  device="cpu", global_batch=6)


DP_NAMES = """
import sys
import pulpo_tpu_torch.{first}
from pulpo_tpu_torch import parallel
from pulpo_tpu_torch.parallel import dp, make_dp_train_step, replicate_state
assert make_dp_train_step is dp.make_dp_train_step and replicate_state is dp.replicate_state
assert set(parallel.__all__) >= {{"make_dp_train_step", "replicate_state"}}
print("matplotlib" in sys.modules)
"""


@pytest.mark.parametrize("first", ["models", "parallel"])
def test_the_package_reexports_the_data_parallel_step(first):
    """`pulpo_tpu_torch.parallel` gives `dp`'s `make_dp_train_step` and
    `replicate_state` (as `pulpo_tpu.parallel` does), in a fresh
    interpreter whichever of the model package and the parallel package
    is imported first; importing the package alone loads no `dp`, no
    model and no matplotlib."""
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", DP_NAMES.format(first=first)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr[-2000:]
    alone = subprocess.run(
        [sys.executable, "-c", "import sys, pulpo_tpu_torch.parallel; print(sorted(m for m in "
         "sys.modules if m.startswith(('pulpo_tpu_torch.parallel.dp', "
         "'pulpo_tpu_torch.models', 'matplotlib'))))"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert alone.returncode == 0 and alone.stdout.strip() == "[]", alone.stderr[-2000:]


def test_fold_in_gives_each_rank_its_own_seed():
    seeds = {fold_in(s, r) for s in (0, 1, 2**61) for r in range(8)}
    assert len(seeds) == 24 and all(0 <= s < 2**62 for s in seeds)
    assert fold_in(7, 3) == fold_in(7, 3)


def test_synced_batchnorm_without_a_group_is_the_plain_one():
    """`synced` on a one-process mesh (no group: no collective) gives the
    plain train BatchNorm's output and running update bit for bit."""
    g = torch.Generator().manual_seed(0)
    bn = BatchNorm(5)
    x = torch.randn((2, 4, 5, 6, 5), generator=g) * 3 + 1
    ref = bn(x, train=True)
    ref_pending, bn.pending = bn.pending, None
    with BatchNorm.synced(make_mesh()):
        got = bn(x, train=True)
    assert BatchNorm._mesh is None
    assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(bn.pending, ref_pending))


# ----------------------------------------------------------------------
# the UQ encode's pair chunks
# ----------------------------------------------------------------------

def test_encode_chunk_gives_the_unchunked_result():
    cfg = PULPoConfig(input_size=(12, 14, 16), total_levels=3, latent_levels=2, n0=4)
    model = PULPoModel(cfg, device="cpu")
    model.init(3)
    rng = np.random.default_rng(4)
    x, y = (rng.random((4, *cfg.input_size, 1), dtype=np.float32) for _ in range(2))
    ref = predict_with_uncertainty(model, x, y, 4, seed=2)
    got = predict_with_uncertainty(model, x, y, 4, seed=2, encode_chunk=2)
    for field in ("mean_outputs", "output_std", "output_entropy", "individual_df_std",
                  "final_df_std"):
        a, b = getattr(got, field), getattr(ref, field)
        for l in b:
            scale = max(float(b[l].abs().max()), 1e-6)
            assert float((a[l] - b[l]).abs().max()) <= 1e-5 * scale, (field, l)
