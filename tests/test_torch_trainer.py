"""The port's Trainer, checkpoints and metrics writer, on the CPU.

Held against the JAX package where it decides the same thing: the
config.json its CheckpointManager writes (field by field), the
two-best checkpoint policy (`update_best` with injected validation
metrics), and the tag names its `_log_train` writes. The port's own
guarantees: resume and restore are bit-exact, the NaN guard stops the
loop with the pre-NaN state in `nan_state`, and the CLI runs on the CPU.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from chip_smoke import payload_difference
from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.train import checkpoint as jax_checkpoint
from pulpo_tpu.train import loop as jax_loop
from pulpo_tpu.train import metrics as jax_metrics
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch import train_cli
from pulpo_tpu_torch.data.loader import DataLoader
from pulpo_tpu_torch.data.synthetic import SyntheticDataset
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.train import create_train_state
from pulpo_tpu_torch.train.checkpoint import (
    CheckpointManager,
    latest_run,
    read_checkpoint,
    state_payload,
)
from pulpo_tpu_torch.train.loop import Trainer
from pulpo_tpu_torch.train.metrics import MetricWriter, read_metrics
from pulpo_tpu_torch.train.step import compute_grads
from test_torch_threads import one_torch_thread  # noqa: F401

TINY = dict(input_size=(12, 14, 16), total_levels=3, latent_levels=2, n0=2,
            dataset="synthetic")


def _cfg(**kw):
    return PULPoConfig(**{**TINY, **kw})


def test_config_json_and_layout_match_the_jax_checkpoint_manager(tmp_path):
    kw = dict(TINY, dataset="lungct", lms=True, compute_dtype="bfloat16",
              routing=(("PULPO_WARP_COARSE", "1"),))
    jax_checkpoint.CheckpointManager(tmp_path / "jax", JaxConfig(**kw))
    a = Trainer(PULPoConfig(**kw), run_dir=tmp_path / "port", experiment="exp", device="cpu")
    b = Trainer(PULPoConfig(**kw), run_dir=tmp_path / "port", experiment="exp", device="cpu")
    a.close(), b.close()
    assert a.run_dir == tmp_path / "port" / "exp" / "version_0"
    assert b.run_dir == tmp_path / "port" / "exp" / "version_1"
    ref = json.loads((tmp_path / "jax" / "config.json").read_text())
    got = json.loads((a.run_dir / "config.json").read_text())
    assert sorted(got) == sorted(ref)
    for field, value in ref.items():
        assert got[field] == value, field
    assert CheckpointManager.load_config(a.run_dir) == PULPoConfig(**kw)
    os.utime(a.run_dir, (time.time() + 10,) * 2)
    assert latest_run(tmp_path / "port") == a.run_dir
    assert latest_run(tmp_path / "port", "nothing") is None


def test_two_best_policy_matches_jax(tmp_path):
    """The same validation metrics drive the same saves, best values and
    checkpoints.json as the JAX CheckpointManager (its saves recorded,
    not written)."""
    rounds = [{"total_loss": 5.0, "reconstruction_loss": 3.0},
              {"total_loss": 4.0, "reconstruction_loss": 3.5},
              {"total_loss": float("nan"), "reconstruction_loss": 2.0},
              {"total_loss": 4.0, "reconstruction_loss": 2.0},
              {"total_loss": 1.0, "reconstruction_loss": -1.0}]
    jm = jax_checkpoint.CheckpointManager(tmp_path / "jax", JaxConfig(**TINY))
    jax_saves = []
    jm._save = lambda name, state, step: jax_saves.append((name, step))
    cfg = _cfg()
    state, _ = create_train_state(PULPoModel(cfg, device="cpu"), seed=0)
    ckpt = CheckpointManager(tmp_path / "port", cfg)
    for step, metrics in enumerate(rounds, start=1):
        state.step = step
        assert ckpt.update_best(state, step, metrics) == jm.update_best(None, step, metrics)
    assert ckpt.best == jm.best == {"total_loss": 1.0, "reconstruction_loss": -1.0}
    assert len(jax_saves) == 6
    for name, step in dict(jax_saves).items():  # each name's last save
        assert read_checkpoint(ckpt.run_dir, name)["step"] == step
    meta = json.loads((ckpt.run_dir / "checkpoints.json").read_text())
    assert meta == {"best": {"total_loss": 1.0, "reconstruction_loss": -1.0}, "step": 5}
    # a new manager on the same directory resumes the best values
    assert CheckpointManager(ckpt.run_dir, cfg).best == ckpt.best


def test_metric_tags_match_the_jax_writer(tmp_path):
    """Two logged steps of a Trainer run: the train tags are those the JAX
    `_log_train` writes for the same metrics, and validation adds val/*."""
    cfg = _cfg(log_every_n_steps=1)
    trainer = Trainer(cfg, run_dir=tmp_path, device="cpu")
    ds = SyntheticDataset(shape=cfg.input_size, n=4, seed=0)
    trainer.fit(DataLoader(ds, 1, shuffle=True, seed=0), DataLoader(ds, 1, seed=1),
                max_steps=2)
    trainer.close()
    rows = read_metrics(trainer.run_dir)
    assert [r["step"] for r in rows] == [1, 2]

    tags = []
    fake = types.SimpleNamespace(add_scalar=lambda tag, value, step: tags.append(tag))
    writer = object.__new__(jax_metrics.MetricWriter)
    writer.writer = fake
    model = PULPoModel(cfg, device="cpu")
    _, _, metrics = compute_grads(model, {k: np.asarray(v)[None] for k, v in
                                          ds.get_pair(0, np.random.default_rng(0)).items()
                                          if k in ("x", "y")})
    host = {k: ({l: float(x) for l, x in v.items()} if isinstance(v, dict) else float(v))
            for k, v in metrics.items()}
    jax_loop.Trainer._log_train(types.SimpleNamespace(writer=writer), 1, host)
    val = {f"val/{k}" for k in ("kl_loss", "reconstruction_loss", "regularization_loss",
                                "total_loss")}
    for row in rows:
        assert set(row) - {"step"} == set(tags) | val
        assert all(np.isfinite(v) for v in row.values())


def test_metric_writer_writes_one_line_per_step(tmp_path):
    w = MetricWriter(tmp_path)
    w.scalars({"a": torch.tensor(1.5), "b": {"0": np.float32(2.0)}}, 3, prefix="train/")
    w.scalars({"c": 4}, 3, prefix="val/")
    w.scalars({"a": float("nan"), "skip": np.zeros(3)}, 4, prefix="train/")
    w.close()
    assert read_metrics(tmp_path) == [
        {"step": 3, "train/a": 1.5, "train/b/0": 2.0, "val/c": 4.0},
        {"step": 4, "train/a": "nan"}]


class _SamePair:
    """Two fixed volumes: every epoch's one batch holds both pairs."""

    def __init__(self, shape, nan_at=None):
        rng = np.random.default_rng(0)
        self.vols = [rng.random((*shape, 1), dtype=np.float32) for _ in range(2)]
        self.nan_at = nan_at
        self.calls = 0

    def __len__(self):
        return 2

    def get_pair(self, index, rng):
        self.calls += 1
        x = self.vols[index].copy()
        if self.nan_at is not None and self.calls > 2 * (self.nan_at - 1):
            x[:] = np.nan
        return {"x": x, "y": self.vols[1 - index], "seg_x": None, "seg_y": None,
                "lm_x": None, "lm_y": None, "mask_x": None, "mask_y": None}


def test_resume_continues_bit_exactly(tmp_path):
    """3 steps in one run equal 2 steps, then a resumed run of 1 step."""
    cfg = _cfg(max_epochs=3, batch_size=2)
    ds = _SamePair(cfg.input_size)
    loaders = lambda: (DataLoader(ds, 2), DataLoader(ds, 2, seed=1))
    whole = Trainer(cfg, run_dir=tmp_path, experiment="whole", device="cpu")
    ref = whole.fit(*loaders(), max_steps=3)
    first = Trainer(cfg, run_dir=tmp_path, experiment="first", device="cpu")
    first.fit(*loaders(), max_steps=2)
    second = Trainer(cfg, run_dir=tmp_path, experiment="second", device="cpu")
    (second.run_dir / "checkpoints").mkdir()
    os.replace(first.run_dir / "checkpoints" / "latest.pt",
               second.run_dir / "checkpoints" / "latest.pt")
    got = second.fit(*loaders(), max_steps=3, resume=True)
    for t in (whole, first, second):
        t.close()
    assert got.step == 3 and len(second.times["step"]) == 1
    assert payload_difference(state_payload(got), state_payload(ref)) is None
    # restore into a fresh state is bit-exact too
    fresh, _ = create_train_state(PULPoModel(cfg, device="cpu"), seed=9)
    second.ckpt.restore(fresh, "latest")
    assert payload_difference(state_payload(fresh), state_payload(got)) is None


def test_nan_stops_the_loop_with_the_pre_nan_state(tmp_path):
    cfg = _cfg(max_epochs=5, batch_size=2)
    ds = _SamePair(cfg.input_size, nan_at=2)
    trainer = Trainer(cfg, run_dir=tmp_path, device="cpu")
    state = trainer.fit(DataLoader(ds, 2), DataLoader(_SamePair(cfg.input_size), 2),
                        max_steps=5)
    trainer.close()
    assert trainer.should_stop and state.nan_flag and state.step == 2
    dump = read_checkpoint(trainer.run_dir, "nan_state")
    before = read_checkpoint(trainer.run_dir, "latest")  # saved after step 1
    assert before["step"] == 1 and dump["step"] == 2 and dump["nan_flag"]
    assert dump["adam"]["count"] == before["adam"]["count"] == 1
    for k, v in before["model"].items():
        assert torch.equal(dump["model"][k], v), k
    for group in ("mu", "nu"):
        for k, v in before["adam"][group].items():
            assert torch.equal(dump["adam"][group][k], v), (group, k)


def test_data_parallel_is_not_ported(tmp_path):
    """Data parallelism is ported (tests/test_torch_parallel.py): in a
    one-process world, data_parallel = 2 is refused before anything is
    written, with the world size and the launch it needs."""
    with pytest.raises(ValueError, match="world of 2 processes.*has 1.*torchrun"):
        Trainer(_cfg(data_parallel=2), run_dir=tmp_path, device="cpu")
    assert not any(tmp_path.iterdir())


def test_train_cli_runs_on_the_cpu(tmp_path):
    run_dir = train_cli.main([
        "--dataset", "synthetic", "--accelerator", "cpu", "--max_steps", "2",
        "--n0", "2", "--total_levels", "3", "--latent_levels", "2",
        "--run_dir", str(tmp_path), "--skip_eval"])
    assert run_dir.parent.parent == tmp_path and run_dir.name == "version_0"
    cfg = CheckpointManager.load_config(run_dir)
    assert cfg.input_size == (32, 32, 32) and cfg.n0 == 2 and cfg.routing == ()
    assert read_checkpoint(run_dir, "latest")["step"] == 2
    with pytest.raises(FileNotFoundError):  # the OASIS reader opens its store
        train_cli.main(["--dataset", "oasis", "--accelerator", "cpu", "--data_path",
                        str(tmp_path / "missing.h5")])
    with pytest.raises(ValueError):
        train_cli.main(["--dataset", "synthetic", "--accelerator", "tpu"])
