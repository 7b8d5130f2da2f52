"""Training orchestration: the step loop around `make_train_step`.

Port of pulpo_tpu/train/loop.py (the reference's Lightning loop,
train.py:106-116 and the models.py hooks):
- the run directory runs/<experiment>/version_<v>;
- validation every ``max(1, int(len(train) * val_check_interval))``
  steps, then `update_best` (the two best checkpoints) and
  `save_latest`;
- scalar logging every `log_every_n_steps` steps, with the per-level
  breakdowns (train/metrics.py, JSON lines);
- the NaN guard: the step's sticky latch freezes the weights, so the
  state after the step that saw the NaN is the pre-NaN state; it is
  saved as `nan_state` and the loop stops;
- resume from `latest`.

The port's step reads its NaN latch on the host once per step, so the
guard acts on the step that fired it (the JAX loop reads the flag one
step late so as not to stall its asynchronous dispatch). Every
`image_logging_frequency`-th validation round logs the last validation
batch's image panels (`MetricWriter.log_validation_images` and
`log_level_images`: `<run>/images/step_<s>.npz`). Data parallelism
(`data_parallel > 1`) is not ported yet.

`times` keeps the host-clock seconds of each step, validation round and
checkpoint round; each ends in a host read of a result (the NaN latch,
the validation losses, the saved bytes), so it covers the device work.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import numpy as np
import torch

from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.data.loader import prefetch_to_device
from pulpo_tpu_torch.models.api import PULPoModel
from pulpo_tpu_torch.train.checkpoint import CheckpointManager
from pulpo_tpu_torch.train.metrics import MetricWriter
from pulpo_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step

PROFILE_STEPS = (10, 13)  # steps traced when a profile directory is given


def _host(v):
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    return float(v)


class Trainer:
    def __init__(self, cfg: PULPoConfig, run_dir: str | None = None,
                 experiment: str = "default", profile_dir: str | None = None,
                 device=None):
        if cfg.data_parallel > 1:
            raise NotImplementedError(
                "data_parallel > 1 needs parallel/ (DDP with a cross-replica "
                "BatchNorm), which is not ported yet")
        self.cfg = cfg
        self.model = PULPoModel(cfg, device=device)
        base = pathlib.Path(run_dir or cfg.run_dir) / experiment
        version = 0
        while (base / f"version_{version}").exists():
            version += 1
        self.run_dir = base / f"version_{version}"
        self.run_dir.mkdir(parents=True)
        self.version = version
        self.profile_dir = profile_dir
        self.writer = MetricWriter(self.run_dir)
        self.ckpt = CheckpointManager(self.run_dir, cfg)
        self.should_stop = False
        self.validation_counter = 0
        self.times: dict[str, list[float]] = {"step": [], "validate": [], "checkpoint": []}
        self.state = None

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader, max_steps: int | None = None,
            resume: bool = False):
        cfg = self.cfg
        dev = self.model.device
        state, tx = create_train_state(self.model, seed=cfg.random_seed)
        if resume:
            self.ckpt.restore(state, name="latest")
            print(f"resumed from step {state.step}")
        self.state = state
        train_step = make_train_step(self.model, tx)
        eval_step = make_eval_step(self.model)
        val_every = max(1, int(len(train_loader) * cfg.val_check_interval))
        done = lambda: self.should_stop or bool(max_steps and state.step >= max_steps)
        profiler = None
        t_start = time.perf_counter()

        anomaly = torch.autograd.set_detect_anomaly(True) if cfg.debug_nans \
            else contextlib.nullcontext()
        with anomaly:
            for _epoch in range(cfg.max_epochs):
                for batch in prefetch_to_device(iter(train_loader), dev):
                    if self.profile_dir and state.step == PROFILE_STEPS[0]:
                        profiler = torch.profiler.profile()
                        profiler.start()
                    t = time.perf_counter()
                    state, metrics = train_step(state, batch)
                    self.times["step"].append(time.perf_counter() - t)
                    if profiler is not None and state.step == PROFILE_STEPS[1]:
                        profiler.stop()
                        pathlib.Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
                        profiler.export_chrome_trace(str(pathlib.Path(self.profile_dir) / "trace.json"))
                        profiler = None

                    if state.nan_flag:  # the reference's guard, models.py:188-194
                        print("NAN IN REGULARIZATION LOSS")
                        self.ckpt.save_emergency(state, state.step)
                        self.should_stop = True
                        break
                    if state.step % cfg.log_every_n_steps == 0:
                        self._log_train(state.step, _host(metrics))
                    if state.step % val_every == 0:
                        t = time.perf_counter()
                        val_metrics = self._validate(eval_step, val_loader, state.step)
                        self.times["validate"].append(time.perf_counter() - t)
                        t = time.perf_counter()
                        self.ckpt.update_best(state, state.step, val_metrics)
                        self.ckpt.save_latest(state, state.step)
                        self.times["checkpoint"].append(time.perf_counter() - t)
                    if done():
                        break
                if done():
                    break
        if profiler is not None:
            profiler.stop()
        self.writer.flush()
        elapsed = time.perf_counter() - t_start
        print(f"training finished: {state.step} steps in {elapsed:.1f}s "
              f"({state.step / max(elapsed, 1e-9):.2f} steps/s)")
        return state

    def close(self) -> None:
        self.writer.close()

    # ------------------------------------------------------------------
    def _log_train(self, step: int, m: dict):
        self.writer.scalars({k: v for k, v in m.items()
                             if not isinstance(v, dict) and k != "nan_flag"},
                            step, prefix="train/")
        for group in ("levels/kl", "levels/recon", "levels/reg"):
            self.writer.scalars({str(l): v for l, v in m[group].items()},
                                step, prefix=f"train_{group}/")
        # per-level posterior moment means (models.py:182-186)
        for group in ("levels/mean_posterior_mu", "levels/mean_posterior_sigma"):
            self.writer.scalars({str(l): v for l, v in m[group].items()},
                                step, prefix=f"train_distribution_{group}/")

    def _validate(self, eval_step, val_loader, step: int) -> dict:
        """Mean validation losses over the loader; each batch draws its
        posterior sample from a seed taken from a generator seeded by
        (random_seed + validation round)."""
        self.validation_counter += 1
        g = torch.Generator().manual_seed(self.cfg.random_seed + self.validation_counter)
        agg: dict[str, list] = {}
        last = None
        for batch in prefetch_to_device(iter(val_loader), self.model.device):
            seed = int(torch.randint(0, 2**62, (1,), generator=g))
            metrics, imgs = eval_step(batch, seed=seed)
            for k, v in metrics.items():
                if not isinstance(v, dict) and k != "nan_flag":
                    agg.setdefault(k, []).append(float(v))
            last = batch, imgs
        val_metrics = {k: float(np.mean(v)) for k, v in agg.items()}
        self.writer.scalars(val_metrics, step, prefix="val/")
        if last is not None and self.validation_counter % max(
                1, self.cfg.image_logging_frequency) == 0:
            batch, imgs = last
            self.writer.log_validation_images("val", batch["x"], batch["y"], imgs["y_pred"],
                                              imgs["final_df"], step)
            self.writer.log_level_images("val_levels", imgs["levels/y_hat"],
                                         imgs["levels/individual_dfs"],
                                         imgs["levels/final_dfs"], step)
        return val_metrics
