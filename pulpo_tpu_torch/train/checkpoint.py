"""Checkpoints with the reference's two-best policy.

Port of pulpo_tpu/train/checkpoint.py. One checkpoint tracks the best
val/total_loss and one the best val/reconstruction_loss; `latest` is
for resuming and `nan_state` for the NaN guard's dump. The config is
stored beside them (`config.json`, the same fields as the JAX
package's) so that a restore needs no arguments, and `checkpoints.json`
holds the best values and the last saved step.

The JAX package saves with orbax; the port saves each checkpoint as one
`torch.save` file, `checkpoints/<name>.pt`: the model's state_dict
(parameters and BatchNorm running statistics), the Adam count and
moments, the step, the NaN latch and the draw generator's state. The
file is written beside its target and renamed over it, so a crash
mid-write leaves the previous checkpoint whole. The JAX package's
`kernel_routing.json` has no counterpart: the port routes by device.
"""

from __future__ import annotations

import json
import os
import pathlib
import time

import numpy as np
import torch

from pulpo_tpu_torch.config import PULPoConfig

BEST = (("total_loss", "best-total-loss"),
        ("reconstruction_loss", "best-reconstruction-loss"))


def state_payload(state) -> dict:
    """What a checkpoint holds, as tensors on the CPU."""
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    return {
        "step": int(state.step),
        "model": cpu(state.model.state_dict()),
        "adam": {"count": int(state.opt_state.count),
                 "mu": cpu(state.opt_state.mu), "nu": cpu(state.opt_state.nu)},
        "rng": state.rng.get_state(),
        "nan_flag": bool(state.nan_flag),
    }


def checkpoint_path(run_dir, name: str) -> pathlib.Path:
    return pathlib.Path(run_dir) / "checkpoints" / f"{name}.pt"


def read_checkpoint(run_dir, name: str) -> dict:
    """The contents of checkpoint `name` of a run, on the CPU."""
    return torch.load(checkpoint_path(run_dir, name), map_location="cpu", weights_only=True)


def load_payload(state, payload: dict) -> None:
    """Write a checkpoint's contents into `state` (and its model), in place."""
    state.model.load_state_dict(payload["model"])
    dev = state.model.device
    adam = payload["adam"]
    state.opt_state.count = int(adam["count"])
    for name in state.opt_state.mu:
        state.opt_state.mu[name] = adam["mu"][name].to(dev)
        state.opt_state.nu[name] = adam["nu"][name].to(dev)
    state.rng.set_state(payload["rng"])
    state.step = int(payload["step"])
    state.nan_flag = bool(payload["nan_flag"])


class CheckpointManager:
    def __init__(self, run_dir: str | os.PathLike, cfg: PULPoConfig):
        self.run_dir = pathlib.Path(run_dir).absolute()
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.best = {key: float("inf") for key, _ in BEST}
        (self.run_dir / "config.json").write_text(cfg.to_json())
        self._meta_path = self.run_dir / "checkpoints.json"
        if self._meta_path.exists():
            self.best.update(json.loads(self._meta_path.read_text()).get("best", {}))
        self.last_save = {"bytes": 0, "seconds": 0.0}

    def _save(self, name: str, state, step: int):
        t = time.perf_counter()
        path = checkpoint_path(self.run_dir, name)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".pt.tmp")
        torch.save(state_payload(state), tmp)
        os.replace(tmp, path)
        self._meta_path.write_text(json.dumps({"best": self.best, "step": step}))
        self.last_save = {"bytes": path.stat().st_size,
                          "seconds": time.perf_counter() - t}

    def save_latest(self, state, step: int):
        self._save("latest", state, step)

    def save_emergency(self, state, step: int, name: str = "nan_state"):
        """The NaN guard's dump (the reference's nan_state_dict.pt)."""
        self._save(name, state, step)

    def update_best(self, state, step: int, val_metrics: dict[str, float]) -> list[str]:
        """Save best-total-loss / best-reconstruction-loss where the
        validation value improved."""
        saved = []
        for key, ckname in BEST:
            v = float(val_metrics[key])
            if np.isfinite(v) and v < self.best[key]:
                self.best[key] = v
                self._save(ckname, state, step)
                saved.append(ckname)
        return saved

    def restore(self, state, name: str = "latest"):
        """Load checkpoint `name` into `state`, in place; returns it."""
        load_payload(state, read_checkpoint(self.run_dir, name))
        return state

    @staticmethod
    def load_config(run_dir) -> PULPoConfig:
        return PULPoConfig.from_json((pathlib.Path(run_dir) / "config.json").read_text())


def latest_run(base_dir, experiment: str | None = None) -> pathlib.Path | None:
    """The newest version_* directory (the reference's runs/<exp>/version_<v>)."""
    base = pathlib.Path(base_dir)
    if experiment:
        base = base / experiment
    if not base.exists():
        return None
    versions = sorted((p for p in base.glob("**/version_*") if p.is_dir()),
                      key=lambda p: p.stat().st_mtime)
    return versions[-1] if versions else None
