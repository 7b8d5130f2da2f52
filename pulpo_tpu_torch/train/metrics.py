"""Scalar metric logging as JSON lines.

Port of the scalar part of pulpo_tpu/train/metrics.py. The JAX package
writes TensorBoard event files with tensorboardX; the port writes
`<log_dir>/metrics.jsonl` with the standard library: one JSON object
per logged step, ``{"step": s, "<tag>": value, ...}``, with the JAX
writer's tag names (`train/total_loss`, `train_levels/kl/0`,
`val/reconstruction_loss`, ...). It never imports a TensorBoard writer.
The image panels wait for the port of `eval/visualize` and
`eval/flow_viz` (ROADMAP Queue 1).
"""

from __future__ import annotations

import json
import math
import pathlib


class MetricWriter:
    """Collects the scalars of one step and writes them as one line when
    a later step is logged, on `flush` and on `close`."""

    def __init__(self, log_dir):
        self.path = pathlib.Path(log_dir) / "metrics.jsonl"
        self._file = open(self.path, "a")
        self._step: int | None = None
        self._pending: dict[str, float] = {}

    def scalars(self, metrics: dict, step: int, prefix: str = ""):
        if self._step is not None and step != self._step:
            self._write()
        self._step = step
        for k, v in metrics.items():
            if isinstance(v, dict):
                self.scalars(v, step, prefix=f"{prefix}{k}/")
                continue
            try:  # a 0-d tensor on any device, a numpy or Python number
                self._pending[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError, RuntimeError):
                pass

    def _write(self):
        if self._pending:
            # JSON has no NaN or inf: they are written as strings
            row = {k: v if math.isfinite(v) else str(v) for k, v in self._pending.items()}
            self._file.write(json.dumps({"step": self._step, **row}) + "\n")
        self._pending = {}

    def flush(self):
        self._write()
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self.flush()
            self._file.close()


def read_metrics(log_dir) -> list[dict]:
    """The logged steps of `<log_dir>/metrics.jsonl`, in order."""
    lines = (pathlib.Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines if line.strip()]
