"""Metric and image-panel logging without TensorBoard.

Port of pulpo_tpu/train/metrics.py. The JAX package writes TensorBoard
event files with tensorboardX, which the card's machine does not have;
the port never imports a TensorBoard writer:

- scalars go to `<log_dir>/metrics.jsonl`: one JSON object per logged
  step, ``{"step": s, "<tag>": value, ...}``, with the JAX writer's tag
  names (`train/total_loss`, `train_levels/kl/0`,
  `val/reconstruction_loss`, ...);
- image panels go to `<log_dir>/images/step_<s>.npz`, one file per
  logging round, keyed by the JAX writer's tags (`val/x`, `val/DF`,
  `val_levels/recon_level_0`, ...): each value the uint8 (H, W, 3) grid
  that the JAX writer hands to `add_image(..., dataformats="HWC")`, with
  the same normalisation, the same middle slice and the same
  `flow_viz.make_grid`.
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np

from pulpo_tpu_torch.eval.flow_viz import df_slice_channels, flow_to_image, make_grid, middle_slice


def _host(a) -> np.ndarray:
    """A tensor on any device (float32 on the host) or an array."""
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


class MetricWriter:
    """Collects the scalars of one step and writes them as one line when
    a later step is logged, on `flush` and on `close`; the image grids of
    one step likewise, as one `.npz`."""

    def __init__(self, log_dir):
        self.log_dir = pathlib.Path(log_dir)
        self.path = self.log_dir / "metrics.jsonl"
        self._file = open(self.path, "a")
        self._step: int | None = None
        self._pending: dict[str, float] = {}
        self._image_step: int | None = None
        self._images: dict[str, np.ndarray] = {}

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

    def image_grid(self, name: str, imgs, step: int):
        """(B, H, W, C) float or uint8 -> one tiled uint8 (H', W', 3) grid,
        min-max normalised over the whole batch (as the JAX writer)."""
        if self._image_step is not None and step != self._image_step:
            self._write_images()
        self._image_step = step
        imgs = _host(imgs)
        if imgs.dtype != np.uint8:
            lo, hi = imgs.min(), imgs.max()
            imgs = ((imgs - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)
        if imgs.shape[-1] == 1:
            imgs = np.repeat(imgs, 3, axis=-1)
        self._images[name] = make_grid(imgs)

    def log_validation_images(self, name_prefix: str, x, y, y_pred, df, step: int):
        """The reference's validation panel (models.py:265-295): x, y,
        y_pred, the distance (y_pred - y + 1) / 2 capped at 1 and the
        colourised DF."""
        x, y, y_pred, df = (_host(a) for a in (x, y, y_pred, df))
        distance = (y_pred - y + 1) / 2
        distance = np.where(distance > 1, 1.0, distance)
        is3d = x.ndim == 5
        for name, img in (("x", x), ("y", y), ("y_pred", y_pred), ("distance", distance)):
            if is3d:
                img = middle_slice(img, axis=-3)
            self.image_grid(f"{name_prefix}/{name}", img, step)
        flow = df_slice_channels(df) if is3d else df
        self.image_grid(f"{name_prefix}/DF", flow_to_image(flow), step)

    def log_level_images(self, prefix: str, y_hat, individual_dfs, final_dfs, step: int):
        """Per-level reconstruction, individual-DF and final-DF panels
        (models.py:297-308)."""
        for l in y_hat:
            img = _host(y_hat[l])
            is3d = img.ndim == 5
            if is3d:
                img = middle_slice(img, axis=-3)
            self.image_grid(f"{prefix}/recon_level_{l}", img, step)
            for nm, d in (("individual_DF", individual_dfs[l]), ("final_DF", final_dfs[l])):
                d = _host(d)
                flow = df_slice_channels(d) if is3d else d
                self.image_grid(f"{prefix}/{nm}_level_{l}", flow_to_image(flow), step)

    def _write_images(self):
        if self._images:
            out = self.log_dir / "images"
            out.mkdir(exist_ok=True)
            np.savez(out / f"step_{self._image_step}.npz", **self._images)
        self._images = {}

    def _write(self):
        if self._pending:
            # JSON has no NaN or inf: they are written as strings
            row = {k: v if math.isfinite(v) else str(v) for k, v in self._pending.items()}
            self._file.write(json.dumps({"step": self._step, **row}) + "\n")
        self._pending = {}

    def flush(self):
        self._write()
        self._write_images()
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self.flush()
            self._file.close()


def read_metrics(log_dir) -> list[dict]:
    """The logged steps of `<log_dir>/metrics.jsonl`, in order."""
    lines = (pathlib.Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines if line.strip()]


def read_images(log_dir) -> dict[int, dict[str, np.ndarray]]:
    """The logged image grids of `<log_dir>/images`, by step, then tag."""
    out = {}
    for f in sorted((pathlib.Path(log_dir) / "images").glob("step_*.npz")):
        with np.load(f) as z:
            out[int(f.stem[len("step_"):])] = {k: z[k] for k in z.files}
    return dict(sorted(out.items()))
