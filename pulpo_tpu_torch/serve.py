"""The serving artifact: export a model's inference entries to a file,
and serve them from it.

Port of pulpo_tpu/serve.py. A ``.pulpo`` file is a zip with

- ``manifest.json``: ``format_version``, the model ``config``
  (``dataclasses.asdict``), its compute ``dtype``, ``batch_size``, ``N``,
  ``chunk``, ``baked_weights``, ``torch_version``, ``entries`` (each
  ``{needs_seed}``) and ``kernels``: the CUDA kernels the entries launch
  on the card, by name, with their sources;
- ``weights.pt``: the ``torch.save``d state_dict (only when the weights
  are baked).

Entries, each for the exported fixed input shape (batch_size,
*input_size, 1):

- ``predict_deterministic(x, y) -> (warped, final_df)``: level 0 of the
  deterministic eval forward;
- ``predict_mean(x, y, seed) -> (warped, final_df)``: the N-sample
  mean-SVF prediction;
- ``uq(x, y, seed) -> (warped, final_df, output_std, output_entropy)``:
  ``predict_with_uncertainty``'s level-0 maps.

With ``bake_weights=False`` each entry takes a state_dict first.

The one divergence from the JAX artifact: that one holds compiled
StableHLO programs and needs only JAX to run. This one holds the
weights and the manifest, so the serving host needs `pulpo_tpu_torch`,
which builds its CUDA kernels from `csrc/` at their first launch. The
JAX ``platforms`` argument has no counterpart: the device is chosen at
load (``cuda`` unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile

import torch

from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.kernels import _build, conv_chain, pos_head
from pulpo_tpu_torch.models.api import PULPoModel, _as_tensor
from pulpo_tpu_torch.models.pulpo import cf_fields, feedback_channels
from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

FORMAT_VERSION = 1
ENTRIES = {"predict_deterministic": False, "predict_mean": True, "uq": True}
_SOURCE = {"warp": "warp", "squaring": "squaring", "warp_cf": "warp",
           "squaring_cf": "squaring", "warp_2d": "warp", "squaring_2d": "squaring",
           "vel_head": "vel_head", "pos_head": "conv_unit", "conv_chain": "conv_unit"}


def _kernels(model: PULPoModel, rows: int) -> dict[str, str]:
    """The CUDA kernels the eval entries launch on the card, by name ->
    source, from the kernels' own shape predicates (no data is touched)."""
    cfg, m = model.cfg, model.module
    meta = lambda *shape: torch.empty(shape, dtype=model.dtype, device="meta")
    if cfg.ndims == 2:
        # the fused eval kernels take only 3D; the library convs run
        names = ["warp_2d", "squaring_2d"]
        return {n: f"pulpo_tpu_torch/csrc/{_build.SOURCES[_SOURCE[n]][0]}" for n in names}
    names = ["warp_cf", "squaring_cf"] if cf_fields(cfg) else ["warp", "squaring"]
    if cfg.cp_depth == 3:
        names.append("vel_head")
    cin = 2
    for k, block in enumerate(m.downpath.down_blocks):
        stages = block.stages()
        if conv_chain.takes(meta(1, *cfg.global_level_sizes[k], cin), stages):
            names.append("conv_chain")
            break
        cin = stages[-1]["k"].shape[0]
    ae = m.autoencoder
    for l in range(cfg.latent_levels - 1):
        p = ae.encoders[l].head_params(ae.up_blocks[str(l + cfg.lk_offset)])
        if pos_head.takes(meta(rows, *cfg.level_sizes[l], feedback_channels(cfg)), p):
            names.append("pos_head")
            break
    return {n: f"pulpo_tpu_torch/csrc/{_build.SOURCES[_SOURCE[n]][0]}" for n in names}


def export_model(model: PULPoModel, path: str, batch_size: int = 1, N: int = 8,
                 chunk: int | None = None, bake_weights: bool = True) -> None:
    """Write the serving artifact of `model` to `path`."""
    manifest = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(model.cfg),
        "dtype": str(model.dtype).removeprefix("torch."),
        "batch_size": batch_size,
        "N": N,
        "chunk": chunk,
        "baked_weights": bake_weights,
        "torch_version": torch.__version__,
        "entries": {name: {"needs_seed": s} for name, s in ENTRIES.items()},
        "kernels": _kernels(model, batch_size * (chunk or N)),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
        if bake_weights:
            buf = io.BytesIO()
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, buf)
            zf.writestr("weights.pt", buf.getvalue())


class ServedModel:
    """A loaded serving artifact: ``served.predict_deterministic(x, y)``,
    ``served.predict_mean(x, y, seed)``, ``served.uq(x, y, seed)`` (with a
    leading state_dict argument if exported with ``bake_weights=False``).
    Runs on ``cuda`` unless ``device="cpu"``; raises without a card
    otherwise."""

    def __init__(self, path: str, device=None):
        with zipfile.ZipFile(path) as zf:
            self.manifest = json.loads(zf.read("manifest.json"))
            if self.manifest["format_version"] != FORMAT_VERSION:
                raise ValueError(f"{path}: format_version {self.manifest['format_version']}, "
                                 f"this reader takes {FORMAT_VERSION}")
            self.config = PULPoConfig(**self.manifest["config"])
            self.model = PULPoModel(self.config, dtype=getattr(torch, self.manifest["dtype"]),
                                    device=device)
            if self.manifest["baked_weights"]:
                sd = torch.load(io.BytesIO(zf.read("weights.pt")),
                                map_location=self.model.device, weights_only=True)
                self.model.load_state_dict(sd)
        self.shape = (self.manifest["batch_size"], *self.config.input_size, 1)

    def _take(self, name: str, args: tuple, n: int):
        """The entry's (x, y, *rest) from its arguments, after loading a
        leading state_dict when the weights are not baked."""
        if not self.manifest["baked_weights"]:
            if len(args) != n + 1:
                raise TypeError(f"{name} takes a state_dict and {n} arguments")
            self.model.load_state_dict(args[0])
            args = args[1:]
        elif len(args) != n:
            raise TypeError(f"{name} takes {n} arguments")
        x, y = (_as_tensor(a, self.model.device) for a in args[:2])
        for t in (x, y):
            if tuple(t.shape) != self.shape:
                raise ValueError(f"{name}: input of shape {tuple(t.shape)}; the artifact "
                                 f"was exported for {self.shape}")
        return (x, y, *args[2:])

    def _uq(self, name: str, args: tuple):
        x, y, seed = self._take(name, args, 3)
        return predict_with_uncertainty(self.model, x, y, self.manifest["N"], seed=int(seed),
                                        chunk=self.manifest["chunk"])

    def predict_deterministic(self, *args):
        """(warped, final_df) at level 0 of the deterministic eval forward."""
        x, y = self._take("predict_deterministic", args, 2)
        outs = self.model.apply_eval(x, y, deterministic=True)
        return outs[7][0], outs[6][0]

    def predict_mean(self, *args):
        """(warped, final_df) of the N-sample mean-SVF prediction."""
        res = self._uq("predict_mean", args)
        return res.mean_outputs[0], res.final_dfs[0]

    def uq(self, *args):
        """(warped, final_df, output_std, output_entropy) at level 0."""
        res = self._uq("uq", args)
        return (res.mean_outputs[0], res.final_dfs[0], res.output_std[0],
                res.output_entropy[0])
