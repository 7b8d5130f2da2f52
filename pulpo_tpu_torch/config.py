"""Configuration for the PyTorch/CUDA port of PULPo.

The port keeps its own copy of the JAX package's `PULPoConfig`
(pulpo_tpu/config.py:51-255), so that it imports nothing of that
package. Field names, defaults and derived sizes are the same, and a
config JSON written by the JAX package loads unchanged. The TPU
routing knobs (`use_pallas`, `routing`, `debug_nans`) are kept as
inert fields for that reason only: the port routes by device, not by
knob. `remat` and `remat_down` recompute activations in the backward
(`models/pulpo.py:remat`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

# Feedback tensors that may be concatenated into the next-finer level.
# "velocity_field" (the reference's default spelling) and the legacy
# "control_points" both mean "velocity_fields".
_FEEDBACK_ALIASES = {
    "velocity_field": "velocity_fields",
    "control_points": "velocity_fields",
    "individual_df": "individual_dfs",
    "combined_df": "combined_dfs",
    "final_df": "final_dfs",
}
VALID_FEEDBACK = (
    "samples",
    "velocity_fields",
    "individual_dfs",
    "combined_dfs",
    "final_dfs",
    "transformed",
)


def normalize_feedback(feedback: Sequence[str]) -> tuple[str, ...]:
    out = []
    for item in feedback:
        item = _FEEDBACK_ALIASES.get(item, item)
        if item not in VALID_FEEDBACK:
            raise ValueError(
                f"Feedback list contains {item!r}. Not a known option "
                f"(valid: {VALID_FEEDBACK})."
            )
        out.append(item)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PULPoConfig:
    """Static model configuration (frozen and hashable)."""

    # --- architecture ---
    input_size: tuple[int, ...] = (160, 192, 224)
    total_levels: int = 5
    latent_levels: int = 4
    n0: int = 32  # channel multiplier
    cp_depth: int = 3  # depth of the VelocityField decoder head
    feedback: tuple[str, ...] = (
        "samples",
        "velocity_fields",
        "individual_dfs",
        "combined_dfs",
        "final_dfs",
        "transformed",
    )
    df_resolution: str = "level_res"  # or "full_res"
    nsteps: int = 7  # scaling-and-squaring steps

    # --- loss ---
    beta: float = 0.1
    recon_loss: tuple[str, ...] = ("ncc",)  # subset of {mse, ncc, dice}
    gamma: float = 0.05
    lamb: float = 0.025
    dice_factor: int = 50
    regularizer: str = "L2"  # or "jdet"
    similarity_pyramid: bool = False
    nondiagonal: bool = False
    prior_lambda: float = 20.0

    # --- optimization ---
    lr: float = 1e-4
    batch_size: int = 1
    max_epochs: int = 1000
    random_seed: int = 0

    # --- data ---
    dataset: str = "oasis"  # or "brats", "synthetic"
    segs: bool = False
    lms: bool = False
    mask: bool = False
    interpatient: bool = False

    # --- numerics ---
    compute_dtype: str = "float32"  # "bfloat16" for mixed precision
    # inert in the port (a TPU routing knob of the JAX config JSON)
    use_pallas: bool = True
    # recompute in the backward: every DownPath block and each level's
    # encoder and decoder / only these DownPath blocks (global levels)
    remat: bool = False
    remat_down: tuple[int, ...] = ()
    debug_nans: bool = False

    # --- logging / checkpointing ---
    image_logging_frequency: int = 5000
    val_check_interval: float = 0.1
    log_every_n_steps: int = 5
    run_dir: str = "runs"

    # --- parallelism ---
    data_parallel: int = 1

    # inert in the port (the JAX package's kernel routing pairs)
    routing: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "input_size", tuple(int(s) for s in self.input_size))
        object.__setattr__(self, "feedback", normalize_feedback(self.feedback))
        object.__setattr__(self, "recon_loss", tuple(self.recon_loss))
        object.__setattr__(
            self, "remat_down", tuple(int(k) for k in self.remat_down))
        object.__setattr__(
            self, "routing",
            tuple((str(k), str(v)) for k, v in self.routing))
        if self.df_resolution not in ("level_res", "full_res"):
            raise ValueError(f"df_resolution={self.df_resolution!r} not a known option.")
        if self.regularizer not in ("L2", "jdet"):
            raise ValueError(f"regularizer={self.regularizer!r} not a known option.")
        if self.latent_levels > self.total_levels:
            raise ValueError("latent_levels must be <= total_levels")
        for item in self.recon_loss:
            if item not in ("mse", "ncc", "dice"):
                raise ValueError(f"recon_loss contains {item!r}. Not a known option.")

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------

    @property
    def ndims(self) -> int:
        return len(self.input_size)

    @property
    def zdim(self) -> int:
        # latent channels == spatial dims
        return self.ndims

    @property
    def lk_offset(self) -> int:
        return self.total_levels - self.latent_levels

    @property
    def num_channels(self) -> dict[int, int]:
        """Channels of the down path per global level k."""
        mults = [1, 2, 4] + [6] * (self.total_levels - 3)
        return {k: self.n0 * mults[k] for k in range(self.total_levels)}

    @property
    def global_level_sizes(self) -> dict[int, tuple[int, ...]]:
        """Spatial size at each *global* level k, following the ceil-mode
        average-pool chain."""
        sizes = {0: self.input_size}
        for k in range(self.total_levels - 1):
            sizes[k + 1] = tuple(-(-s // 2) for s in sizes[k])
        return sizes

    @property
    def level_sizes(self) -> dict[int, tuple[int, ...]]:
        """Spatial size at each *latent* level l (= global level l+lk_offset)."""
        g = self.global_level_sizes
        return {l: g[l + self.lk_offset] for l in range(self.latent_levels)}

    @property
    def floor_level_sizes(self) -> dict[int, tuple[int, ...]]:
        """Floor-divide level sizes (only the nondiagonal KL uses them)."""
        return {
            l: tuple(s // (2 ** (l + self.lk_offset)) for s in self.input_size)
            for l in range(self.latent_levels)
        }

    def df_size(self, l: int) -> tuple[int, ...]:
        """Output (final df / transformed) size at latent level l."""
        if l == 0 or self.df_resolution == "full_res":
            return self.input_size
        return self.level_sizes[l]

    @property
    def window_size(self) -> dict[int, int]:
        """NCC window per level: 9/7/5/3 for K=4."""
        if self.latent_levels == 1:
            return {0: 9}
        return {l: 1 + 2 * (self.latent_levels - l) for l in range(self.latent_levels)}

    def _apply_similarity_pyramid(self, d: dict[int, float]) -> dict[int, float]:
        if self.similarity_pyramid:
            return {l: w / 2**l for l, w in d.items()}
        return d

    @property
    def kl_weight_dict(self) -> dict[int, float]:
        scale = {l: (2.0**self.ndims) ** l for l in range(self.latent_levels)}
        return self._apply_similarity_pyramid(scale)

    @property
    def recon_weight_dict(self) -> dict[int, float]:
        if self.df_resolution == "full_res":
            w = {l: 1.0 for l in range(self.latent_levels)}
        else:
            w = {l: (2.0**self.ndims) ** l for l in range(self.latent_levels)}
            w[0] = 1.0 / (2 ** (self.ndims * self.lk_offset))
        w[0] *= 4
        return self._apply_similarity_pyramid(w)

    @property
    def regularization_weight_dict(self) -> dict[int, float]:
        if self.df_resolution == "full_res":
            w = {l: 1.0 for l in range(self.latent_levels)}
        else:
            w = {l: (2.0**self.ndims) ** l for l in range(self.latent_levels)}
            w[0] = 1.0 / (2 ** (self.ndims * self.lk_offset))
        return self._apply_similarity_pyramid(w)

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "PULPoConfig":
        d = json.loads(s)
        return cls(**d)

    def replace(self, **kw) -> "PULPoConfig":
        return dataclasses.replace(self, **kw)
