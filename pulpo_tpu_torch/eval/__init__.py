"""Evaluation: metrics, tables, figures, artifacts and `Evaluate`,
re-exported as the JAX package's `pulpo_tpu.eval` does. Nothing
here imports matplotlib (`visualize.draw` and `tables._draw_svg`
import it where they draw) or h5py (the readers' `__init__` does)."""

from pulpo_tpu_torch.eval import artifact, flow_viz, metrics, tables, visualize
from pulpo_tpu_torch.eval.evaluator import Evaluate

__all__ = ["flow_viz", "metrics", "tables", "artifact", "visualize", "Evaluate"]
