"""The N-sample uncertainty prediction (`predict.py`), re-exported as
the JAX package's `pulpo_tpu.uq` does."""

from pulpo_tpu_torch.uq.predict import UQResult, predict_with_uncertainty

__all__ = ["predict_with_uncertainty", "UQResult"]
