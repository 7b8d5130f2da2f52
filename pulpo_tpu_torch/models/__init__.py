from pulpo_tpu_torch.models.api import PULPoModel

__all__ = ["PULPoModel"]
