"""The network (`pulpo.py`: its modules and the prior), its blocks and
the model API (`api.py`), re-exported as the JAX package's
`pulpo_tpu.models` does."""

from pulpo_tpu_torch.models.api import PULPoModel
from pulpo_tpu_torch.models.pulpo import (
    Autoencoder,
    DownPath,
    PULPoEncoder,
    PULPoModule,
    SVFDecoder,
    prior_like,
)

__all__ = ["PULPoModule", "DownPath", "Autoencoder", "PULPoEncoder", "SVFDecoder",
           "prior_like", "PULPoModel"]
