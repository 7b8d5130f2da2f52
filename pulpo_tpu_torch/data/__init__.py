"""Data: synthetic pairs, the loader and its device prefetch, and the
OASIS, BraTS and LungCT readers, re-exported as the JAX package's
`pulpo_tpu.data` does. The readers import h5py only when one is opened."""

from pulpo_tpu_torch.data import brats, oasis, synthetic
from pulpo_tpu_torch.data.loader import DataLoader, prefetch_to_device

__all__ = ["DataLoader", "prefetch_to_device", "oasis", "brats", "synthetic"]
