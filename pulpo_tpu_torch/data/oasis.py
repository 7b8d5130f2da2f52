"""OASIS (the Learn2Reg / neurite-OASIS release; 160x192x224 volumes,
or the 160x192 slices of the 2D release): the flagship's dataset.

Port of pulpo_tpu/data/oasis.py:1-79. The HDF5 layout: file attribute
`shape`; splits training / validation / test_seg / test_lm, each with
attributes `N` and `seg_dim`, holding `image/<i>`, `seg/<i>` (integer
label maps) and `landmarks/<i>`. A pair is image `index` (moving) and a
partner (fixed) drawn from the loader's generator, re-drawn until it
differs from `index`. Segmentations come one-hot, float32, with
`seg_dim` channels (36 in the converted release). The store is opened
once and kept open.

`h5py` is imported when a reader is opened, not when this module is
imported, so the module loads on a machine without it.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from pulpo_tpu_torch.data.loader import DataLoader

DEFAULT_PATH = pathlib.Path(__file__).parent / "OASIS.h5"


def convert_to_onehot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(*spatial) integer labels -> (*spatial, num_classes) float32."""
    eye = np.eye(num_classes, dtype=np.float32)
    return eye[labels.astype(np.int64)]


class OASIS:
    def __init__(self, split, segs=False, lms=False, mask=False, ndims=3, path=None):
        if mask:
            raise NotImplementedError("Mask not implemented for OASIS")
        import h5py

        self.path = str(path or os.environ.get("PULPO_OASIS_H5", DEFAULT_PATH))
        self.split = split
        self.segs = segs
        self.lms = lms
        self.ndims = ndims
        self._f = h5py.File(self.path, "r")
        self.input_size = tuple(int(s) for s in self._f.attrs["shape"])
        self.length = int(self._f[split].attrs["N"])
        self.seg_dim = int(self._f[split].attrs.get("seg_dim", 0))

    def __len__(self):
        return self.length

    def get_pair(self, index: int, rng: np.random.Generator):
        j = index
        while j == index:
            j = int(rng.integers(0, self.length))
        g = self._f[self.split]
        img1 = np.asarray(g["image"][str(index)], dtype=np.float32)[..., None]
        img2 = np.asarray(g["image"][str(j)], dtype=np.float32)[..., None]
        item = {"x": img1, "y": img2, "seg_x": None, "seg_y": None,
                "lm_x": None, "lm_y": None, "mask_x": None, "mask_y": None}
        if self.segs:
            item["seg_x"] = convert_to_onehot(np.asarray(g["seg"][str(index)]), self.seg_dim)
            item["seg_y"] = convert_to_onehot(np.asarray(g["seg"][str(j)]), self.seg_dim)
        if self.lms:
            item["lm_x"] = np.asarray(g["landmarks"][str(index)], dtype=np.float32)
            item["lm_y"] = np.asarray(g["landmarks"][str(j)], dtype=np.float32)
        return item


def create_data_loaders(batch_size, segs=False, lms=False, mask=False, ndims=3,
                        path=None, seed=0):
    """(train, val, test_seg, test_lm) loaders: segmentations on the first
    three, landmarks on test_lm only; the test loaders one pair at a time."""
    train = OASIS("training", segs=segs, lms=False, mask=False, ndims=ndims, path=path)
    val = OASIS("validation", segs=segs, lms=False, mask=False, ndims=ndims, path=path)
    test_seg = OASIS("test_seg", segs=segs, lms=False, mask=False, ndims=ndims, path=path)
    test_lm = OASIS("test_lm", segs=False, lms=lms, mask=False, ndims=ndims, path=path)
    return (
        DataLoader(train, batch_size, shuffle=True, seed=seed),
        DataLoader(val, batch_size, shuffle=False, seed=seed + 1),
        DataLoader(test_seg, 1, shuffle=False, seed=seed + 2),
        DataLoader(test_lm, 1, shuffle=False, seed=seed + 3),
    )
