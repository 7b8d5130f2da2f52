"""BraTS longitudinal (144x192x160 after the converter's crop): baseline
and follow-up scans of one patient.

Port of pulpo_tpu/data/brats.py:1-89. The HDF5 layout: file attribute
`shape`; splits training / validation / test, each with attribute `N`
and groups `base` / `follow` holding `t1ce/<i>` and, where present,
`landmarks/<i>`.

- `BraTS`: intra-patient pairs, moving = follow-up t1ce, fixed =
  baseline t1ce of the same case; the validation split has no baseline
  landmarks.
- `BraTSInterpatient`: cross-patient pairs: two coin flips pick the
  moving and fixed scans (follow-up or baseline), then a partner case,
  re-drawn while it is the same scan of the same case.

No segmentations, masks or 2D slices, as the JAX reader. `h5py` is
imported when a reader is opened.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from pulpo_tpu_torch.data.loader import DataLoader

DEFAULT_PATH = pathlib.Path(__file__).parent / "BraTS.h5"


class BraTS:
    def __init__(self, split, segs=False, lms=False, mask=False, ndims=3, path=None):
        if segs:
            raise ValueError("Segs not implemented")
        if mask:
            raise ValueError("Mask not implemented")
        if ndims == 2:
            raise ValueError("2D not implemented")
        import h5py

        self.path = str(path or os.environ.get("PULPO_BRATS_H5", DEFAULT_PATH))
        self.split = split
        self.lms = lms
        self._f = h5py.File(self.path, "r")
        self.input_size = tuple(int(s) for s in self._f.attrs["shape"])
        self.length = int(self._f[split].attrs["N"])

    def __len__(self):
        return self.length

    def get_pair(self, index: int, rng: np.random.Generator):
        g = self._f[self.split]
        follow = np.asarray(g["follow"]["t1ce"][str(index)], dtype=np.float32)[..., None]
        base = np.asarray(g["base"]["t1ce"][str(index)], dtype=np.float32)[..., None]
        item = {"x": follow, "y": base, "seg_x": None, "seg_y": None,
                "lm_x": None, "lm_y": None, "mask_x": None, "mask_y": None}
        if self.lms:
            item["lm_x"] = np.asarray(g["follow"]["landmarks"][str(index)], dtype=np.float32)
            if self.split != "validation":
                item["lm_y"] = np.asarray(g["base"]["landmarks"][str(index)], dtype=np.float32)
        return item


class BraTSInterpatient(BraTS):
    def __init__(self, split, segs=False, lms=False, mask=False, ndims=3, path=None):
        super().__init__(split, segs=segs, lms=lms, mask=mask, ndims=ndims, path=path)
        if lms:
            # each patient has its own number of landmarks: not batchable
            print("Landmarks don't work with interpatient pairing.")

    def get_pair(self, index: int, rng: np.random.Generator):
        g = self._f[self.split]
        coin1 = "follow" if rng.integers(0, 2) == 0 else "base"
        coin2 = "follow" if rng.integers(0, 2) == 0 else "base"
        index2 = int(rng.integers(0, self.length))
        while index2 == index and coin1 == coin2:
            index2 = int(rng.integers(0, self.length))
        moving = np.asarray(g[coin1]["t1ce"][str(index)], dtype=np.float32)[..., None]
        fixed = np.asarray(g[coin2]["t1ce"][str(index2)], dtype=np.float32)[..., None]
        return {"x": moving, "y": fixed, "seg_x": None, "seg_y": None,
                "lm_x": None, "lm_y": None, "mask_x": None, "mask_y": None}


def create_data_loaders(batch_size, segs=False, lms=False, mask=False, ndims=3,
                        interpatient=False, path=None, seed=0):
    """(train, val, test) loaders; no landmarks on the validation split."""
    cls = BraTSInterpatient if interpatient else BraTS
    train = cls("training", segs=False, lms=lms, mask=mask, ndims=ndims, path=path)
    val = cls("validation", segs=False, lms=False, mask=mask, ndims=ndims, path=path)
    test = cls("test", segs=False, lms=lms, mask=mask, ndims=ndims, path=path)
    return (
        DataLoader(train, batch_size, shuffle=True, seed=seed),
        DataLoader(val, batch_size, shuffle=False, seed=seed + 1),
        DataLoader(test, batch_size, shuffle=False, seed=seed + 2),
    )
