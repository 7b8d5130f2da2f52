"""Learn2Reg LungCT: inspiration/expiration CT pairs (the
large-deformation configuration, BASELINE.md milestone config 3).

Port of pulpo_tpu/data/lungct.py:1-64. The HDF5 layout: file attribute
`shape`; splits training/validation/test, each with attribute `N` and
groups `exhale` / `inhale` holding `image/<i>` (and optionally
`landmarks/<i>`, `mask/<i>`). Pairing is fixed: moving = inhale
(inspiration), fixed = exhale (expiration) of the same case.

`h5py` is imported when a reader is opened, not when this module is
imported, so the module loads on a machine without it. The NIfTI
converter `convert_lungct` (pulpo_tpu/data/lungct.py:70-116) imports
nibabel when it is called; the NIfTI read itself is untested (no host
of this repository has nibabel).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from pulpo_tpu_torch.data.loader import DataLoader

DEFAULT_PATH = pathlib.Path(__file__).parent / "LungCT.h5"


class LungCT:
    def __init__(self, split, segs=False, lms=False, mask=False, ndims=3, path=None):
        if segs:
            raise ValueError("Segs not available for LungCT")
        import h5py

        self.path = str(path or os.environ.get("PULPO_LUNGCT_H5", DEFAULT_PATH))
        self.split = split
        self.lms = lms
        self.mask = mask
        self._f = h5py.File(self.path, "r")
        self.input_size = tuple(int(s) for s in self._f.attrs["shape"])
        self.length = int(self._f[split].attrs["N"])
        self.segs = False

    def __len__(self):
        return self.length

    def close(self) -> None:
        self._f.close()

    def get_pair(self, index: int, rng: np.random.Generator):
        g = self._f[self.split]
        key = str(index)
        inhale = np.asarray(g["inhale"]["image"][key], np.float32)[..., None]
        exhale = np.asarray(g["exhale"]["image"][key], np.float32)[..., None]
        item = {"x": inhale, "y": exhale, "seg_x": None, "seg_y": None,
                "lm_x": None, "lm_y": None, "mask_x": None, "mask_y": None}
        if self.lms and "landmarks" in g["inhale"] and key in g["inhale"]["landmarks"]:
            item["lm_x"] = np.asarray(g["inhale"]["landmarks"][key], np.float32)
            item["lm_y"] = np.asarray(g["exhale"]["landmarks"][key], np.float32)
        if self.mask and "mask" in g["inhale"] and key in g["inhale"]["mask"]:
            item["mask_x"] = np.asarray(g["inhale"]["mask"][key], np.float32)[..., None]
            item["mask_y"] = np.asarray(g["exhale"]["mask"][key], np.float32)[..., None]
        return item


def create_data_loaders(batch_size, segs=False, lms=False, mask=False, ndims=3,
                        path=None, seed=0):
    """(train, val, test) loaders; landmarks on the test split only, as
    the JAX package reads them."""
    train = LungCT("training", lms=False, mask=mask, ndims=ndims, path=path)
    val = LungCT("validation", lms=False, mask=mask, ndims=ndims, path=path)
    test = LungCT("test", lms=lms, mask=mask, ndims=ndims, path=path)
    return split_loaders(train, val, test, batch_size, seed)


def split_loaders(train, val, test, batch_size, seed=0):
    """The loaders of the three splits: the training split shuffled, the
    test split one pair at a time."""
    return (
        DataLoader(train, batch_size, shuffle=True, seed=seed),
        DataLoader(val, batch_size, shuffle=False, seed=seed + 1),
        DataLoader(test, 1, shuffle=False, seed=seed + 2),
    )


def convert_lungct(source_pairs, out_path, shape=(192, 192, 208),
                   splits: dict[str, list[int]] | None = None,
                   clip_hu: tuple[float, float] = (-1100.0, 200.0)):
    """NIfTI inhale/exhale pairs -> LungCT.h5.

    source_pairs: a list of dicts {inhale: path, exhale: path,
    inhale_lms?: array, exhale_lms?: array, inhale_mask?: path, ...}.
    Volumes are clipped to the lung HU window and min-max normalised.
    Without `splits`, 70 / 15 / 15 % into training, validation and test.
    """
    try:
        import nibabel as nib
    except ImportError as e:
        raise ImportError("nibabel required for conversion") from e
    import h5py

    n = len(source_pairs)
    if splits is None:
        idx = list(range(n))
        splits = {"training": idx[: int(0.7 * n)],
                  "validation": idx[int(0.7 * n): int(0.85 * n)],
                  "test": idx[int(0.85 * n):]}

    def load_norm(p):
        img = np.asarray(nib.load(p).get_fdata(), np.float32)
        img = np.clip(img, *clip_hu)
        return (img - clip_hu[0]) / (clip_hu[1] - clip_hu[0])

    with h5py.File(out_path, "w") as f:
        f.attrs["shape"] = np.asarray(shape)
        for split, indices in splits.items():
            g = f.create_group(split)
            g.attrs["N"] = len(indices)
            for side in ("inhale", "exhale"):
                gg = g.create_group(side)
                gi = gg.create_group("image")
                gl = gg.create_group("landmarks")
                gm = gg.create_group("mask")
                for j, i in enumerate(indices):
                    pair = source_pairs[i]
                    gi.create_dataset(str(j), data=load_norm(pair[side]))
                    lms = pair.get(f"{side}_lms")
                    if lms is not None:
                        gl.create_dataset(str(j), data=np.asarray(lms, np.float32))
                    mk = pair.get(f"{side}_mask")
                    if mk is not None:
                        gm.create_dataset(str(j), data=load_norm(mk))
    return out_path
