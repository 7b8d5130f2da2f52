"""Offline NIfTI -> HDF5 converters for OASIS and BraTS.

The port's own copy of pulpo_tpu/data/convert.py:29-163 (numpy and
h5py; the same geometry, normalisation and HDF5 layout, bit for bit):

OASIS (neurite-OASIS / Learn2Reg release, 160x192x224, pre-aligned):
  - np.transpose(img, (0, 2, 1)) then img[::-1, :, ::-1];
  - training / validation / test_seg use the release's aligned and
    normalised volumes as they are;
  - test_lm images divided by the reference notebook's fixed maximum
    `OASIS_TESTLM_MAX`;
  - landmarks read from a JSON file of {subject: points}.

BraTS (longitudinal t1ce):
  - flip y, crop [48:192, 16:208, :], pad z by 5 -> 144x192x160;
  - per-volume z-normalise, clip to +-6, min-max to [0, 1];
  - landmark coordinates moved through the same geometry.

The NIfTI read needs nibabel, imported when a converter is called (not
when this module is imported); neither this repository's test host nor
the card's machine has it, so the tests run the converters on a
stand-in module and the NIfTI read itself is untested.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np

OASIS_TESTLM_MAX = 279.82808  # fixed in the reference notebook


def _require_nibabel():
    try:
        import nibabel as nib

        return nib
    except ImportError as e:
        raise ImportError(
            "nibabel is required for NIfTI conversion; install it in a "
            "data-preparation environment (the training hosts need none)."
        ) from e


def _oasis_geometry(img: np.ndarray) -> np.ndarray:
    img = np.transpose(img, (0, 2, 1))
    return np.ascontiguousarray(img[::-1, :, ::-1])


def convert_oasis(
    source_dir,
    out_path,
    splits: dict[str, list[str]] | None = None,
    lms_file: str | None = None,
):
    """source_dir: the neurite-OASIS release (OASIS_OAS1_*_MR1/ folders
    with aligned_norm.nii.gz and aligned_seg35.nii.gz). Without `splits`,
    the sorted subjects split 70 / 10 / 10 / 10 % into training,
    validation, test_seg and test_lm."""
    nib = _require_nibabel()
    import h5py

    source_dir = pathlib.Path(source_dir)
    subjects = sorted(p for p in source_dir.glob("OASIS_OAS1_*_MR1"))
    if splits is None:
        n = len(subjects)
        names = [p.name for p in subjects]
        splits = {
            "training": names[: int(0.7 * n)],
            "validation": names[int(0.7 * n) : int(0.8 * n)],
            "test_seg": names[int(0.8 * n) : int(0.9 * n)],
            "test_lm": names[int(0.9 * n) :],
        }

    landmarks = {}
    if lms_file and os.path.exists(lms_file):
        with open(lms_file) as f:
            landmarks = json.load(f)

    shape = None
    with h5py.File(out_path, "w") as f:
        for split, names in splits.items():
            g = f.create_group(split)
            gi = g.create_group("image")
            gs = g.create_group("seg")
            gl = g.create_group("landmarks")
            for i, name in enumerate(names):
                sub = source_dir / name
                img = np.asarray(
                    nib.load(sub / "aligned_norm.nii.gz").get_fdata(), np.float32)
                img = _oasis_geometry(img)
                if split == "test_lm":
                    img = img / OASIS_TESTLM_MAX
                shape = img.shape
                gi.create_dataset(str(i), data=img)
                seg_p = sub / "aligned_seg35.nii.gz"
                if seg_p.exists():
                    seg = np.asarray(nib.load(seg_p).get_fdata(), np.int16)
                    gs.create_dataset(str(i), data=_oasis_geometry(seg))
                if name in landmarks:
                    gl.create_dataset(str(i), data=np.asarray(landmarks[name], np.float32))
            g.attrs["N"] = len(names)
            g.attrs["seg_dim"] = 36
        f.attrs["shape"] = np.asarray(shape)
    return out_path


def _brats_geometry(img: np.ndarray) -> np.ndarray:
    img = img[:, ::-1, :]  # flip y
    img = img[48:192, 16:208, :]  # crop
    img = np.pad(img, ((0, 0), (0, 0), (5, 5)))  # pad z -> 160
    return np.ascontiguousarray(img)


def _brats_normalize(img: np.ndarray) -> np.ndarray:
    m, s = img.mean(), img.std() + 1e-8
    img = np.clip((img - m) / s, -6, 6)
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-8)).astype(np.float32)


def brats_adjust_landmarks(lms: np.ndarray, orig_shape=(240, 240, 155)) -> np.ndarray:
    """The geometry of `_brats_geometry` applied to landmark coordinates."""
    lms = np.asarray(lms, np.float32).copy()
    lms[:, 1] = orig_shape[1] - 1 - lms[:, 1]  # flip y
    lms[:, 0] -= 48
    lms[:, 1] -= 16
    lms[:, 2] += 5
    return lms


def convert_brats(source_pairs, out_path, splits: dict[str, list[int]] | None = None):
    """source_pairs: a list of dicts {base: path, follow: path,
    base_lms?: array, follow_lms?: array} of t1ce NIfTIs. Without
    `splits`, 70 / 15 / 15 % into training, validation and test."""
    nib = _require_nibabel()
    import h5py

    n = len(source_pairs)
    if splits is None:
        idx = list(range(n))
        splits = {
            "training": idx[: int(0.7 * n)],
            "validation": idx[int(0.7 * n) : int(0.85 * n)],
            "test": idx[int(0.85 * n) :],
        }
    shape = None
    with h5py.File(out_path, "w") as f:
        for split, indices in splits.items():
            g = f.create_group(split)
            for side in ("base", "follow"):
                gg = g.create_group(side)
                gt = gg.create_group("t1ce")
                gl = gg.create_group("landmarks")
                for j, i in enumerate(indices):
                    pair = source_pairs[i]
                    img = np.asarray(nib.load(pair[side]).get_fdata(), np.float32)
                    img = _brats_normalize(_brats_geometry(img))
                    shape = img.shape
                    gt.create_dataset(str(j), data=img)
                    lms = pair.get(f"{side}_lms")
                    if lms is not None:
                        gl.create_dataset(
                            str(j), data=brats_adjust_landmarks(np.asarray(lms)))
            g.attrs["N"] = len(indices)
        f.attrs["shape"] = np.asarray(shape)
    return out_path
