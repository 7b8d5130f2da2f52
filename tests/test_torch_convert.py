"""The port's NIfTI -> HDF5 converters against the JAX package's.

Neither this host nor the card's machine has nibabel, so a stand-in
module is put into `sys.modules`: its `load(path).get_fdata()` returns a
float64 array made from a seed that the path's name gives. Both
packages' `convert_oasis`, `convert_brats` and `convert_lungct` then run
on the same stand-in sources, and every HDF5 dataset and attribute of
the files they write must be bit-equal (same names, dtypes, shapes and
values). The NIfTI read itself (nibabel's `load` and `get_fdata` on a
real file) is untested.
"""

import json
import sys
import types
import zlib

import h5py
import numpy as np
import pytest

from pulpo_tpu.data import convert as jax_convert
from pulpo_tpu.data import lungct as jax_lungct
from pulpo_tpu_torch.data import convert, lungct
from test_torch_threads import one_torch_thread  # noqa: F401

OASIS_RAW = (6, 8, 7)      # transposed and flipped to (6, 7, 8)
BRATS_RAW = (240, 240, 4)  # cropped and padded to (144, 192, 14)
LUNG_RAW = (8, 9, 10)


def _volume(path) -> np.ndarray:
    """The stand-in volume of `path`: a shape and values from its name."""
    name = str(path).replace("\\", "/").split("/")[-2:]
    rng = np.random.default_rng(zlib.crc32("/".join(name).encode()))
    if "seg35" in name[-1]:
        return rng.integers(0, 36, OASIS_RAW).astype(np.float64)
    if name[-1].startswith("lung"):
        return rng.uniform(-1500, 600, LUNG_RAW)
    if name[-1].startswith("brats"):
        return rng.gamma(2.0, 300.0, BRATS_RAW)
    return rng.random(OASIS_RAW) * 300.0


@pytest.fixture
def stub_nibabel(monkeypatch):
    mod = types.ModuleType("nibabel")
    mod.load = lambda p: types.SimpleNamespace(get_fdata=lambda: _volume(p))
    monkeypatch.setitem(sys.modules, "nibabel", mod)
    return mod


def _contents(path) -> dict:
    """Every group, dataset and attribute of an HDF5 file, by name."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/attrs"] = {k: np.asarray(v) for k, v in f.attrs.items()}

        def visit(name, obj):
            out[name + "/attrs"] = {k: np.asarray(v) for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]

        f.visititems(visit)
    return out


def _assert_same_file(a, b):
    ca, cb = _contents(a), _contents(b)
    assert ca.keys() == cb.keys()
    n_data = 0
    for k, v in ca.items():
        if isinstance(v, dict):
            assert v.keys() == cb[k].keys(), k
            for ak, av in v.items():
                assert av.dtype == cb[k][ak].dtype and np.array_equal(av, cb[k][ak]), (k, ak)
        else:
            n_data += 1
            assert v.dtype == cb[k].dtype and v.shape == cb[k].shape, k
            assert np.array_equal(v, cb[k]), k
    return n_data


def test_convert_oasis_is_bit_equal(stub_nibabel, tmp_path):
    src = tmp_path / "release"
    names = [f"OASIS_OAS1_{i:04d}_MR1" for i in range(1, 11)]
    for i, n in enumerate(names):
        (src / n).mkdir(parents=True)
        if i % 3:  # some subjects have a segmentation file
            (src / n / "aligned_seg35.nii.gz").touch()
    lms = {names[-1]: np.arange(12, dtype=np.float64).reshape(4, 3).tolist(),
           names[3]: [[1.5, 2.0, 3.0]]}
    lms_file = tmp_path / "lms.json"
    lms_file.write_text(json.dumps(lms))
    for splits in (None, {"training": names[:3], "test_lm": names[8:]}):
        a = convert.convert_oasis(src, tmp_path / "port.h5", splits=splits,
                                  lms_file=str(lms_file))
        b = jax_convert.convert_oasis(src, tmp_path / "jax.h5", splits=splits,
                                      lms_file=str(lms_file))
        assert _assert_same_file(a, b) >= 9
    with h5py.File(tmp_path / "port.h5") as f:
        assert tuple(f.attrs["shape"]) == (6, 7, 8)
        lm = f["test_lm"]["image"]["0"][()]
        np.testing.assert_array_equal(
            lm, convert._oasis_geometry(_volume(src / names[8] / "aligned_norm.nii.gz")
                                        .astype(np.float32)) / convert.OASIS_TESTLM_MAX)
    assert convert.OASIS_TESTLM_MAX == jax_convert.OASIS_TESTLM_MAX


def test_convert_brats_is_bit_equal(stub_nibabel, tmp_path):
    rng = np.random.default_rng(1)
    pairs = []
    for i in range(4):
        p = {"base": tmp_path / f"p{i}" / "brats_base.nii.gz",
             "follow": tmp_path / f"p{i}" / "brats_follow.nii.gz"}
        if i != 2:
            p["base_lms"] = rng.uniform(50, 150, (5, 3))
            p["follow_lms"] = rng.uniform(50, 150, (5, 3))
        pairs.append(p)
    for splits in (None, {"training": [3, 0], "test": [1]}):
        a = convert.convert_brats(pairs, tmp_path / "port.h5", splits=splits)
        b = jax_convert.convert_brats(pairs, tmp_path / "jax.h5", splits=splits)
        assert _assert_same_file(a, b) >= 4
    with h5py.File(tmp_path / "port.h5") as f:
        img = f["training"]["base"]["t1ce"]["0"][()]
        assert img.shape == (144, 192, 14) and img.dtype == np.float32
        assert img.min() == 0.0 and img.max() == 1.0
    lms = rng.uniform(0, 200, (6, 3))
    np.testing.assert_array_equal(convert.brats_adjust_landmarks(lms),
                                  jax_convert.brats_adjust_landmarks(lms))


def test_convert_lungct_is_bit_equal(stub_nibabel, tmp_path):
    rng = np.random.default_rng(2)
    pairs = []
    for i in range(5):
        p = {"inhale": tmp_path / f"c{i}" / "lung_in.nii.gz",
             "exhale": tmp_path / f"c{i}" / "lung_ex.nii.gz"}
        if i % 2 == 0:
            p["inhale_lms"] = rng.uniform(0, 8, (7, 3))
            p["exhale_lms"] = rng.uniform(0, 8, (7, 3))
            p["inhale_mask"] = tmp_path / f"c{i}" / "lung_mask_in.nii.gz"
            p["exhale_mask"] = tmp_path / f"c{i}" / "lung_mask_ex.nii.gz"
        pairs.append(p)
    for kw in ({}, {"splits": {"training": [4, 1, 2], "validation": [0]},
                    "clip_hu": (-1000.0, 100.0)}):
        a = lungct.convert_lungct(pairs, tmp_path / "port.h5", shape=LUNG_RAW, **kw)
        b = jax_lungct.convert_lungct(pairs, tmp_path / "jax.h5", shape=LUNG_RAW, **kw)
        assert _assert_same_file(a, b) >= 8


def test_converters_need_nibabel(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "nibabel", None)  # import nibabel fails
    with pytest.raises(ImportError, match="nibabel"):
        convert.convert_oasis(tmp_path, tmp_path / "o.h5")
    with pytest.raises(ImportError, match="nibabel"):
        convert.convert_brats([], tmp_path / "b.h5")
    with pytest.raises(ImportError, match="nibabel"):
        lungct.convert_lungct([], tmp_path / "l.h5")
    assert not any(tmp_path.iterdir())
