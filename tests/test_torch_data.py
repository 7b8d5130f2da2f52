"""The port's data pipeline against the JAX package's, on the CPU.

The loader must yield the same batches in the same order for the same
seed (pair sampling from a numpy Generator seeded by (seed, epoch),
DIVERGENCES.md 6), and the LungCT reader the same pairs from the same
store. Exact equality: both read the same numpy arrays.
"""

import threading

import h5py
import numpy as np
import pytest
import torch

from pulpo_tpu.data import lungct as jax_lungct
from pulpo_tpu.data.loader import DataLoader as JaxLoader
from pulpo_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from pulpo_tpu_torch.data import lungct
from pulpo_tpu_torch.data.loader import DataLoader, prefetch_to_device
from pulpo_tpu_torch.data.synthetic import SyntheticDataset
from test_torch_threads import one_torch_thread  # noqa: F401


def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


def _assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for epoch_g, epoch_r in zip(got, ref):
        assert len(epoch_g) == len(epoch_r)
        for bg, br in zip(epoch_g, epoch_r):
            assert sorted(bg) == sorted(br)
            for k in br:
                np.testing.assert_array_equal(bg[k], br[k], err_msg=k)


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, False), (True, True)])
def test_loader_yields_the_jax_batches(shuffle, drop_last):
    kw = dict(shape=(6, 7, 8), n=5, segs=True, lms=True, seed=3)
    ref = JaxLoader(JaxSynthetic(**kw), batch_size=2, shuffle=shuffle, seed=4,
                    drop_last=drop_last)
    got = DataLoader(SyntheticDataset(**kw), batch_size=2, shuffle=shuffle, seed=4,
                     drop_last=drop_last)
    assert len(got) == len(ref) == (2 if drop_last else 3)
    _assert_same_batches(_epochs(got), _epochs(ref))


def _write_lungct(path, shape=(8, 10, 12)):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.attrs["shape"] = np.asarray(shape)
        for split, n in (("training", 3), ("validation", 2), ("test", 2)):
            g = f.create_group(split)
            g.attrs["N"] = n
            for side in ("inhale", "exhale"):
                gg = g.create_group(side)
                for i in range(n):
                    gg.create_dataset(f"image/{i}", data=rng.random(shape, np.float32))
                    gg.create_dataset(f"mask/{i}", data=(rng.random(shape) > 0.5).astype(np.float32))
                    if split == "test":
                        gg.create_dataset(f"landmarks/{i}", data=rng.random((4, 3), np.float32) * 7)
    return path


def test_lungct_reader_matches_jax(tmp_path):
    path = _write_lungct(tmp_path / "LungCT.h5")
    ref = jax_lungct.create_data_loaders(2, lms=True, mask=True, path=path, seed=5)
    got = lungct.create_data_loaders(2, lms=True, mask=True, path=path, seed=5)
    for g, r in zip(got, ref):
        assert g.dataset.input_size == r.dataset.input_size == (8, 10, 12)
        _assert_same_batches(_epochs(g), _epochs(r))
    test = next(iter(got[2]))
    assert test["x"].shape == (1, 8, 10, 12, 1) and test["lm_x"].shape == (1, 4, 3)
    assert test["mask_x"].shape == (1, 8, 10, 12, 1)
    assert "lm_x" not in next(iter(got[0]))  # landmarks on the test split only
    with pytest.raises(ValueError):
        lungct.LungCT("training", segs=True, path=path)


def test_prefetch_stages_batches_on_the_device():
    ds = SyntheticDataset(shape=(6, 7, 8), n=4, lms=True, seed=1)
    ref = list(DataLoader(ds, batch_size=2, shuffle=True, seed=2))
    got = list(prefetch_to_device(iter(DataLoader(ds, batch_size=2, shuffle=True, seed=2)), "cpu"))
    assert len(got) == len(ref)
    for bg, br in zip(got, ref):
        assert sorted(bg) == sorted(br)
        for k in br:
            assert isinstance(bg[k], torch.Tensor) and bg[k].device.type == "cpu"
            np.testing.assert_array_equal(bg[k].numpy(), br[k])


def test_prefetch_reraises_a_producer_error():
    def batches():
        yield {"x": np.zeros((1, 2), np.float32)}
        raise OSError("unreadable store")

    it = prefetch_to_device(batches(), "cpu")
    assert next(it)["x"].shape == (1, 2)
    with pytest.raises(OSError, match="unreadable store"):
        next(it)


def test_prefetch_stops_its_thread_when_the_consumer_stops():
    def endless():
        while True:
            yield {"x": np.zeros((1, 2), np.float32)}

    before = threading.active_count()
    it = prefetch_to_device(endless(), "cpu", size=1)
    next(it)
    it.close()
    assert threading.active_count() == before
