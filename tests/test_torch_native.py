"""The port's native pair loader (native/: its own copy of
dataloader.cc, built with g++ into pulpo_tpu_torch/_build/) against the
JAX package's, on the CPU.

Bit-equal: the volume store both write, the store `convert_h5_to_store`
makes from a store in OASIS.h5's layout (written by each package's
`write_oasis_style_h5`, whose datasets are bit-equal too), and the items
of `epoch(shuffle=False)`, `epoch(shuffle=True, seed=2)` and `get_pair`
(moving, fixed and one-hot maps; the fixed volume fixes the partner
index). The one-hot maps equal `data/oasis.py:convert_to_onehot` on
valid labels; a label out of range gives an all-zero row (where
`convert_to_onehot` would index `np.eye`). A one-step Trainer run fed
by `DataLoader(NativeDataset(...))` has finite losses.
"""

import h5py
import numpy as np
import pytest
import torch

from pulpo_tpu import native as jax_native
from pulpo_tpu.data.synthetic import write_oasis_style_h5 as jax_write_oasis_style_h5
from pulpo_tpu_torch import PULPoConfig, native
from pulpo_tpu_torch.data.loader import DataLoader
from pulpo_tpu_torch.data.oasis import convert_to_onehot
from pulpo_tpu_torch.data.synthetic import write_oasis_style_h5
from pulpo_tpu_torch.train.loop import Trainer
from pulpo_tpu_torch.train.metrics import read_metrics
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPE = (8, 10, 12)
CLASSES = 4


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    vols = rng.random((6, *SHAPE), dtype=np.float32)
    segs = rng.integers(0, CLASSES, (6, *SHAPE)).astype(np.int16)
    native.write_volume_store(d / "port.bin", vols, segs, num_classes=CLASSES)
    jax_native.write_volume_store(d / "jax.bin", vols, segs, num_classes=CLASSES)
    return d, vols, segs


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _partner(item, vols):
    return [j for j in range(len(vols)) if np.array_equal(item["y"][..., 0], vols[j])]


def test_the_stores_are_byte_equal(stores):
    d, _, _ = stores
    assert (d / "port.bin").read_bytes() == (d / "jax.bin").read_bytes()


def test_items_equal_the_jax_loader(stores):
    d, vols, segs = stores
    port = native.NativeDataset(d / "port.bin", segs=True, n_slots=3, n_threads=2)
    ref = jax_native.NativeDataset(d / "jax.bin", segs=True, n_slots=3, n_threads=2)
    assert (len(port), port.input_size, port.num_classes, port.segs) == \
        (len(ref), ref.input_size, ref.num_classes, ref.segs) == (6, SHAPE, CLASSES, True)
    for kw in ({"shuffle": False}, {"shuffle": True, "seed": 2}, {"shuffle": True, "seed": 2}):
        a, b = list(port.epoch(**kw)), list(ref.epoch(**kw))
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            _same_item(x, y)
            assert _partner(x, vols) == _partner(y, vols)
    for i, it in enumerate(port.epoch(shuffle=False)):
        np.testing.assert_array_equal(it["x"][..., 0], vols[i])
        (j,) = _partner(it, vols)
        assert j != i
        np.testing.assert_array_equal(it["seg_x"], convert_to_onehot(segs[i], CLASSES))
        np.testing.assert_array_equal(it["seg_y"], convert_to_onehot(segs[j], CLASSES))
    for index, seed in ((0, 5), (4, 9), (4, 9)):
        _same_item(port.get_pair(index, np.random.default_rng(seed)),
                   ref.get_pair(index, np.random.default_rng(seed)))
    port.close(), ref.close()


def test_an_out_of_range_label_gives_an_all_zero_row(tmp_path):
    vols = np.zeros((2, 2, 2, 2), np.float32)
    segs = np.asarray([[0, 1, 2, 3, -1, 4, 7, 2]] * 2, np.int16).reshape(2, 2, 2, 2)
    native.write_volume_store(tmp_path / "s.bin", vols, segs, num_classes=4)
    ds = native.NativeDataset(tmp_path / "s.bin", segs=True)
    onehot = ds.get_pair(0, np.random.default_rng(0))["seg_x"].reshape(8, 4)
    np.testing.assert_array_equal(onehot.sum(-1), [1, 1, 1, 1, 0, 0, 0, 1])
    valid = [0, 1, 2, 3, 7]
    np.testing.assert_array_equal(onehot[valid],
                                  convert_to_onehot(segs[0].reshape(8)[valid], 4))
    ds.close()


def test_convert_h5_to_store_is_byte_equal(tmp_path):
    kw = dict(shape=(6, 8, 10), n_per_split=(3, 2, 2, 2), seg_dim=5, seed=3)
    a = write_oasis_style_h5(tmp_path / "port.h5", **kw)
    b = jax_write_oasis_style_h5(tmp_path / "jax.h5", **kw)
    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert tuple(fa.attrs["shape"]) == tuple(fb.attrs["shape"])
        names = []
        fa.visit(names.append)
        for n in names:
            if isinstance(fa[n], h5py.Dataset):
                assert fa[n].dtype == fb[n].dtype and np.array_equal(fa[n][()], fb[n][()]), n
            assert dict(fa[n].attrs) == dict(fb[n].attrs), n
    for split, segs in (("training", True), ("validation", False)):
        p = native.convert_h5_to_store(a, split, tmp_path / f"{split}.port.bin", with_segs=segs)
        r = jax_native.convert_h5_to_store(b, split, tmp_path / f"{split}.jax.bin",
                                           with_segs=segs)
        assert p.read_bytes() == r.read_bytes()
    ds = native.NativeDataset(tmp_path / "training.port.bin", segs=True)
    assert (len(ds), ds.num_classes) == (3, 5)
    ds.close()


def test_the_library_is_built_outside_the_package_sources():
    lib = native.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent == native.SRC.parent.parent
    assert lib.name.startswith("libdataloader_") and lib.suffix == ".so"


def test_a_failed_build_or_open_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["-fno-such-flag"])
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeUnavailable, match="building the native loader failed"):
        native.NativeDataset(tmp_path / "none.bin")
    monkeypatch.undo()
    (tmp_path / "junk.bin").write_bytes(b"\0" * 128)
    with pytest.raises(native.NativeUnavailable, match="dl_open failed"):
        native.NativeDataset(tmp_path / "junk.bin")


def test_a_trainer_step_fed_by_the_native_loader(tmp_path):
    h5 = write_oasis_style_h5(tmp_path / "OASIS.h5", shape=(12, 14, 16),
                              n_per_split=(3, 2, 2, 2), seg_dim=5, seed=1)
    train = native.NativeDataset(native.convert_h5_to_store(
        h5, "training", tmp_path / "train.bin", with_segs=True), segs=True, n_slots=2)
    val = native.NativeDataset(native.convert_h5_to_store(
        h5, "validation", tmp_path / "val.bin", with_segs=True), segs=True, n_slots=2)
    cfg = PULPoConfig(input_size=(12, 14, 16), total_levels=3, latent_levels=2, n0=2,
                      dataset="oasis", segs=True, recon_loss=("ncc", "dice"), batch_size=1,
                      val_check_interval=0.4)
    trainer = Trainer(cfg, run_dir=tmp_path / "runs", device="cpu")
    state = trainer.fit(DataLoader(train, 1, shuffle=True, seed=0),
                        DataLoader(val, 1, seed=1), max_steps=1)
    trainer.close()
    train.close(), val.close()
    assert state.step == 1 and not state.nan_flag
    (row,) = read_metrics(trainer.run_dir)
    losses = [v for k, v in row.items() if k.startswith("val/")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert torch.isfinite(torch.stack([p.detach().abs().max()
                                       for p in state.model.module.parameters()])).all()
