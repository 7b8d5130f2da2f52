"""The port's OASIS and BraTS readers against the JAX package's, on the
CPU.

Both read the same small HDF5 stores, written here: the OASIS layout by
`pulpo_tpu.data.synthetic.write_oasis_style_h5` (3D, and 2D slices), the
BraTS layout by `_write_brats`. Each loader must yield the JAX loader's
batches bit for bit, in the same order, over two epochs, for two seeds:
the same arrays read, the same pair draws from the loader's Generator.
The readers' refusals (OASIS masks; BraTS segmentations, masks and 2D)
raise what the JAX readers raise.
"""

import h5py
import numpy as np
import pytest

from pulpo_tpu.data import brats as jax_brats
from pulpo_tpu.data import oasis as jax_oasis
from pulpo_tpu.data.synthetic import write_oasis_style_h5
from pulpo_tpu_torch.data import brats, oasis
from test_torch_threads import one_torch_thread  # noqa: F401

OASIS_3D = (10, 12, 14)
OASIS_2D = (16, 20)
BRATS = (9, 12, 10)
SEEDS = (0, 7)


def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


def _assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for epoch_g, epoch_r in zip(got, ref):
        assert len(epoch_g) == len(epoch_r)
        for bg, br in zip(epoch_g, epoch_r):
            assert sorted(bg) == sorted(br)
            for k in br:
                assert bg[k].dtype == br[k].dtype, k
                np.testing.assert_array_equal(bg[k], br[k], err_msg=k)


@pytest.fixture(scope="module")
def oasis_stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("oasis")
    return {3: write_oasis_style_h5(d / "OASIS.h5", shape=OASIS_3D, n_per_split=(5, 3, 2, 2),
                                    seg_dim=6, seed=1),
            2: write_oasis_style_h5(d / "OASIS_2d.h5", shape=OASIS_2D,
                                    n_per_split=(4, 2, 2, 3), seg_dim=5, seed=2)}


def _write_brats(path, shape=BRATS, n=(4, 3, 3), n_lms=5, seed=0):
    """A store in the BraTS layout: per split `base` / `follow` groups with
    `t1ce/<i>` and `landmarks/<i>` (each patient its own count)."""
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f.attrs["shape"] = np.asarray(shape)
        for split, count in zip(("training", "validation", "test"), n):
            g = f.create_group(split)
            g.attrs["N"] = count
            for i in range(count):
                k = n_lms + i  # landmark counts differ between patients
                for scan in ("base", "follow"):
                    g.create_dataset(f"{scan}/t1ce/{i}", data=rng.random(shape, np.float32))
                    lms = rng.random((k, 3)) * (np.asarray(shape) - 1)
                    g.create_dataset(f"{scan}/landmarks/{i}", data=lms.astype(np.float32))
    return path


@pytest.fixture(scope="module")
def brats_store(tmp_path_factory):
    return _write_brats(tmp_path_factory.mktemp("brats") / "BraTS.h5")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ndims", [3, 2])
@pytest.mark.parametrize("segs,lms", [(True, True), (False, False), (True, False)])
def test_oasis_loaders_yield_the_jax_batches(oasis_stores, ndims, segs, lms, seed):
    path = oasis_stores[ndims]
    kw = dict(segs=segs, lms=lms, ndims=ndims, path=path, seed=seed)
    ref = jax_oasis.create_data_loaders(2, **kw)
    got = oasis.create_data_loaders(2, **kw)
    assert len(got) == len(ref) == 4
    size = OASIS_3D if ndims == 3 else OASIS_2D
    for g, r in zip(got, ref):
        assert g.dataset.input_size == r.dataset.input_size == size
        assert (g.batch_size, g.shuffle, g.seed) == (r.batch_size, r.shuffle, r.seed)
        _assert_same_batches(_epochs(g), _epochs(r))
    train, _, test_seg, test_lm = (next(iter(dl)) for dl in got)
    assert train["x"].shape == (2, *size, 1)
    if segs:
        c = 6 if ndims == 3 else 5
        assert train["seg_x"].shape == (2, *size, c) and train["seg_x"].dtype == np.float32
        assert np.all(train["seg_x"].sum(-1) == 1)  # one-hot
        assert test_seg["seg_y"].shape == (1, *size, c)
    assert "seg_x" not in test_lm  # segmentations on train / val / test_seg only
    if lms:
        assert test_lm["lm_x"].shape == (1, 4, ndims)
    assert "lm_x" not in train and "lm_x" not in test_seg  # landmarks on test_lm only


@pytest.mark.parametrize("seed", SEEDS)
def test_oasis_partner_draw_consumes_the_jax_numbers(oasis_stores, seed):
    """The partner is re-drawn until it differs from `index`: the same
    numbers of the Generator in the same order, so the Generators agree
    after every pair."""
    got = oasis.OASIS("training", path=oasis_stores[3])
    ref = jax_oasis.OASIS("training", path=oasis_stores[3])
    rg, rr = np.random.default_rng(seed), np.random.default_rng(seed)
    for index in (0, 1, 2, 3, 4, 0, 4):
        pg, pr = got.get_pair(index, rg), ref.get_pair(index, rr)
        np.testing.assert_array_equal(pg["y"], pr["y"])
        assert not np.array_equal(pg["x"], pg["y"])
        assert rg.bit_generator.state == rr.bit_generator.state


def test_convert_to_onehot_matches_jax():
    labels = np.random.default_rng(3).integers(0, 36, (4, 5, 6)).astype(np.int16)
    got = oasis.convert_to_onehot(labels, 36)
    ref = jax_oasis.convert_to_onehot(labels, 36)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (4, 5, 6, 36)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.argmax(-1), labels)


def test_oasis_refuses_a_mask(oasis_stores):
    for mod in (oasis, jax_oasis):
        with pytest.raises(NotImplementedError, match="Mask not implemented for OASIS"):
            mod.OASIS("training", mask=True, path=oasis_stores[3])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lms", [True, False])
@pytest.mark.parametrize("interpatient", [False, True])
def test_brats_loaders_yield_the_jax_batches(brats_store, interpatient, lms, seed):
    kw = dict(lms=lms and not interpatient, interpatient=interpatient, path=brats_store,
              seed=seed)
    ref = jax_brats.create_data_loaders(1, **kw)
    got = brats.create_data_loaders(1, **kw)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dataset.input_size == r.dataset.input_size == BRATS
        assert type(g.dataset).__name__ == type(r.dataset).__name__
        _assert_same_batches(_epochs(g), _epochs(r))


def test_brats_pairs_follow_up_to_baseline(brats_store):
    """Moving = follow-up t1ce, fixed = baseline t1ce of the same case; no
    baseline landmarks on the validation split."""
    rng = np.random.default_rng(0)
    with h5py.File(brats_store, "r") as f:
        for split in ("training", "validation"):
            item = brats.BraTS(split, lms=True, path=brats_store).get_pair(1, rng)
            np.testing.assert_array_equal(item["x"][..., 0], f[split]["follow/t1ce/1"][()])
            np.testing.assert_array_equal(item["y"][..., 0], f[split]["base/t1ce/1"][()])
            np.testing.assert_array_equal(item["lm_x"], f[split]["follow/landmarks/1"][()])
            assert (item["lm_y"] is None) == (split == "validation")


@pytest.mark.parametrize("seed", SEEDS)
def test_brats_interpatient_draws_as_jax(brats_store, seed):
    """Two coin flips, then the partner, re-drawn while it is the same
    scan of the same case: the same numbers in the same order."""
    got = brats.BraTSInterpatient("training", path=brats_store)
    ref = jax_brats.BraTSInterpatient("training", path=brats_store)
    rg, rr = np.random.default_rng(seed), np.random.default_rng(seed)
    for index in (0, 3, 1, 1, 2, 0, 3, 2):
        pg, pr = got.get_pair(index, rg), ref.get_pair(index, rr)
        for k in ("x", "y"):
            np.testing.assert_array_equal(pg[k], pr[k])
        assert not np.array_equal(pg["x"], pg["y"])
        assert rg.bit_generator.state == rr.bit_generator.state


def test_brats_interpatient_prints_the_landmark_note(brats_store, capsys):
    brats.BraTSInterpatient("test", lms=True, path=brats_store)
    got = capsys.readouterr().out
    jax_brats.BraTSInterpatient("test", lms=True, path=brats_store)
    assert got == capsys.readouterr().out == "Landmarks don't work with interpatient pairing.\n"


@pytest.mark.parametrize("kw,message", [(dict(segs=True), "Segs not implemented"),
                                        (dict(mask=True), "Mask not implemented"),
                                        (dict(ndims=2), "2D not implemented")])
@pytest.mark.parametrize("cls", ["BraTS", "BraTSInterpatient"])
def test_brats_refusals_match_jax(brats_store, cls, kw, message):
    for mod in (brats, jax_brats):
        with pytest.raises(ValueError, match=message):
            getattr(mod, cls)("training", path=brats_store, **kw)
