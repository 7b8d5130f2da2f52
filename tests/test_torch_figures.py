"""The port's evaluation figures and validation panels against the JAX
package's, on the CPU, on synthetic numpy arrays (no model).

- `eval/flow_viz`: bit-equal to the JAX functions.
- The validation grids of `train/metrics.MetricWriter`: bit-equal to the
  arrays the JAX writer hands to tensorboardX's `add_image` (captured
  by a stand-in `SummaryWriter`), 3D and 2D; and a port Trainer run
  writes the JAX writer's tag set.
- Every row of the figure menu, 3D and 2D, against the figure the JAX
  `visualize(...)` returns: for each subplot its images' arrays,
  colormaps and limits, the warped grid's line segments and scatter
  offsets, the labels, whether the axis is shown, and the figure's
  colorbars and title. The port's figure is drawn from panels that went
  through `save_panels` / `load_panels`. Everything is bit-equal but
  the JDet map (the port's `jacobian_det` against XLA's): 1e-5 of its
  scale. No pixels are compared.
- `Evaluate.run_one_model(visualize=True)` on a small 2D model writes
  the `.npz` figures, their `.png` (matplotlib is installed here) and
  the JDet tables.
"""

import matplotlib
import numpy as np
import pytest
import torch
from matplotlib.collections import LineCollection, PathCollection

from pulpo_tpu.eval import flow_viz as jax_flow_viz
from pulpo_tpu.eval import visualize as jax_vis
from pulpo_tpu.train import metrics as jax_metrics
from pulpo_tpu_torch.eval import flow_viz, visualize as vis
from pulpo_tpu_torch.train.metrics import MetricWriter, read_images
from test_torch_threads import one_torch_thread  # noqa: F401

matplotlib.use("Agg")

SIZES = {3: (12, 10, 14), 2: (20, 24)}
K, N, C = 4, 5, 4  # latent levels, samples, segmentation classes
ROWS = sorted(vis.ROW_MENU)
VAL_TAGS = ["val/x", "val/y", "val/y_pred", "val/distance", "val/DF"] + [
    f"val_levels/{k}_level_{l}" for l in range(2)
    for k in ("recon", "individual_DF", "final_DF")]


# ---------------------------------------------------------------------------
# flow_viz
# ---------------------------------------------------------------------------

FLOW_RNG = np.random.default_rng(0)
FLOW_CASES = {
    "flow_to_image": (FLOW_RNG.standard_normal((3, 9, 11, 2)).astype(np.float32) * 4,),
    "middle_slice": (FLOW_RNG.standard_normal((2, 5, 6, 7, 3)),),
    "df_slice_channels": (FLOW_RNG.standard_normal((2, 5, 6, 7, 3)),),
    "make_grid": (FLOW_RNG.integers(0, 255, (5, 7, 9, 3)).astype(np.uint8),),
}


@pytest.mark.parametrize("name", sorted(FLOW_CASES))
def test_flow_viz_is_bit_equal(name):
    got = getattr(flow_viz, name)(*FLOW_CASES[name])
    ref = getattr(jax_flow_viz, name)(*FLOW_CASES[name])
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_flow_to_image_of_a_zero_field_and_grid_rows():
    np.testing.assert_array_equal(flow_viz.flow_to_image(np.zeros((1, 3, 4, 2))),
                                  jax_flow_viz.flow_to_image(np.zeros((1, 3, 4, 2))))
    imgs = np.ones((3, 2, 2, 1), np.float32)
    np.testing.assert_array_equal(flow_viz.make_grid(imgs, nrow=3, pad=1),
                                  jax_flow_viz.make_grid(imgs, nrow=3, pad=1))


# ---------------------------------------------------------------------------
# validation panels
# ---------------------------------------------------------------------------


class _Board:
    """A tensorboardX `SummaryWriter` stand-in that keeps `add_image`'s
    arguments."""

    def __init__(self, log_dir):
        self.images = {}

    def add_image(self, tag, img, step, dataformats="CHW"):
        assert dataformats == "HWC"
        self.images[tag] = (np.array(img), step)

    def add_scalar(self, *a):
        pass


def _level_arrays(rng, size, levels=2):
    nd = len(size)
    shapes = [tuple(-(-s // 2**l) for s in size) for l in range(levels)]
    y_hat = {l: rng.random((2, *s, 1), dtype=np.float32) for l, s in enumerate(shapes)}
    ind = {l: rng.standard_normal((2, *s, nd)).astype(np.float32) for l, s in enumerate(shapes)}
    fin = {l: rng.standard_normal((2, *s, nd)).astype(np.float32) * 3 for l, s in enumerate(shapes)}
    return y_hat, ind, fin


@pytest.mark.parametrize("ndims", [3, 2])
def test_validation_grids_match_the_jax_writer(ndims, tmp_path, monkeypatch):
    import tensorboardX

    monkeypatch.setattr(tensorboardX, "SummaryWriter", _Board)
    rng = np.random.default_rng(ndims)
    size = SIZES[ndims]
    x, y, y_pred = (rng.random((2, *size, 1), dtype=np.float32) for _ in range(3))
    df = rng.standard_normal((2, *size, ndims)).astype(np.float32) * 2
    levels = _level_arrays(rng, size)

    ref = jax_metrics.MetricWriter(tmp_path)
    ref.log_validation_images("val", x, y, y_pred, df, 7)
    ref.log_level_images("val_levels", *levels, 7)
    got = MetricWriter(tmp_path)
    # the port's eval step hands it tensors
    t = lambda a: torch.from_numpy(a)
    got.log_validation_images("val", t(x), t(y), t(y_pred), t(df), 7)
    got.log_level_images("val_levels", *({l: t(v) for l, v in d.items()} for d in levels), 7)
    got.close()
    images = read_images(tmp_path)
    assert list(images) == [7] and sorted(images[7]) == sorted(ref.writer.images)
    assert sorted(images[7]) == sorted(VAL_TAGS)
    for tag, (img, step) in ref.writer.images.items():
        assert step == 7 and images[7][tag].dtype == np.uint8 and images[7][tag].ndim == 3
        np.testing.assert_array_equal(images[7][tag], img, err_msg=tag)


def test_a_trainer_run_writes_the_validation_panels(tmp_path):
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.loader import DataLoader
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.train.loop import Trainer

    cfg = PULPoConfig(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=2,
                      batch_size=1, image_logging_frequency=2, val_check_interval=0.5,
                      max_epochs=2)
    mk = lambda seed, n: DataLoader(SyntheticDataset(shape=cfg.input_size, n=n, seed=seed),
                                    batch_size=1, shuffle=False, seed=seed)
    trainer = Trainer(cfg, run_dir=tmp_path, device="cpu")
    trainer.fit(mk(0, 2), mk(1, 2), max_steps=4)
    trainer.close()
    images = read_images(trainer.run_dir)
    # validation after every step; panels on every second round
    assert list(images) == [2, 4]
    for grids in images.values():
        assert sorted(grids) == sorted(VAL_TAGS)
        for g in grids.values():
            assert g.dtype == np.uint8 and g.ndim == 3 and g.shape[-1] == 3


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------


def synthetic_prediction(ndims, seed=0):
    """A batch and the (preds, all_preds) tuples of `Evaluate.predict` (N
    samples, segmentations), random arrays of the schema's shapes: level
    l at the input size over 2**l (rounded up)."""
    rng = np.random.default_rng(seed)
    size = SIZES[ndims]
    shapes = [tuple(-(-s // 2**l) for s in size) for l in range(K)]
    img = lambda *lead, s=size: rng.random((*lead, *s, 1), dtype=np.float32)
    field = lambda *lead, s=size: (rng.standard_normal((*lead, *s, ndims)) * 2).astype(np.float32)
    onehot = lambda *lead: np.eye(C, dtype=np.float32)[rng.integers(0, C, (*lead, *size))]
    levels = lambda f, *lead: {l: f(*lead, s=s) for l, s in enumerate(shapes)}
    batch = {"x": img(1), "y": img(1), "seg_x": onehot(1), "seg_y": onehot(1), "loader": "val"}
    outputs = levels(img, 1)
    outputs[1][..., :3, :] = 0  # an exact-zero band: the masked variance rows
    preds = [img(1), field(1), onehot(1), outputs,
             levels(field, 1), levels(field, 1), levels(field, 1),
             {l: onehot(1) for l in range(K)}, f"avg_prediction_over_{N}_samples"]
    std = lambda: {l: rng.random((1, *s), dtype=np.float32) for l, s in enumerate(shapes)}
    all_preds = [std(), std(), std(), levels(img, N), levels(field, N), levels(field, N),
                 levels(field, N), {l: onehot(N) for l in range(K)}]
    return batch, preds, all_preds


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def figure_info(fig, rows, ncols):
    """What each subplot shows: images (array, colormap, limits), line
    segments, scatter offsets, labels, axis on; and the figure's extra
    (colorbar) axes and title."""
    axes = []
    for ax in fig.axes[:rows * ncols]:
        axes.append({
            "images": [(np.asarray(im.get_array()), im.get_cmap().name, im.get_clim())
                       for im in ax.images],
            "segments": [np.concatenate(c.get_segments()) for c in ax.collections
                         if isinstance(c, LineCollection)],
            "offsets": [np.asarray(c.get_offsets()) for c in ax.collections
                        if isinstance(c, PathCollection)],
            "limits": (ax.get_xlim(), ax.get_ylim()) if ax.collections else None,
            "labels": (ax.get_xlabel(), ax.get_ylabel()), "on": ax.axison,
            "ticks": (list(ax.get_xticks()), list(ax.get_yticks())) if ax.axison else None,
        })
    extra = [[t.get_text() for t in ax.get_yticklabels()] for ax in fig.axes[rows * ncols:]]
    title = fig._suptitle.get_text() if fig._suptitle else ""
    return axes, extra, title


def _same_figure(got, ref, jdet_row=None, ncols=4):
    g_axes, g_extra, g_title = got
    r_axes, r_extra, r_title = ref
    assert g_title == r_title and len(g_extra) == len(r_extra)
    assert len(g_axes) == len(r_axes)
    for i, (g, r) in enumerate(zip(g_axes, r_axes)):
        where = f"subplot {i}"
        assert g["labels"] == r["labels"] and g["on"] == r["on"], where
        assert g["limits"] == r["limits"] and g["ticks"] == r["ticks"], where
        assert len(g["images"]) == len(r["images"]), where
        for (ga, gc, gl), (ra, rc, rl) in zip(g["images"], r["images"]):
            assert gc == rc and ga.shape == ra.shape, where
            if jdet_row is not None and i // ncols == jdet_row:
                assert gl == rl
                scale = max(np.abs(ra).max(), 1e-30)
                assert np.abs(ga.astype(np.float64) - ra).max() <= 1e-5 * scale, where
            else:
                assert gl == rl, where
                np.testing.assert_array_equal(ga, ra, err_msg=where)
        for key in ("segments", "offsets"):
            assert len(g[key]) == len(r[key]), where
            for ga, ra in zip(g[key], r[key]):
                np.testing.assert_array_equal(ga, ra, err_msg=where)


def _port_figure(tmp_path, *args, **kw):
    """The port's figure, drawn from panels that went through a file."""
    p = vis.panels(*args, **kw)
    vis.save_panels(p, tmp_path / "fig.npz")
    return vis.draw(tmp_path / "fig.npz")


@pytest.mark.parametrize("ndims", [3, 2])
@pytest.mark.parametrize("row", ROWS)
def test_figure_row_matches_jax(row, ndims, tmp_path):
    batch, preds, all_preds = synthetic_prediction(ndims)
    ref = jax_vis.visualize(batch, preds, [row], all_preds=all_preds, latent_levels=K)
    got = _port_figure(tmp_path, batch, _tensors(preds), [row],
                       all_preds=_tensors(all_preds), latent_levels=K)
    _same_figure(figure_info(got, 1, K), figure_info(ref, 1, K),
                 jdet_row=0 if row == "jdet" else None)


@pytest.mark.parametrize("rowparams", [{"flow": True, "grid": False},
                                       {"flow": False, "grid": True}])
@pytest.mark.parametrize("row", ["final_df_per_level", "individual_df_per_level"])
def test_figure_row_params_match_jax(row, rowparams, tmp_path):
    batch, preds, all_preds = synthetic_prediction(3, seed=1)
    ref = jax_vis.visualize(batch, preds, [row, "sample_preds"], all_preds=all_preds,
                            rowparams={0: rowparams, 1: {"level": 1}}, latent_levels=K)
    got = vis.visualize(batch, preds, [row, "sample_preds"], all_preds=all_preds,
                        rowparams={0: rowparams, 1: {"level": 1}}, latent_levels=K)
    _same_figure(figure_info(got, 2, K), figure_info(ref, 2, K))


@pytest.mark.parametrize("uq", [False, True])
def test_default_prediction_figure_matches_jax(uq, tmp_path):
    """The default menu of one prediction (`visualize_prediction`) with a
    title, 2D (the menu with per-sample segmentations) and 3D."""
    for ndims in (2, 3):
        batch, preds, all_preds = synthetic_prediction(ndims, seed=2)
        if not uq:
            preds[-1], all_preds = "deterministic_prediction", []
        if ndims == 3:
            all_preds = all_preds and all_preds[:7] + [{0: np.empty((0,), np.float32)}]
        rows, _ = vis.default_visualizations(True, uq, uq and ndims == 2)
        assert rows == jax_vis.default_visualizations(True, uq, uq and ndims == 2)[0]
        ref = jax_vis.visualize_prediction(batch, preds, all_preds, latent_levels=K,
                                           title="All visualizations")
        if uq:  # through a file
            p = vis.prediction_panels(batch, _tensors(preds), _tensors(all_preds),
                                      latent_levels=K, title="All visualizations")
            assert p.rows == len(rows)
            vis.save_panels(p, tmp_path / "fig.npz")
            got = vis.draw(tmp_path / "fig.npz", save_path=tmp_path / "fig.png")
        else:
            got = vis.visualize_prediction(batch, _tensors(preds), all_preds, latent_levels=K,
                                           title="All visualizations",
                                           save_path=tmp_path / "fig.png")
        assert (tmp_path / "fig.png").stat().st_size > 0
        _same_figure(figure_info(got, len(rows), K), figure_info(ref, len(rows), K),
                     jdet_row=rows.index("jdet"))


def test_run_one_model_writes_the_figures(tmp_path):
    """The evaluation entry point with figures on a small 2D model: per
    loader three predictions, each with its `.npz`, `.png` and JDet table,
    then the tables."""
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.eval.evaluator import Evaluate
    from pulpo_tpu_torch.models.api import PULPoModel

    cfg = PULPoConfig(input_size=(32, 40), total_levels=5, latent_levels=4, n0=2)
    model = PULPoModel(cfg, device="cpu")
    model.init(0)
    ev = Evaluate(device="cpu")
    ev.set_model(model, tmp_path)
    perf, unc = ev.run_one_model(segs=True, lms=False, N=3, task="synthetic", visualize=True)
    assert np.isfinite(perf[("val", "Dice")]).all() and np.isfinite(unc[("test", "Var")]).all()
    for loader in ("train", "val", "test"):
        for pred in ("deterministic", "sample", "avg_3"):
            p = vis.load_panels(tmp_path / "vis" / f"allvis{loader}_{pred}.npz")
            uq = pred == "avg_3"  # in 2D with the per-sample segmentations
            assert p.rows == len(vis.default_visualizations(True, uq, uq)[0])
            assert p.title.startswith(f"All visualizations on {loader} set with {pred}")
            for row in p.axes:
                for a in row:
                    assert a.image is None or np.isfinite(a.image.astype(np.float64)).all()
            assert (tmp_path / "vis" / f"allvis{loader}_{pred}.png").stat().st_size > 0
            assert (tmp_path / "jdet" / f"jdet_{loader}_{pred}.csv").exists()
