"""Evaluation figures: the configurable multi-row visualization driver.

Port of pulpo_tpu/eval/visualize.py (the reference's `Evaluate.visualize`,
evaluate.py:681-832, and its row menu, evaluate.py:833-1138). Callers
pass a list of row names (or row callables) plus optional per-row
parameter overrides (`rowparams`), and each row fills one row of a
figure of max(4, latent_levels) columns.

The card's machine has no matplotlib, so each row is split in two:

- its numpy part (`vis_*`, called by `panels`) returns one `Panel` per
  column: the array behind the subplot (already rotated for display)
  with its colormap and limits, the warped-grid polylines and scatter
  points, the labels, the colorbar and whether the axis is shown;
- `draw(panels, save_path)` imports matplotlib (lazily, only there) and
  makes the figure from the panels alone, with the JAX module's calls.

`visualize(...)` is `draw(panels(...))` and returns the figure, as the
JAX function does. `save_panels` / `load_panels` keep a figure's panels
in one `.npz`, so that `draw` can make the figure on any host that has
matplotlib from a file written where it has not.

Row menu (reference method of the same name):

  x_pred_y                 :833   segx_segpred_segy        :856
  pred_per_level           :883   segpred_per_level        :897
  diff_input_pred          :914   diff_target_pred         :929
  jdet                     :944   final_df_per_level       :967
  combined_df_per_level    :991   individual_df_per_level  :1016
  output_var_per_level     :1041  individual_df_var_per_level :1057
  final_df_var_per_level   :1080  sample_preds             :1098
  sample_segpreds          :1109  sample_dfs               :1120

Data layout: channels-last; 3D volumes are sliced to the middle of
spatial axis -2 (the reference's `[..., idx, :]` on NC(D)HW tensors,
evaluate.py:697-776) and 3-channel DFs keep channels (0, 2); the slice
is taken where the tensor lies (on the card for the card's
predictions), and only the slice is copied to the host. `vis_jdet`
keeps the JAX module's divergence from the reference: the determinant
of the 3D field is computed, then sliced.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pulpo_tpu_torch.eval.flow_viz import flow_to_image
from pulpo_tpu_torch.ops.losses import jacobian_det


def _np(a) -> np.ndarray:
    """A tensor on any device (float32 on the host) or an array."""
    if torch.is_tensor(a):
        a = a.detach()
        return (a.float() if a.is_floating_point() else a).cpu().numpy()
    return np.asarray(a)


def _ndim(a) -> int:
    return a.dim() if torch.is_tensor(a) else np.ndim(a)


# ---------------------------------------------------------------------------
# 2D slicing (evaluate.py:693-780)
# ---------------------------------------------------------------------------


def _slice2d(a, is_df=False):
    """(B, *spatial, C) -> (B, H, W, C') middle slice of axis -2 (3D);
    also the (N, *spatial, C) per-sample buffers."""
    if _ndim(a) == 5:  # (B, D, H, W, C)
        a = _np(a[:, :, a.shape[2] // 2, :, :])
        if is_df and a.shape[-1] == 3:
            a = np.stack([a[..., 0], a[..., 2]], axis=-1)
    return _np(a)


def _slice_map(a):
    """(B, *spatial) std/variance map -> (B, H, W)."""
    if _ndim(a) == 4:
        a = a[:, :, a.shape[2] // 2, :]
    return _np(a)


def _seg_label(seg2d):
    """One-hot (H, W, C) -> label map."""
    return np.argmax(np.asarray(seg2d), axis=-1)


def _has(x) -> bool:
    if x is None:
        return False
    return (x.numel() if torch.is_tensor(x) else np.asarray(x).size) > 0


def _resize2d(a, shape):
    """Nearest-neighbor resize of a 2D map (mask alignment only)."""
    a = np.asarray(a)
    iy = np.clip((np.arange(shape[0]) * a.shape[0] / shape[0]).astype(int),
                 0, a.shape[0] - 1)
    ix = np.clip((np.arange(shape[1]) * a.shape[1] / shape[1]).astype(int),
                 0, a.shape[1] - 1)
    return a[np.ix_(iy, ix)]


# ---------------------------------------------------------------------------
# Warped grid (evaluate.py:430-526)
# ---------------------------------------------------------------------------


def create_warped_grid(df2d: np.ndarray, grid_size: int = 20):
    """Sparse control grid displaced by -df at the grid points,
    b-spline smoothed via scipy when available.
    df2d: (H, W, 2) with channels (row-disp, col-disp)."""
    h, w, _ = df2d.shape
    ys = np.linspace(0, h - 1, grid_size)
    xs = np.linspace(0, w - 1, grid_size)
    lines = []

    def smooth(points):
        try:
            from scipy.interpolate import splev, splprep

            if len(points) > 3:
                tck, _ = splprep(points.T, s=0, k=3)
                u = np.linspace(0, 1, len(points) * 4)
                return np.stack(splev(u, tck), axis=1)
        except Exception:
            pass
        return points

    def warped_point(yv, xv):
        iy, ix = int(round(yv)), int(round(xv))
        d = df2d[iy, ix]
        return [xv - d[1], yv - d[0]]

    for yv in ys:
        lines.append(smooth(np.asarray([warped_point(yv, xv) for xv in xs])))
    for xv in xs:
        lines.append(smooth(np.asarray([warped_point(yv, xv) for yv in ys])))
    return lines


def _flow_img(df2d):
    """(H, W, 2) -> RGB flow colorization, display-rotated."""
    return np.rot90(flow_to_image(np.asarray(df2d)[None])[0])


# ---------------------------------------------------------------------------
# Panels: what one subplot shows
# ---------------------------------------------------------------------------


class Panel:
    """One subplot. `image` is the array `imshow` gets (already rotated
    for display) with `cmap`, `vmin`, `vmax`; `grid` the warped-grid
    polylines (a `LineCollection`), `scatter` whether their points are
    scattered too; `colorbar` is None, "image" (a colorbar of the image,
    fraction 0.04) or "hsv" (the flow-direction colorbar); `off` hides
    the axis."""

    FIELDS = ("cmap", "vmin", "vmax", "xlabel", "ylabel", "colorbar", "off", "scatter")

    def __init__(self):
        self.image = None
        self.cmap = self.vmin = self.vmax = None
        self.grid = self.grid_shape = None
        self.scatter = False
        self.xlabel = self.ylabel = ""
        self.colorbar = None
        self.off = False

    def img(self, a, cmap="gray", vmin=None, vmax=None, label=None):
        """`_img` of the JAX module: the rotated 2D map with its limits."""
        self.image = np.rot90(np.asarray(a))
        self.cmap, self.vmin, self.vmax = cmap, vmin, vmax
        if label:
            self.xlabel = label

    def rgb(self, a):
        """An RGB image, shown as it is."""
        self.image = np.asarray(a)
        self.cmap = None

    def plot_grid(self, df2d, grid_size=20, scatter=False):
        """`_plot_grid` of the JAX module: the reference rotates the field
        spatially before gridding (np.rot90(df, axes=(-2,-1)),
        evaluate.py:977) without remapping the displacement channels."""
        rot = np.rot90(np.asarray(df2d), axes=(0, 1))
        self.grid = create_warped_grid(rot, grid_size)
        self.grid_shape = rot.shape[:2]
        self.scatter = scatter


def _row(ctx):
    return [Panel() for _ in range(ctx.ncols)]


def _off_extra(row, latent_levels):
    for c in range(latent_levels, len(row)):
        row[c].off = True


# ---------------------------------------------------------------------------
# Row functions. Signature: (ctx, **rowparams) -> [Panel] * ncols; `ctx`
# carries the 2D-sliced inputs/preds/all_preds and figure-level settings.
# ---------------------------------------------------------------------------


class _Ctx:
    def __init__(self, batch, preds, all_preds, latent_levels, grid_size, ncols):
        self.batch = batch
        self.preds = preds
        self.all_preds = all_preds
        self.latent_levels = latent_levels
        self.grid_size = grid_size
        self.ncols = ncols


def vis_x_pred_y(ctx, vmin=0, vmax=1):
    """Moving | prediction | fixed | flow (evaluate.py:833-854)."""
    ax = _row(ctx)
    ax[0].img(ctx.batch["x"][0, ..., 0], vmin=vmin, vmax=vmax, label="Input")
    ax[1].img(ctx.preds[0][0, ..., 0], vmin=vmin, vmax=vmax, label="Prediction")
    ax[2].img(ctx.batch["y"][0, ..., 0], vmin=vmin, vmax=vmax, label="Target")
    ax[3].rgb(_flow_img(ctx.preds[6][0][0]))
    ax[3].xlabel = "DF"
    ax[0].ylabel = "input vs prediction"
    ax[3].colorbar = "hsv"
    return ax


def vis_segx_segpred_segy(ctx):
    """Seg triplet + flow (evaluate.py:856-881)."""
    ax = _row(ctx)
    ax[0].img(_seg_label(ctx.batch["seg_x"][0]), cmap="tab20", label="Input")
    ax[1].img(_seg_label(ctx.preds[2][0]), cmap="tab20", label="Prediction")
    ax[2].img(_seg_label(ctx.batch["seg_y"][0]), cmap="tab20", label="Target")
    ax[3].rgb(_flow_img(ctx.preds[1][0]))
    ax[3].xlabel = "DF"
    ax[0].ylabel = "segmentation input vs prediction"
    ax[3].colorbar = "hsv"
    return ax


def vis_pred_per_level(ctx, vmin=0, vmax=1):
    """Per-level predictions, coarse->fine left->right (evaluate.py:883)."""
    ax, K = _row(ctx), ctx.latent_levels
    for l in reversed(range(K)):
        ax[K - l - 1].img(ctx.preds[3][l][0, ..., 0], vmin=vmin, vmax=vmax, label=f"Level {l}")
    ax[0].ylabel = "Predictions per level"
    _off_extra(ax, K)
    return ax


def vis_segpred_per_level(ctx):
    """Per-level predicted segmentations (evaluate.py:897-909)."""
    ax, K = _row(ctx), ctx.latent_levels
    for l in reversed(range(K)):
        ax[K - l - 1].img(_seg_label(ctx.preds[7][l][0]), cmap="tab20", label=f"Level {l}")
    ax[0].ylabel = "Predicted segmentation per level"
    _off_extra(ax, K)
    return ax


def _diff_row(ctx, target_key, name, vmin, vmax):
    ax, K = _row(ctx), ctx.latent_levels
    tgt_full = ctx.batch[target_key][0, ..., 0]
    for l in reversed(range(K)):
        pred = ctx.preds[3][l][0, ..., 0]
        tgt = _resize2d(tgt_full, pred.shape)
        ax[K - l - 1].img(pred - tgt, vmin=vmin, vmax=vmax, label=f"Level {l}")
    ax[0].ylabel = name
    _off_extra(ax, K)
    return ax


def vis_diff_input_pred(ctx, vmin=-1, vmax=1):
    """outputs[l] - resize(x) per level (evaluate.py:914-927)."""
    return _diff_row(ctx, "x", "Difference Input / Predictions per level", vmin, vmax)


def vis_diff_target_pred(ctx, vmin=-1, vmax=1):
    """outputs[l] - resize(y) per level (evaluate.py:929-942)."""
    return _diff_row(ctx, "y", "Difference Target / Predictions per level", vmin, vmax)


def vis_jdet(ctx):
    """Jacobian-determinant heatmaps of the final dfs (evaluate.py:944)."""
    ax, K = _row(ctx), ctx.latent_levels
    for l in reversed(range(K)):
        ax[K - l - 1].img(ctx.jdet[l], cmap="coolwarm", vmin=-2, vmax=4, label=f"Level {l}")
        if l == 0:
            ax[K - l - 1].colorbar = "image"
    ax[0].ylabel = "heatmap of JDet std"
    _off_extra(ax, K)
    return ax


def _df_row(ctx, dfs, name, flow=True, grid=True, scatter=False):
    ax, K = _row(ctx), ctx.latent_levels
    for l in reversed(range(K)):
        a = ax[K - l - 1]
        if flow:
            a.rgb(_flow_img(dfs[l][0]))
        if grid:
            a.plot_grid(dfs[l][0], ctx.grid_size, scatter=scatter)
        a.xlabel = f"Level {l}"
    ax[0].ylabel = name
    _off_extra(ax, K)
    return ax


def vis_final_df_per_level(ctx, flow=True, grid=True):
    """Final DF per level, flow + warped grid (evaluate.py:967-989)."""
    return _df_row(ctx, ctx.preds[6], "Final DF per level.", flow, grid)


def vis_combined_df_per_level(ctx, flow=True, grid=True):
    """Combined DF per level (evaluate.py:991-1014)."""
    return _df_row(ctx, ctx.preds[5], "Combined DF per level.", flow, grid)


def vis_individual_df_per_level(ctx, flow=True, grid=True):
    """Individual DF per level (evaluate.py:1016-1039)."""
    return _df_row(ctx, ctx.preds[4], "Individual DF per level.", flow, grid)


def _var_row(ctx, std_map, name, mask_from_outputs=False):
    ax, K = _row(ctx), ctx.latent_levels
    for l in reversed(range(K)):
        var = np.asarray(std_map[l][0]) ** 2
        if mask_from_outputs:
            out = ctx.preds[3][l][0, ..., 0]
            mask = _resize2d(out, var.shape)
            var = np.where(mask == 0, 0.0, var)
        ax[K - l - 1].img(var, cmap="viridis", label=f"Level {l}")
        ax[K - l - 1].colorbar = "image"
    ax[0].ylabel = name
    _off_extra(ax, K)
    return ax


def vis_output_var_per_level(ctx):
    """Prediction variance heatmaps (evaluate.py:1041-1055)."""
    return _var_row(ctx, ctx.all_preds[0], "heatmap of prediction variance")


def vis_individual_df_var_per_level(ctx):
    """Individual-DF variance, masked where the prediction is 0
    (evaluate.py:1057-1078)."""
    return _var_row(ctx, ctx.all_preds[1], "heatmap of individual DF var",
                    mask_from_outputs=True)


def vis_final_df_var_per_level(ctx):
    """Final-DF variance, masked where the prediction is 0
    (evaluate.py:1080-1096)."""
    return _var_row(ctx, ctx.all_preds[2], "heatmap of final DF var",
                    mask_from_outputs=True)


def vis_sample_preds(ctx, level=0, vmin=0, vmax=1):
    """Per-sample predictions at one level (evaluate.py:1098-1107)."""
    ax = _row(ctx)
    samples = ctx.all_preds[3][level]
    n = min(samples.shape[0], ctx.latent_levels)
    for s in range(n):
        ax[s].img(samples[s, ..., 0], vmin=vmin, vmax=vmax)
    ax[0].ylabel = f"Sample predictions on level {level}"
    _off_extra(ax, n)
    return ax


def vis_sample_segpreds(ctx, level=0):
    """Per-sample predicted segmentations (evaluate.py:1109-1118)."""
    ax = _row(ctx)
    samples = ctx.all_preds[7][level]
    n = min(samples.shape[0], ctx.latent_levels)
    for s in range(n):
        ax[s].img(_seg_label(samples[s]), cmap="tab20")
    ax[0].ylabel = f"Sample predicted segmentations on level {level}"
    _off_extra(ax, n)
    return ax


def vis_sample_dfs(ctx, level=0, flow=True, grid=True):
    """Per-sample final DFs as warped grids (evaluate.py:1120-1138)."""
    ax = _row(ctx)
    samples = ctx.all_preds[6][level]
    n = min(samples.shape[0], ctx.latent_levels)
    for s in range(n):
        if grid:
            ax[s].plot_grid(samples[s], ctx.grid_size, scatter=True)
    ax[0].ylabel = f"Sample predicted DFs on level {level}"
    ax[3].colorbar = "hsv"
    _off_extra(ax, n)
    return ax


ROW_MENU = {
    "x_pred_y": vis_x_pred_y,
    "segx_segpred_segy": vis_segx_segpred_segy,
    "pred_per_level": vis_pred_per_level,
    "segpred_per_level": vis_segpred_per_level,
    "diff_input_pred": vis_diff_input_pred,
    "diff_target_pred": vis_diff_target_pred,
    "jdet": vis_jdet,
    "final_df_per_level": vis_final_df_per_level,
    "combined_df_per_level": vis_combined_df_per_level,
    "individual_df_per_level": vis_individual_df_per_level,
    "output_var_per_level": vis_output_var_per_level,
    "individual_df_var_per_level": vis_individual_df_var_per_level,
    "final_df_var_per_level": vis_final_df_var_per_level,
    "sample_preds": vis_sample_preds,
    "sample_segpreds": vis_sample_segpreds,
    "sample_dfs": vis_sample_dfs,
}


def default_visualizations(segs: bool, has_uq: bool, has_sample_segs: bool = False):
    """The reference's standard menus (evaluate.py:1613-1697)."""
    rows = ["x_pred_y"]
    if segs:
        rows += ["segx_segpred_segy"]
    rows += ["pred_per_level"]
    if segs:
        rows += ["segpred_per_level"]
    rows += ["diff_input_pred", "diff_target_pred", "final_df_per_level",
             "combined_df_per_level", "individual_df_per_level", "jdet"]
    rowparams = {}
    if has_uq:
        rows += ["output_var_per_level", "individual_df_var_per_level",
                 "final_df_var_per_level", "sample_preds"]
        if segs and has_sample_segs:
            rows += ["sample_segpreds"]
        rows += ["sample_dfs"]
        # the reference disables the grid overlay on the (large) final /
        # combined df rows in UQ figures (rowparams at evaluate.py:1678)
        rowparams[rows.index("final_df_per_level")] = {"flow": True, "grid": False}
        rowparams[rows.index("combined_df_per_level")] = {"flow": True, "grid": False}
    return rows, rowparams


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _slice_level_dict(d, is_df=False):
    if d is None:
        return None
    return {l: _slice2d(v, is_df=is_df) if _has(v) else _np(v) for l, v in d.items()}


class Panels:
    """A figure's panels: `axes[r][c]` the Panel of row r, column c, with
    the figure's title and size settings."""

    def __init__(self, axes, title, latent_levels):
        self.axes = axes
        self.title = title
        self.latent_levels = latent_levels

    @property
    def rows(self) -> int:
        return len(self.axes)


def panels(batch, preds, visualizations, all_preds=None, rowparams=None,
           latent_levels: int = 4, grid_size: int = 20, title: str = "") -> Panels:
    """The selected rows' panels (evaluate.py:681-832; the JAX
    `visualize` less its drawing).

    `visualizations`: list of row names (see ROW_MENU) or callables.
    `rowparams`: {row_index: kwargs} overrides, like the reference's.
    `preds`/`all_preds`: the tuples produced by Evaluate.predict.
    """
    rowparams = rowparams or {}
    # the reference hardcodes 4 columns (evaluate.py:705); widen for
    # configs with more latent levels so per-level rows don't overflow
    ncols = max(4, latent_levels)
    if title:
        title = f"{title}. {preds[-1]} on the {batch.get('loader', '?')} set."

    # ---- slice everything to 2D once (evaluate.py:693-780) ----
    b2 = {k: (_slice2d(v) if _has(v) and not np.isscalar(v) and not isinstance(v, str)
              and _ndim(v) >= 4 else v)
          for k, v in batch.items()}
    p2 = [
        _slice2d(preds[0]),                        # y_pred
        _slice2d(preds[1], is_df=True) if _has(preds[1]) else np.empty(0),  # df_pred
        _slice2d(preds[2]) if _has(preds[2]) else np.empty(0),  # seg_pred
        _slice_level_dict(preds[3]),               # outputs
        _slice_level_dict(preds[4], is_df=True),   # individual dfs
        _slice_level_dict(preds[5], is_df=True),   # combined dfs
        _slice_level_dict(preds[6], is_df=True),   # final dfs
        _slice_level_dict(preds[7]),               # warped seg
        preds[8],
    ]

    a2 = None
    if all_preds:
        a2 = [
            {l: _slice_map(v) for l, v in all_preds[0].items()},  # output_std
            {l: _slice_map(v) for l, v in all_preds[1].items()},
            {l: _slice_map(v) for l, v in all_preds[2].items()},
            _slice_level_dict(all_preds[3]),
            _slice_level_dict(all_preds[4], is_df=True),
            _slice_level_dict(all_preds[5], is_df=True),
            _slice_level_dict(all_preds[6], is_df=True),
            (_slice_level_dict(all_preds[7]) if _has(all_preds[7].get(0)) else all_preds[7]),
        ]

    ctx = _Ctx(b2, p2, a2, latent_levels, grid_size, ncols)
    # the determinant of the 3D final dfs, then sliced (the reference
    # takes it of the sliced 2D field; the JAX module's divergence, see
    # DIVERGENCES.md on vis_jdet)
    ctx.jdet = {}
    with torch.inference_mode():
        for l, v in preds[6].items():
            v = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            jd = jacobian_det(v.float())[0]
            ctx.jdet[l] = _np(jd[:, jd.shape[1] // 2, :] if jd.dim() == 3 else jd)

    axes = []
    for r, row in enumerate(visualizations):
        fn = ROW_MENU[row] if isinstance(row, str) else row
        axes.append(fn(ctx, **rowparams.get(r, {})))
    return Panels(axes, title, latent_levels)


def prediction_panels(batch, preds, all_preds, latent_levels: int, title: str = "",
                      grid_size: int = 20) -> Panels:
    """The default menu's panels for one prediction (the standard figure
    of run_one_model, evaluate.py:1613-1697)."""
    segs = _has(batch.get("seg_x")) and _has(preds[2])
    has_uq = bool(all_preds)
    has_sample_segs = has_uq and _has(all_preds[7].get(0))
    rows, rowparams = default_visualizations(segs, has_uq, has_sample_segs)
    if has_uq and (all_preds[4] is None or all_preds[6] is None):
        # streamed (keep_samples=False) mode: no per-sample df rows
        rows = [r for r in rows if r not in ("sample_dfs",)]
    return panels(batch, preds, rows, all_preds=all_preds, rowparams=rowparams,
                  latent_levels=latent_levels, grid_size=grid_size, title=title)


# ---------------------------------------------------------------------------
# Files: one .npz a figure
# ---------------------------------------------------------------------------


def save_panels(p: Panels, path) -> None:
    """One `.npz`: `r<r>c<c>_image` for each image, `r<r>c<c>_grid` (the
    polylines' points, concatenated) and `r<r>c<c>_grid_len` (their
    lengths) for each warped grid, and `meta`, a JSON string of the rest."""
    arrays = {}
    meta = {"title": p.title, "latent_levels": p.latent_levels, "axes": []}
    for r, row in enumerate(p.axes):
        meta_row = []
        for c, a in enumerate(row):
            m = {k: getattr(a, k) for k in Panel.FIELDS}
            m = {k: (float(v) if isinstance(v, (np.floating, np.integer)) else v)
                 for k, v in m.items()}
            if a.image is not None:
                arrays[f"r{r}c{c}_image"] = np.ascontiguousarray(a.image)
            if a.grid is not None:
                arrays[f"r{r}c{c}_grid"] = np.concatenate(a.grid, axis=0)
                arrays[f"r{r}c{c}_grid_len"] = np.asarray([len(g) for g in a.grid])
                m["grid_shape"] = [int(s) for s in a.grid_shape]
            meta_row.append(m)
        meta["axes"].append(meta_row)
    np.savez(path, meta=np.asarray(json.dumps(meta)), **arrays)


def load_panels(path) -> Panels:
    """The panels `save_panels` wrote."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        axes = []
        for r, meta_row in enumerate(meta["axes"]):
            row = []
            for c, m in enumerate(meta_row):
                a = Panel()
                for k in Panel.FIELDS:
                    setattr(a, k, m[k])
                if f"r{r}c{c}_image" in z.files:
                    a.image = z[f"r{r}c{c}_image"]
                if f"r{r}c{c}_grid" in z.files:
                    pts, lens = z[f"r{r}c{c}_grid"], z[f"r{r}c{c}_grid_len"]
                    a.grid = np.split(pts, np.cumsum(lens)[:-1])
                    a.grid_shape = tuple(m["grid_shape"])
                row.append(a)
            axes.append(row)
    return Panels(axes, meta["title"], meta["latent_levels"])


# ---------------------------------------------------------------------------
# Drawing (matplotlib, imported here only)
# ---------------------------------------------------------------------------


def draw(p, save_path=None, show: bool = False):
    """The figure of `p` (a `Panels`, or the path of a `.npz` that
    `save_panels` wrote), with the JAX module's matplotlib calls; saved
    to `save_path` at 60 dpi when given. Returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm
    from matplotlib.collections import LineCollection

    if not isinstance(p, Panels):
        p = load_panels(p)
    rows, K = p.rows, p.latent_levels
    fig, ax = plt.subplots(rows, max(4, K))
    fig.set_figwidth(30)
    fig.set_figheight(30 * rows / max(K, 1))
    if p.title:
        fig.suptitle(p.title, fontsize=16)
    if rows == 1:
        ax = np.asarray([ax])
    ax = np.atleast_2d(ax)
    for r, row in enumerate(p.axes):
        for c, a in enumerate(row):
            axis = ax[r][c]
            im = None
            if a.image is not None:
                im = axis.imshow(a.image, cmap=a.cmap, vmin=a.vmin, vmax=a.vmax)
            if a.grid is not None:
                axis.add_collection(LineCollection(a.grid, colors="black", linewidths=0.5))
                if a.scatter:
                    pts = np.concatenate(a.grid, axis=0)
                    axis.scatter(pts[:, 0], pts[:, 1], s=0.3, c="black")
                h, w = a.grid_shape
                axis.set_xlim(-1, w)
                axis.set_ylim(h, -1)
            if a.xlabel:
                axis.set_xlabel(a.xlabel)
            if a.ylabel:
                axis.set_ylabel(a.ylabel)
            if a.colorbar == "image":
                fig.colorbar(im, ax=axis, fraction=0.04)
            elif a.colorbar == "hsv":
                cbar = plt.colorbar(cm.ScalarMappable(cmap=plt.get_cmap("hsv")), ax=axis)
                cbar.set_ticks([0.18, 0.51, 0.7, 1.0])
                cbar.set_ticklabels(["←", "↓", "→", "↑"])
            if a.off:
                axis.axis("off")
        for c in range(4):
            ax[r][c].set_xticks([])
            ax[r][c].set_yticks([])
    if save_path is not None:
        fig.savefig(save_path, dpi=60)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return fig


def visualize(batch, preds, visualizations, all_preds=None, rowparams=None,
              latent_levels: int = 4, grid_size: int = 20, title: str = "",
              save_path=None, show: bool = False):
    """Render the selected rows into one figure (evaluate.py:681-832):
    `draw(panels(...))`. Returns the figure."""
    return draw(panels(batch, preds, visualizations, all_preds=all_preds,
                       rowparams=rowparams, latent_levels=latent_levels,
                       grid_size=grid_size, title=title),
                save_path=save_path, show=show)


def visualize_prediction(batch, preds, all_preds, latent_levels: int,
                         title: str = "", save_path=None, grid_size: int = 20):
    """The default-menu figure for one prediction: `draw(prediction_panels(...))`."""
    return draw(prediction_panels(batch, preds, all_preds, latent_levels, title=title,
                                  grid_size=grid_size), save_path=save_path)
