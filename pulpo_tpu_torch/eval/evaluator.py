"""The evaluation suite: figures, deterministic performance tables,
N-sample uncertainty tables, the robustness (artifact) experiments, the
DIF-VoxelMorph baseline and the multi-model table (the reference's
evaluate.py, class Evaluate).

Port of pulpo_tpu/eval/evaluator.py: `load_model` (the port's
checkpoints), `set_model`, `load_data`, `predict`, `performance`,
`uncertainty`, `performance_affine` (each with `artifact=`),
`run_one_model`, `load_vxm`, `performance_vxm`, `uncertainty_vxm` and
`compare_models`. Output layout as the reference:
<run_dir>/evaluation/{vis, jdet, loss, uncertainty}/...

Tables are `eval.tables.Table`s (no pandas on the card's machine). The
reference's conventions are kept: exact-zero entries are scrubbed to
NaN before the mean over inputs (its "empty slot" sentinel; not in
`compare_models`, as in the JAX package), and the landmarks thread
through `predict_with_uncertainty(lm=...)` so that the per-sample
landmark warps use the same draws as the Var/NCC maps.

Figures (`run_one_model(visualize=True)`): each figure's panels are
written to `vis/allvis<loader>_<prediction>.npz` on every host
(`eval/visualize.save_panels`), and its `.png` beside them where
matplotlib is installed (the card's machine has none;
`eval/visualize.draw` makes the same PNG from the `.npz` elsewhere).

The artifact experiments corrupt the moving image on the host, in
numpy and scipy (`eval/artifact.py`), as the JAX package does: the
image is copied to the host, corrupted and sent back before the
prediction.

Tasks: oasis (loaders train / val / test_seg / test_lm), brats and
lungct (train / val / test), synthetic.
"""

from __future__ import annotations

import importlib.util
import pathlib
import warnings

import numpy as np
import torch

from pulpo_tpu_torch.eval import metrics as M
from pulpo_tpu_torch.eval.artifact import artifact as artifact_fn
from pulpo_tpu_torch.eval.tables import Table, make_tables, multiindex_table, table_jdet
from pulpo_tpu_torch.models.api import PULPoModel, _as_tensor, combine_dfs, resolve_device
from pulpo_tpu_torch.ops import losses as L
from pulpo_tpu_torch.ops.warp import warp_image, warp_landmarks
from pulpo_tpu_torch.uq.predict import device_budget, predict_with_uncertainty, retention_bytes


def _nanmean(a: np.ndarray) -> np.ndarray:
    """The zero-scrub, then the mean over the last axis (inputs); an
    all-NaN slot stays NaN without a warning."""
    a = np.where(a == 0, np.nan, a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(a, axis=-1)


def _has(a) -> bool:
    return a is not None and np.asarray(a).size > 0


class Evaluate:
    """Evaluation driver (reference evaluate.py:31-59). Runs on `cuda`
    unless `device="cpu"` is given."""

    def __init__(self, checkpoint_name: str = "best-reconstruction-loss", device=None):
        self.checkpoint_name = checkpoint_name
        self.device = resolve_device(device)
        self.model: PULPoModel | None = None
        self.latent_levels = None
        self.segs = self.lms = self.mask = False
        self.output_dir = None
        self.loaded_checkpoint: str | None = None
        # each N-sample prediction draws its seed from this generator, as
        # the JAX Evaluate splits its key(0) once per call
        self.rng = torch.Generator().manual_seed(0)

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    def load_model(self, run_dir) -> PULPoModel:
        """The config and the best-reconstruction checkpoint (else
        `latest`) of a run directory (reference evaluate.py:33, 91-111)."""
        from pulpo_tpu_torch.train.checkpoint import (
            CheckpointManager,
            checkpoint_path,
            read_checkpoint,
        )

        run_dir = pathlib.Path(run_dir)
        cfg = CheckpointManager.load_config(run_dir)
        model = PULPoModel(cfg, device=self.device)
        name = self.checkpoint_name
        if not checkpoint_path(run_dir, name).exists():
            name = "latest"
        model.load_state_dict(read_checkpoint(run_dir, name)["model"])
        self.loaded_checkpoint = name
        output_dir = run_dir / "evaluation"
        return self.set_model(model, output_dir)

    def set_model(self, model: PULPoModel, output_dir="evaluation_out") -> PULPoModel:
        """Use an in-memory model (no checkpoint round-trip)."""
        self.model = model
        self.latent_levels = model.cfg.latent_levels
        self.output_dir = pathlib.Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        return model

    def load_data(self, task, segs, lms, mask, ndims=3, path=None):
        """Build the task's loaders and metric lists (evaluate.py:120-159)."""
        self.task = task
        names = ["train", "val", "test"]
        if task == "oasis":
            from pulpo_tpu_torch.data.oasis import create_data_loaders

            loaders = create_data_loaders(1, segs=segs, lms=lms, mask=mask,
                                          ndims=ndims, path=path)
            names = ["train", "val", "test_seg", "test_lm"]
        elif task == "brats":
            from pulpo_tpu_torch.data.brats import create_data_loaders

            loaders = create_data_loaders(1, segs=segs, lms=lms, mask=mask,
                                          ndims=ndims, path=path)
        elif task == "lungct":
            from pulpo_tpu_torch.data.lungct import create_data_loaders

            loaders = create_data_loaders(1, segs=segs, lms=lms, mask=mask,
                                          ndims=ndims, path=path)
        elif task == "synthetic":
            from pulpo_tpu_torch.data.loader import DataLoader
            from pulpo_tpu_torch.data.synthetic import SyntheticDataset

            shape = self.model.cfg.input_size if self.model else (24, 28, 32)
            mk = lambda seed, n: DataLoader(
                SyntheticDataset(shape=shape, n=n, segs=segs, lms=lms, seed=seed),
                batch_size=1, shuffle=False, seed=seed)
            loaders = [mk(0, 4), mk(1, 2), mk(2, 2)]
        else:
            raise ValueError(f"Task {task} does not exist.")
        self.set_data(loaders, names, segs, lms, mask)

    def set_data(self, loaders, loader_names, segs, lms, mask):
        """Evaluate on the given loaders (what `load_data` builds for a task)."""
        self.loaders = list(loaders)
        self.loader_names = list(loader_names)
        self.segs, self.lms, self.mask = segs, lms, mask
        self.metric_names = ["RMSE", "JDetStd", "JDetLeq0"]
        if segs:
            self.metric_names += ["Dice"]
        if lms:
            self.metric_names += ["LM_MAE", "LM_Euclid"]
        self.num_datasets = len(self.loaders)
        self.num_metrics = len(self.metric_names)
        self.num_inputs = max(len(dl.dataset) for dl in self.loaders)

    def sample_data(self, loader_name: str, index: int = 0):
        """One batch from a named loader (evaluate.py:161-177)."""
        loader = self.loaders[self.loader_names.index(loader_name)]
        for i, batch in enumerate(loader):
            if i == index:
                batch["loader"] = loader_name
                return batch
        raise ValueError(f"Index {index} out of range for loader {loader_name}.")

    def _next_seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self.rng))

    def _tensor(self, a):
        return _as_tensor(a, self.device)

    # ------------------------------------------------------------------
    # Artifact injection (robustness / UQ experiments)
    # ------------------------------------------------------------------

    def _artifact_box(self, spatial):
        """The reference's fixed ROI x=(100,130) y=(100,130) z=(120,150)
        (evaluate.py:1188, 1255, 1333, 1421, 1500); for volumes too small
        to contain it, the JAX package's fractional box (0.45..0.65 of
        each axis, DIVERGENCES.md)."""
        fixed = [(100, 130), (100, 130), (120, 150)][: len(spatial)]
        if all(hi <= s for (_, hi), s in zip(fixed, spatial)):
            return tuple(fixed)
        return tuple((int(s * 0.45), int(s * 0.65)) for s in spatial)

    def _inject_artifact(self, x, method: str) -> torch.Tensor:
        """`x` with the artifact in its box: on the host (numpy, scipy),
        then back on the evaluator's device."""
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        box = self._artifact_box(tuple(x.shape[1:-1]))
        return self._tensor(artifact_fn(x, method, *box))

    # ------------------------------------------------------------------
    # Prediction (evaluate.py:179-280 schema)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def predict(self, batch, num_samples=20, deterministic=False, keep_samples="auto"):
        """(preds, all_preds) in the reference's tuple schema:

        preds = [y_pred, df_pred, seg_pred, outputs, individual_dfs,
                 combined_dfs, final_dfs, warped_seg, prediction_name]
        all_preds = [] for N == 1, else [output_std, individual_df_std,
                 final_df_std, all_outputs, all_individual_dfs,
                 all_combined_dfs, all_final_dfs, all_warped_seg]

        `keep_samples="auto"` keeps the N per-sample buffers when they fit
        in half the card's free memory (always on the CPU)."""
        model, cfg = self.model, self.model.cfg
        x, y = self._tensor(batch["x"]), self._tensor(batch["y"])
        if keep_samples == "auto":
            keep_samples = True
            if num_samples > 1 and model.device.type == "cuda":
                dtype_bytes = 2 if model.dtype == torch.bfloat16 else 4
                keep_samples = (retention_bytes(cfg, num_samples, x.shape[0], dtype_bytes)
                                <= 0.5 * device_budget(model.device))
        seg_x = batch.get("seg_x")
        if deterministic and num_samples != 1:
            raise ValueError("Deterministic predictions with more than 1 sample make no sense!")
        empty = {0: torch.empty((0,))}

        def warp_seg(final_dfs):
            if self.segs and seg_x is not None:
                seg = self._tensor(seg_x)
                return {l: warp_image(seg, final_dfs[l]) for l in final_dfs}
            return empty

        if num_samples == 1:
            if deterministic:
                outputs, individual_dfs = model.predict_deterministic(x, y)
                name = "deterministic_prediction"
            else:
                outputs, individual_dfs = model.predict(x, y, 1, seed=self._next_seed())
                name = "sample_prediction"
            combined_dfs, final_dfs = combine_dfs(cfg, individual_dfs)
            warped_seg = warp_seg(final_dfs)
            return ([outputs[0], final_dfs[0], warped_seg[0], outputs, individual_dfs,
                     combined_dfs, final_dfs, warped_seg, name], [])

        name = f"avg_prediction_over_{num_samples}_samples"
        mask = (self._tensor(batch["mask_x"])
                if self.mask and batch.get("mask_x") is not None else None)
        res = predict_with_uncertainty(model, x, y, num_samples, seed=self._next_seed(),
                                       mask=mask, keep_samples=keep_samples)
        combined_dfs, final_dfs = combine_dfs(cfg, res.avg_dfs)
        warped_seg = warp_seg(final_dfs)
        preds = [res.mean_outputs[0], final_dfs[0], warped_seg[0], res.mean_outputs,
                 res.avg_dfs, combined_dfs, final_dfs, warped_seg, name]
        # sample-first with B squeezed, the reference's (N, ...) layout;
        # per-sample warped segs only on the 2D path (evaluate.py:209-211, 271)
        squeeze_b = lambda d: None if d is None else {l: v[:, 0] for l, v in d.items()}
        if keep_samples:
            all_outputs = squeeze_b(res.sample_outputs)
            all_individual = squeeze_b(res.sample_individual_dfs)
            all_combined = squeeze_b(res.sample_combined_dfs)
            all_final = squeeze_b(res.sample_final_dfs)
            if self.segs and seg_x is not None and x.ndim == 4:
                seg_rep = self._tensor(seg_x).repeat_interleave(num_samples, dim=0)
                all_warped_seg = {l: warp_image(seg_rep, res.sample_final_dfs[l][:, 0])
                                  for l in all_final}
            else:
                all_warped_seg = empty
        else:
            # first-chunk-only sample outputs (figure sample grids)
            all_outputs = {l: v.transpose(0, 1)[:, 0] for l, v in res.outputs.items()}
            all_individual = all_combined = all_final = None
            all_warped_seg = empty
        all_preds = [res.output_std, res.individual_df_std, res.final_df_std,
                     all_outputs, all_individual, all_combined, all_final, all_warped_seg]
        return preds, all_preds

    # ------------------------------------------------------------------
    # Performance table (evaluate.py:1379-1498)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def performance(self, artifact: str = "", save: bool = True) -> Table:
        model, cfg = self.model, self.model.cfg
        K = self.latent_levels
        all_metrics = np.full([self.num_metrics, K, self.num_datasets, self.num_inputs], np.nan)
        unit_w = {l: 1.0 for l in range(K)}
        unit_win = {l: 1 for l in range(K)}

        for k, loader in enumerate(self.loaders):
            for j, batch in enumerate(loader):
                x, y = self._tensor(batch["x"]), self._tensor(batch["y"])
                if artifact:
                    x = self._inject_artifact(x, artifact)
                outputs, individual_dfs = model.predict_deterministic(x, y)
                _, final_dfs = combine_dfs(cfg, individual_dfs)
                seg_x, seg_y = batch.get("seg_x"), batch.get("seg_y")
                num_pixels = {l: float(np.prod(outputs[l].shape[1:-1])) for l in range(K)}
                col = 0
                # RMSE: unit-weight hierarchical MSE over the voxels, sqrt
                _, level_mse = L.hierarchical_reconstruction_loss(
                    outputs, y, unit_w, ("mse",), unit_win)
                for l in range(K):
                    all_metrics[col, l, k, j] = float(torch.sqrt(level_mse[l] / num_pixels[l]))
                col += 1
                # JDetStd of the final dfs
                _, level_jdet = L.hierarchical_regularization(
                    final_dfs, unit_w, regularizer="jdet", lamb=1.0)
                for l in range(K):
                    all_metrics[col, l, k, j] = float(level_jdet[l])
                col += 1
                # JDetLeq0 %
                for l in range(K):
                    jd = L.jacobian_det(final_dfs[l]).cpu().numpy()
                    all_metrics[col, l, k, j] = M.jdet_leq0_percent(jd)
                col += 1
                if "Dice" in self.metric_names:
                    if seg_x is not None:
                        seg = self._tensor(seg_x)
                        pred_segs = {l: warp_image(seg, final_dfs[l]) for l in final_dfs}
                        _, level_dice = L.hierarchical_reconstruction_loss(
                            outputs, y, unit_w, ("dice",), unit_win, dice_factor=1.0,
                            y_hat_seg=pred_segs, seg_y=self._tensor(seg_y))
                        for l in range(K):
                            all_metrics[col, l, k, j] = 1.0 - float(level_dice[l] / num_pixels[l])
                    col += 1
                if "LM_MAE" in self.metric_names:
                    lm_x, lm_y = batch.get("lm_x"), batch.get("lm_y")
                    if _has(lm_x) and _has(lm_y):
                        warped = warp_landmarks(self._tensor(lm_x), final_dfs[0]).cpu().numpy()
                        all_metrics[col, 0, k, j] = M.lm_mae(warped, lm_y)
                        all_metrics[col + 1, 0, k, j] = M.lm_euclid(warped, lm_y)
                    col += 2

        mean_metrics = _nanmean(all_metrics)  # (metrics, K, datasets)
        data = np.concatenate(mean_metrics.T, axis=1)
        table = Table.from_sets(data, self.loader_names, self.metric_names).round(3)
        if save:
            make_tables(table, self.output_dir / "loss",
                        name="loss_table_deterministic" + artifact)
        return table

    # ------------------------------------------------------------------
    # Uncertainty table (evaluate.py:1500-1576)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def uncertainty(self, num_samples: int, artifact: str = "", save: bool = True) -> Table:
        if num_samples < 2:
            raise ValueError("N has to be at least 2")
        model = self.model
        metric_names = ["Var", "NCC"]
        if self.lms:
            metric_names += ["LM_VAR", "LM_NCC"]
        all_metrics = np.full([len(metric_names), self.num_datasets, self.num_inputs], np.nan)

        for k, loader in enumerate(self.loaders):
            for j, batch in enumerate(loader):
                x, y = self._tensor(batch["x"]), self._tensor(batch["y"])
                if artifact:
                    x = self._inject_artifact(x, artifact)
                lm_x, lm_y = batch.get("lm_x"), batch.get("lm_y")
                has_lms = self.lms and _has(lm_x) and _has(lm_y)
                res = predict_with_uncertainty(
                    model, x, y, num_samples, seed=self._next_seed(),
                    lm=self._tensor(lm_x) if has_lms else None)
                var = res.output_std[0][0].cpu().numpy() ** 2
                mse = res.output_mse[0][0].cpu().numpy()
                all_metrics[0, k, j] = var.mean()
                all_metrics[1, k, j] = M.global_ncc(var, mse)
                if has_lms:
                    lm_hat = warp_landmarks(self._tensor(lm_x), res.final_dfs[0]).cpu().numpy()
                    warped_lms = res.sample_landmarks[:, 0].cpu().numpy()
                    all_metrics[2, k, j] = M.lms_var(warped_lms).mean()
                    all_metrics[3, k, j] = M.lms_corr(lm_hat[0], warped_lms, np.asarray(lm_y)[0])

        mean_metrics = _nanmean(all_metrics)  # (metrics, datasets)
        table = Table.from_sets(np.concatenate(mean_metrics.T)[None, :],
                                self.loader_names, metric_names)
        if save:
            make_tables(table, self.output_dir / "uncertainty", name="loss_table" + artifact)
        return table

    # ------------------------------------------------------------------
    # Affine (identity) baseline (evaluate.py:1146-1221)
    # ------------------------------------------------------------------

    def performance_affine(self, artifact: str = "", save: bool = True) -> Table:
        """The no-op registration baseline: prediction = moving image (the
        datasets are affinely pre-aligned), with the artifact hook of
        evaluate.py:1187-1188."""
        all_metrics = np.full([self.num_metrics, self.num_datasets, self.num_inputs], np.nan)
        for k, loader in enumerate(self.loaders):
            for j, batch in enumerate(loader):
                x, y = np.asarray(batch["x"]), np.asarray(batch["y"])
                if artifact:
                    x = self._inject_artifact(x, artifact).cpu().numpy()
                all_metrics[0, k, j] = M.rmse(x, y)
                seg_x, seg_y = batch.get("seg_x"), batch.get("seg_y")
                if "Dice" in self.metric_names and seg_x is not None:
                    all_metrics[self.metric_names.index("Dice"), k, j] = M.dsc(seg_x, seg_y)
                lm_x, lm_y = batch.get("lm_x"), batch.get("lm_y")
                if "LM_MAE" in self.metric_names and _has(lm_x):
                    all_metrics[self.metric_names.index("LM_MAE"), k, j] = M.lm_mae(lm_x, lm_y)
                    all_metrics[self.metric_names.index("LM_Euclid"), k, j] = M.lm_euclid(
                        lm_x, lm_y)
        mean_metrics = _nanmean(all_metrics)  # (metrics, datasets)
        table = Table.from_sets(mean_metrics.T.reshape(1, -1), self.loader_names,
                                self.metric_names)
        if save:
            make_tables(table, self.output_dir / "loss", name="loss_table_affine" + artifact)
        return table

    # ------------------------------------------------------------------
    # Full pipeline (evaluate.py:1579-1719)
    # ------------------------------------------------------------------

    def run_one_model(self, run_dir=None, segs=False, lms=False, mask=False,
                      N=10, task="oasis", data_path=None, visualize=True):
        """Figures (with `visualize`), then the performance and (N > 1)
        uncertainty tables. For each loader's first pair, three
        predictions (deterministic, one sample, the mean over N) each
        write their figure's panels (`vis/allvis<loader>_<pred>.npz`, and
        the `.png` where matplotlib is installed) and their JDet table
        (`jdet/jdet_<loader>_<pred>`)."""
        if run_dir is not None:
            self.load_model(run_dir)
        self.load_data(task=task, segs=segs, lms=lms, mask=mask,
                       ndims=self.model.cfg.ndims, path=data_path)
        for sub in ("jdet", "loss", "uncertainty", "vis"):
            (self.output_dir / sub).mkdir(parents=True, exist_ok=True)
        if visualize:
            self.write_figures(N)
        perf = self.performance()
        unc = self.uncertainty(num_samples=N) if N > 1 else None
        return perf, unc

    def write_figures(self, N: int) -> None:
        """The figures of `run_one_model` (evaluator.py:495-516 of the JAX
        package)."""
        from pulpo_tpu_torch.eval.visualize import draw, prediction_panels, save_panels

        png = importlib.util.find_spec("matplotlib") is not None
        for lname in self.loader_names:
            batch = self.sample_data(loader_name=lname)
            for pname, (ns, det) in {"deterministic": (1, True), "sample": (1, False),
                                     f"avg_{N}": (N, False)}.items():
                preds, all_preds = self.predict(batch, num_samples=ns, deterministic=det)
                p = prediction_panels(
                    batch, preds, all_preds, latent_levels=self.latent_levels,
                    title=f"All visualizations on {lname} set with {pname} prediction")
                path = self.output_dir / "vis" / f"allvis{lname}_{pname}"
                save_panels(p, path.with_suffix(".npz"))
                if png:
                    draw(p, save_path=path.with_suffix(".png"))
                table_jdet(preds[6], preds[4], output_dir=self.output_dir / "jdet",
                           name=f"{lname}_{pname}", save=True)

    # ------------------------------------------------------------------
    # DIF-VoxelMorph baseline (evaluate.py:113-118, 282-309, 1224-1377)
    # ------------------------------------------------------------------

    def load_vxm(self, state_dict, input_size, output_dir="evaluation_vxm"):
        """Attach the DIF-VM baseline (`models/voxelmorph.VxmModel`) with
        the weights `state_dict`, on the evaluator's device."""
        from pulpo_tpu_torch.models.voxelmorph import VxmModel

        self.vxm = VxmModel(input_size, device=self.device)
        self.vxm.load_state_dict(state_dict)
        self.output_dir = pathlib.Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        return self.vxm

    def _vxm_table(self, all_metrics, names) -> Table:
        mean = _nanmean(all_metrics)  # (metrics, datasets)
        return Table.from_sets(mean.T.reshape(1, -1), self.loader_names, names)

    @torch.inference_mode()
    def performance_vxm(self, num_samples: int = 1, artifact: str = "",
                        save: bool = True) -> Table:
        """Deterministic (or N-sample-mean) metrics of the baseline: RMSE,
        JDetStd, JDetLeq0 (and the landmark metrics) at full resolution
        (evaluate.py:1224-1304, with the artifact hook of :1254-1255)."""
        names = ["RMSE", "JDetStd", "JDetLeq0"] + (["LM_MAE", "LM_Euclid"] if self.lms else [])
        all_metrics = np.full([len(names), self.num_datasets, self.num_inputs], np.nan)
        for k, loader in enumerate(self.loaders):
            for j, batch in enumerate(loader):
                x, y = self._tensor(batch["x"]), self._tensor(batch["y"])
                if artifact:
                    x = self._inject_artifact(x, artifact)
                if num_samples == 1:
                    moved, df, _ = self.vxm.apply(x, y, deterministic=True)
                else:
                    moved, df, *_ = self.vxm.predict(x, y, num_samples, seed=self._next_seed())
                all_metrics[0, k, j] = M.rmse(moved.cpu().numpy(), y.cpu().numpy())
                all_metrics[1, k, j] = float(L.jdet_std(df, lamb=1.0))
                all_metrics[2, k, j] = M.jdet_leq0_percent(L.jacobian_det(df).cpu().numpy())
                lm_x, lm_y = batch.get("lm_x"), batch.get("lm_y")
                if self.lms and _has(lm_x) and _has(lm_y):
                    warped = warp_landmarks(self._tensor(lm_x), df).cpu().numpy()
                    all_metrics[3, k, j] = M.lm_mae(warped, lm_y)
                    all_metrics[4, k, j] = M.lm_euclid(warped, lm_y)
        table = self._vxm_table(all_metrics, names).round(3)
        if save:
            make_tables(table, self.output_dir / "loss", name="loss_table_vxm" + artifact)
        return table

    @torch.inference_mode()
    def uncertainty_vxm(self, num_samples: int, artifact: str = "", save: bool = True) -> Table:
        """Var and NCC(var, mse) calibration (and LM_VAR / LM_NCC) of the
        baseline (evaluate.py:1300-1377, with the artifact hook of
        :1332-1333 and the landmark metrics of :1347-1354)."""
        if num_samples < 2:
            raise ValueError("N has to be at least 2")
        names = ["Var", "NCC"] + (["LM_VAR", "LM_NCC"] if self.lms else [])
        all_metrics = np.full([len(names), self.num_datasets, self.num_inputs], np.nan)
        for k, loader in enumerate(self.loaders):
            for j, batch in enumerate(loader):
                x, y = self._tensor(batch["x"]), self._tensor(batch["y"])
                if artifact:
                    x = self._inject_artifact(x, artifact)
                _avg, avg_df, moved_std, _dstd, all_moved, all_dfs = self.vxm.predict(
                    x, y, num_samples, seed=self._next_seed())
                mse = torch.mean((all_moved - y) ** 2, dim=0)[0, ..., 0].cpu().numpy()
                var = moved_std[0].cpu().numpy() ** 2
                all_metrics[0, k, j] = var.mean()
                all_metrics[1, k, j] = M.global_ncc(var, mse)
                lm_x, lm_y = batch.get("lm_x"), batch.get("lm_y")
                if self.lms and _has(lm_x) and _has(lm_y):
                    lm = self._tensor(lm_x)
                    lm_hat = warp_landmarks(lm, avg_df).cpu().numpy()
                    warped_lms = warp_landmarks(lm.repeat_interleave(num_samples, dim=0),
                                                all_dfs[:, 0]).cpu().numpy()
                    all_metrics[2, k, j] = M.lms_var(warped_lms).mean()
                    all_metrics[3, k, j] = M.lms_corr(lm_hat[0], warped_lms, np.asarray(lm_y)[0])
        table = self._vxm_table(all_metrics, names)
        if save:
            make_tables(table, self.output_dir / "uncertainty", name="loss_table_vxm" + artifact)
        return table

    # ------------------------------------------------------------------
    # Multi-model table (evaluate.py:1721-1801)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def compare_models(self, run_dirs, model_names=None, task="oasis", segs=False, lms=False,
                       N=10, data_path=None, output_dir="experiments/compare") -> Table:
        """One row per model: each run's N-sample mean-SVF prediction
        (`PULPoModel.predict`) over every loader, RMSE, JDetStd, JDetLeq0
        and Dice of the level-0 outputs; written as
        `<output_dir>/loss_table.{csv,tex}`. The data of the first run's
        config serves every run. As in the JAX package, no zero-scrub and
        no landmark columns (they stay NaN)."""
        model_names = model_names or [str(r) for r in run_dirs]
        rows = []
        for i, rd in enumerate(run_dirs):
            self.load_model(rd)
            if i == 0:
                self.load_data(task=task, segs=segs, lms=lms, mask=False,
                               ndims=self.model.cfg.ndims, path=data_path)
            all_metrics = np.full([self.num_metrics, self.num_datasets, self.num_inputs], np.nan)
            for k, loader in enumerate(self.loaders):
                for j, batch in enumerate(loader):
                    x, y = self._tensor(batch["x"]), self._tensor(batch["y"])
                    outputs, dfs = self.model.predict(x, y, N, seed=self._next_seed())
                    _, final_dfs = combine_dfs(self.model.cfg, dfs)
                    y_pred, df_pred = outputs[0], final_dfs[0]
                    num_pixels = float(np.prod(y_pred.shape[1:-1]))
                    all_metrics[0, k, j] = float(torch.sqrt(L.l2_loss(y_pred, y) / num_pixels))
                    all_metrics[1, k, j] = float(L.jdet_std(df_pred, lamb=1.0))
                    all_metrics[2, k, j] = M.jdet_leq0_percent(
                        L.jacobian_det(df_pred).cpu().numpy())
                    seg_x, seg_y = batch.get("seg_x"), batch.get("seg_y")
                    if "Dice" in self.metric_names and seg_x is not None:
                        pred_seg = warp_image(self._tensor(seg_x), final_dfs[0])
                        all_metrics[self.metric_names.index("Dice"), k, j] = 1 - float(
                            L.soft_dice_loss(pred_seg, self._tensor(seg_y)) / num_pixels)
            with warnings.catch_warnings():  # an all-NaN column stays NaN
                warnings.simplefilter("ignore", RuntimeWarning)
                rows.append(np.nanmean(all_metrics, axis=-1))
        table = multiindex_table(np.stack(rows, axis=1), self.loader_names,
                                 self.metric_names, index=model_names)
        make_tables(table, output_dir, name="loss_table")
        return table
