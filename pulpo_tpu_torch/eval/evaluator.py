"""The evaluation suite: deterministic performance tables and N-sample
uncertainty tables (the reference's evaluate.py, class Evaluate).

Port of pulpo_tpu/eval/evaluator.py:48-520: `load_model` (the port's
checkpoints), `set_model`, `load_data`, `predict`, `performance`,
`uncertainty`, `performance_affine` and `run_one_model`. Output layout
as the reference: <run_dir>/evaluation/{loss, uncertainty}/...

Tables are `eval.tables.Table`s (no pandas on the card's machine). The
reference's conventions are kept: exact-zero entries are scrubbed to
NaN before the mean over inputs (its "empty slot" sentinel), and the
landmarks thread through `predict_with_uncertainty(lm=...)` so that the
per-sample landmark warps use the same draws as the Var/NCC maps.

Tasks: oasis (loaders train / val / test_seg / test_lm), brats and
lungct (train / val / test), synthetic. Not ported yet: the figures
(`visualize=True`, which needs `eval/visualize`), the artifact
experiments (`eval/artifact`), the VoxelMorph baseline
(`models/voxelmorph`) and `compare_models`.
"""

from __future__ import annotations

import pathlib
import warnings

import numpy as np
import torch

from pulpo_tpu_torch.eval import metrics as M
from pulpo_tpu_torch.eval.tables import Table, make_tables
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
        return _as_tensor(a, self.model.device)

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
    def performance(self, save: bool = True) -> Table:
        model, cfg = self.model, self.model.cfg
        K = self.latent_levels
        all_metrics = np.full([self.num_metrics, K, self.num_datasets, self.num_inputs], np.nan)
        unit_w = {l: 1.0 for l in range(K)}
        unit_win = {l: 1 for l in range(K)}

        for k, loader in enumerate(self.loaders):
            for j, batch in enumerate(loader):
                x, y = self._tensor(batch["x"]), self._tensor(batch["y"])
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
            make_tables(table, self.output_dir / "loss", name="loss_table_deterministic")
        return table

    # ------------------------------------------------------------------
    # Uncertainty table (evaluate.py:1500-1576)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def uncertainty(self, num_samples: int, save: bool = True) -> Table:
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
            make_tables(table, self.output_dir / "uncertainty", name="loss_table")
        return table

    # ------------------------------------------------------------------
    # Affine (identity) baseline (evaluate.py:1146-1221)
    # ------------------------------------------------------------------

    def performance_affine(self, save: bool = True) -> Table:
        """The no-op registration baseline: prediction = moving image (the
        datasets are affinely pre-aligned)."""
        all_metrics = np.full([self.num_metrics, self.num_datasets, self.num_inputs], np.nan)
        for k, loader in enumerate(self.loaders):
            for j, batch in enumerate(loader):
                x, y = np.asarray(batch["x"]), np.asarray(batch["y"])
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
            make_tables(table, self.output_dir / "loss", name="loss_table_affine")
        return table

    # ------------------------------------------------------------------
    # Full pipeline (evaluate.py:1579-1719)
    # ------------------------------------------------------------------

    def run_one_model(self, run_dir=None, segs=False, lms=False, mask=False,
                      N=10, task="oasis", data_path=None, visualize=True):
        if visualize:
            raise NotImplementedError(
                "the figures need eval/visualize, which is not ported yet; "
                "pass visualize=False (--no_visualize)")
        if run_dir is not None:
            self.load_model(run_dir)
        self.load_data(task=task, segs=segs, lms=lms, mask=mask,
                       ndims=self.model.cfg.ndims, path=data_path)
        for sub in ("loss", "uncertainty"):
            (self.output_dir / sub).mkdir(parents=True, exist_ok=True)
        perf = self.performance()
        unc = self.uncertainty(num_samples=N) if N > 1 else None
        return perf, unc
