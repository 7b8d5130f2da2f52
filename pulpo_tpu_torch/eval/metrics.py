"""Evaluation metric helpers (reference: evaluate.py:315-423).

The port's own numpy copy of pulpo_tpu/eval/metrics.py: the scalar
metrics of the tables, on the host. The per-level computations
(hierarchical RMSE, JDet, Dice) run on the device in evaluator.py. The
reference's conventions are kept: `lm_mae` takes the LOWER middle
element as its median (torch.median), and `lms_var` / `lms_corr` are
Bessel-corrected (ddof=1, as torch.var and torch.std).
"""

from __future__ import annotations

import numpy as np


def rmse(pred: np.ndarray, target: np.ndarray) -> float:
    """Global RMSE (evaluate.py:315-319)."""
    return float(np.sqrt(np.mean((np.asarray(pred) - np.asarray(target)) ** 2)))


def dsc(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean-based dice coefficient over (B, *spatial, C)
    (evaluate.py:321-327; the reference uses per-(B,C) means over
    spatial dims and averages)."""
    pred, target = np.asarray(pred), np.asarray(target)
    axes = tuple(range(1, pred.ndim - 1))
    eps = 1e-6
    d = (2.0 * (target * pred).mean(axis=axes) + eps) / (
        (target**2).mean(axis=axes) + (pred**2).mean(axis=axes) + eps
    )
    return float(d.mean())


def global_ncc(a: np.ndarray, v: np.ndarray, zero_norm: bool = True) -> float:
    """The uncertainty-calibration correlation metric: normalized
    cross-correlation of two flattened maps (evaluate.py:334-353)."""
    a = np.asarray(a, dtype=np.float64).flatten()
    v = np.asarray(v, dtype=np.float64).flatten()
    eps = 1e-15
    if zero_norm:
        a = (a - np.mean(a)) / (np.std(a) * len(a) + eps)
        v = (v - np.mean(v)) / (np.std(v) + eps)
    else:
        a = a / (np.std(a) * len(a) + eps)
        v = v / (np.std(v) + eps)
    return float(np.correlate(a, v)[0])


def lm_mae(lm1: np.ndarray, lm2: np.ndarray) -> float:
    """Median manhattan distance between landmark sets (1, N, nd)
    (evaluate.py:355-366). The reference uses ``torch.median``, which
    for an even element count returns the LOWER middle element (not the
    numpy average of the two) — replicated here via a sorted index."""
    distance = np.abs(np.asarray(lm1) - np.asarray(lm2)).sum(axis=2)
    flat = np.sort(distance.reshape(-1))
    return float(flat[(flat.size - 1) // 2])


def lm_euclid(lm1: np.ndarray, lm2: np.ndarray) -> float:
    """Mean euclidean distance (TRE) between landmark sets
    (evaluate.py:368-379)."""
    distance = np.sqrt(((np.asarray(lm1) - np.asarray(lm2)) ** 2).sum(axis=2))
    return float(np.mean(distance))


def lms_var(lms: np.ndarray) -> np.ndarray:
    """Per-landmark variance over samples, averaged over coords:
    (S, N, nd) -> (N,) (evaluate.py:381-390; torch.var is
    Bessel-corrected)."""
    return np.mean(np.var(np.asarray(lms), axis=0, ddof=1), axis=-1)


def lms_corr(lm_hat: np.ndarray, lms: np.ndarray, lm: np.ndarray) -> float:
    """NCC between landmark squared error and landmark variance
    (evaluate.py:392-408). torch.std is Bessel-corrected -> ddof=1."""
    lm_hat, lm = np.asarray(lm_hat), np.asarray(lm)
    error = np.mean((lm_hat - lm) ** 2, axis=-1).flatten()
    variance = lms_var(lms).flatten()
    error_n = (error - error.mean()) / (error.std(ddof=1) * len(error))
    var_n = (variance - variance.mean()) / variance.std(ddof=1)
    return float(np.correlate(error_n, var_n)[0])


def jdet_leq0_percent(jdet: np.ndarray) -> float:
    """% of voxels with Jacobian determinant <= 0 (evaluate.py:1443-1449)."""
    jdet = np.asarray(jdet)
    return float(np.sum(jdet <= 0) / jdet.size * 100.0)
