"""Synthetic corruption injector for robustness / UQ experiments.

The port's own copy of pulpo_tpu/eval/artifact.py, bit-equal to it. The
injection runs on the host, in numpy and scipy, as the JAX package's
does: `Evaluate` copies the moving image to the host, corrupts the box
and sends it back to the device before the prediction.

Reference: Evaluate.artifact (evaluate.py:608-677). Operates on
channels-last arrays (B, *spatial, C); the box ROI is given per spatial
axis. Methods: blur, noise, mean, white, black, checkerboard.
"""

from __future__ import annotations

import numpy as np


def _gaussian_blur(roi: np.ndarray, sigma: float = 5.0, kernel_size: int = 11):
    from scipy.ndimage import gaussian_filter

    out = np.empty_like(roi)
    for b in range(roi.shape[0]):
        for c in range(roi.shape[-1]):
            out[b, ..., c] = gaussian_filter(
                roi[b, ..., c], sigma=sigma, truncate=(kernel_size // 2) / sigma
            )
    return out


def artifact(
    image: np.ndarray,
    method: str,
    x: tuple[int, int],
    y: tuple[int, int],
    z: tuple[int, int] | None = None,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Insert an artificial artifact into a box region of an image."""
    image = np.asarray(image)
    ndims = image.ndim - 2
    if ndims == 2 and z is not None:
        raise ValueError("z must be None for 2D images")
    if ndims == 3 and z is None:
        raise ValueError("z must be specified for 3D images")
    rng = rng or np.random.default_rng(0)

    if z is None:
        region = (slice(None), slice(x[0], x[1]), slice(y[0], y[1]))
    else:
        region = (
            slice(None),
            slice(x[0], x[1]),
            slice(y[0], y[1]),
            slice(z[0], z[1]),
        )
    res = image.copy()
    roi = res[region + (slice(None),)]

    if method == "blur":
        roi = _gaussian_blur(roi)
    elif method == "noise":
        roi = rng.normal(roi.mean(), roi.std(), size=roi.shape).astype(image.dtype)
    elif method == "mean":
        roi = np.full_like(roi, roi.mean())
    elif method == "white":
        roi = np.ones_like(roi)
    elif method == "black":
        roi = np.zeros_like(roi)
    elif method == "checkerboard":
        dists = [x[1] - x[0], y[1] - y[0]] + ([z[1] - z[0]] if z else [])
        steps = [max(1, int(d / 10)) for d in dists]
        offs = [0] * len(dists)
        color = 1.0
        roi = roi.copy()
        roi[:] = color
        while offs[0] < dists[0] / 2:
            inner = tuple(
                slice(o, -o) if o > 0 else slice(None) for o in offs
            )
            roi[(slice(None),) + inner + (slice(None),)] = color
            offs = [o + s for o, s in zip(offs, steps)]
            color = 1.0 - color
    else:
        raise ValueError(f"Method {method!r} not recognized")

    res[region + (slice(None),)] = roi
    return res
