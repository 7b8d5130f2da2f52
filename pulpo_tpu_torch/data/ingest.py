"""Ingest on the device: normalise and resample a raw volume batch.

Port of pulpo_tpu/data/ingest.py:24-87. The converters (data/convert.py)
normalise offline on the host; these functions do the same on the
caller's device, as PyTorch operations: a raw batch is copied to the
card once and normalised and resampled there. Each function works on
the tensor's own device; `ingest` moves a numpy array to `cuda` unless
the caller names another device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pulpo_tpu_torch.ops.resize import resize_linear


def znorm_clip_minmax(img: torch.Tensor, clip: float = 6.0) -> torch.Tensor:
    """z-normalise, clip to +-clip, min-max to [0, 1]: the BraTS
    converter's normalisation (data/convert.py:_brats_normalize), in
    float32.

    img: (*spatial,) or (B, *spatial[, C]); the statistics are per
    leading batch element when there is a batch axis (ndim >= 4), over
    the whole array otherwise. The deviation is the population one, as
    numpy's and jax.numpy's `std` (not torch's default unbiased one)."""
    img = img.float()
    dims = tuple(range(1, img.ndim)) if img.ndim >= 4 else tuple(range(img.ndim))
    m = img.mean(dim=dims, keepdim=True)
    s = img.std(dim=dims, keepdim=True, correction=0) + 1e-8
    img = torch.clamp((img - m) / s, -clip, clip)
    lo = img.amin(dim=dims, keepdim=True)
    hi = img.amax(dim=dims, keepdim=True)
    return (img - lo) / torch.clamp_min(hi - lo, 1e-8)


def minmax(img: torch.Tensor, max_val: float | None = None) -> torch.Tensor:
    """Min-max normalisation over the whole array; `max_val` fixes the
    divisor instead (the OASIS test_lm convention, data/convert.py)."""
    img = img.float()
    if max_val is not None:
        return img / max_val
    lo, hi = img.min(), img.max()
    return (img - lo) / torch.clamp_min(hi - lo, 1e-8)


def resample_volume(img: torch.Tensor, target: tuple[int, ...]) -> torch.Tensor:
    """Linear (align_corners=False) resample of (B, *spatial, C) to the
    spatial shape `target` (ops/resize.py:resize_linear)."""
    return resize_linear(img.float(), tuple(target))


@functools.lru_cache(maxsize=None)
def make_ingest(target: tuple[int, ...] | None = None,
                normalize: str = "znorm", clip: float = 6.0):
    """The ingest pipeline for a raw batch (B, *spatial, C): resample to
    `target` if given, then `normalize` in {"znorm", "minmax", "none"}.
    One function per (target, normalize, clip)."""
    if normalize not in ("znorm", "minmax", "none"):
        raise ValueError(f"normalize={normalize!r}: expected znorm, minmax or none")

    def pipeline(img: torch.Tensor) -> torch.Tensor:
        img = img.float()
        if target is not None:
            img = resample_volume(img, target)
        if normalize == "znorm":
            img = znorm_clip_minmax(img, clip=clip)
        elif normalize == "minmax":
            img = minmax(img)
        return img

    return pipeline


def ingest(img, target: tuple[int, ...] | None = None, normalize: str = "znorm",
           clip: float = 6.0, device=None) -> torch.Tensor:
    """One call of `make_ingest`'s pipeline. A tensor is processed on its
    own device (or moved to `device`); a numpy array is moved to `device`,
    `cuda` by default."""
    if isinstance(img, torch.Tensor):
        t = img if device is None else img.to(device)
    else:
        t = torch.from_numpy(np.ascontiguousarray(img)).to("cuda" if device is None else device)
    return make_ingest(None if target is None else tuple(int(s) for s in target),
                       normalize, float(clip))(t)
