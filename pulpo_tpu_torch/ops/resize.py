"""Separable linear resampling and ceil-mode average pooling.

Port of pulpo_tpu/ops/resize.py:68-111. Each spatial axis is resampled
by a dense (out, in) matrix built with numpy, as the JAX package does,
so both packages use bit-identical matrices:

- linear resize == ``F.interpolate(mode='trilinear', align_corners=False)``:
  ``src = (dst + 0.5) / scale - 0.5`` clamped to ``>= 0``, upper
  neighbour clamped to ``in - 1``;
- average pooling == ``AvgPool(kernel_size=2, stride=2, ceil_mode=True)``:
  the last, clipped window divides by its actual element count.

Layout: channels-last, spatial axes default to all but the first and last.

Under spatial sharding (parallel/spatial.py) a call over the default
axes runs on this rank's slab (`spatial.resize`, `spatial.avg_pool`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pulpo_tpu_torch.parallel import spatial


@functools.lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, scale: float | None) -> np.ndarray:
    """(out, in) linear interpolation matrix, align_corners=False."""
    if in_size == out_size and scale in (None, 1.0):
        return np.eye(in_size, dtype=np.float32)
    if scale is None:
        scale = out_size / in_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.maximum((dst + 0.5) / scale - 0.5, 0.0)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0).astype(np.float32)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    np.add.at(m, (np.arange(out_size), i0), 1.0 - w)
    np.add.at(m, (np.arange(out_size), i1), w)
    return m


@functools.lru_cache(maxsize=None)
def _avgpool_matrix(in_size: int) -> np.ndarray:
    """(ceil(in/2), in) matrix for k=2 s=2 ceil-mode average pooling."""
    out_size = -(-in_size // 2)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for j in range(out_size):
        lo = 2 * j
        hi = min(lo + 2, in_size)
        m[j, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=256)
def _device_matrix(key: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The transposed matrix of `key` on `device`, built once: a copy from
    the host per call would synchronise the host with the card."""
    kind, *args = key
    m = _linear_matrix(*args) if kind == "linear" else _avgpool_matrix(*args)
    # a normal tensor even when first built under inference_mode (the UQ
    # path): autograd refuses to save an inference tensor for backward
    with torch.inference_mode(False):
        return torch.as_tensor(m.T.copy()).to(device=device, dtype=dtype)


def _apply_axis_matrix(x: torch.Tensor, key: tuple, axis: int) -> torch.Tensor:
    """Contract axis `axis` of x with the (out, in) matrix named by `key`,
    in x's dtype (as the JAX package casts its matrices)."""
    mt = _device_matrix(key, x.device, x.dtype)
    return torch.matmul(x.movedim(axis, -1), mt).movedim(-1, axis)


def resize_linear(
    x: torch.Tensor,
    out_size: tuple[int, ...],
    spatial_axes: tuple[int, ...] | None = None,
    scales: tuple[float, ...] | None = None,
) -> torch.Tensor:
    """Multi-axis linear resize matching F.interpolate(align_corners=False).

    `scales`: optional explicit scale factors for the coordinate mapping
    (as when torch is called with scale_factor); None means out/in per axis.
    """
    if spatial_axes is None:
        if spatial.active():
            return spatial.resize(x, out_size, scales)
        spatial_axes = tuple(range(1, x.ndim - 1))
    assert len(out_size) == len(spatial_axes)
    for i, ax in enumerate(spatial_axes):
        scale = None if scales is None else scales[i]
        if x.shape[ax] == out_size[i] and scale in (None, 1.0):
            continue
        key = ("linear", x.shape[ax], int(out_size[i]), scale)
        x = _apply_axis_matrix(x, key, ax)
    return x


def avg_pool_ceil(x: torch.Tensor, spatial_axes: tuple[int, ...] | None = None) -> torch.Tensor:
    """k=2 s=2 ceil-mode average pooling over the spatial axes."""
    if spatial_axes is None:
        if spatial.active():
            return spatial.avg_pool(x)
        spatial_axes = tuple(range(1, x.ndim - 1))
    for ax in spatial_axes:
        x = _apply_axis_matrix(x, ("avgpool", x.shape[ax]), ax)
    return x


def avg_pool_pyramid(x: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """[x, pool(x), pool(pool(x)), ...]: `num_levels` entries of
    `avg_pool_ceil` (pulpo_tpu/ops/resize.py:106)."""
    out = [x]
    for _ in range(num_levels - 1):
        out.append(avg_pool_ceil(out[-1]))
    return out
