"""Optical-flow colorization (Baker et al. color wheel) and the image
grids of the validation panels.

The port's own numpy copy of pulpo_tpu/eval/flow_viz.py, bit-equal to
it on the same arrays. `flow_to_image` is equivalent to
torchvision.utils.flow_to_image, which the reference uses for its
TensorBoard DF panels (models.py:294-308) and evaluation figures
(evaluate.py: flow visualizations). Input: (B, H, W, 2) flow
(channels-last), output uint8 RGB (B, H, W, 3).
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    """55-color wheel: RY(15) YG(6) GC(4) CB(11) BM(13) MR(6)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(B, H, W, 2) float flow -> (B, H, W, 3) uint8 RGB."""
    flow = np.asarray(flow, dtype=np.float32)
    assert flow.ndim == 4 and flow.shape[-1] == 2
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    rad_max = np.maximum(rad.reshape(flow.shape[0], -1).max(axis=1), 1e-8)
    rad_max = rad_max[:, None, None]
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), dtype=np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate with radius
        img[..., c] = np.floor(255.0 * col).astype(np.uint8)
    return img


def middle_slice(vol: np.ndarray, axis: int = -3) -> np.ndarray:
    """3D -> 2D: middle slice of the second-to-last spatial axis,
    matching the reference's convention (models.py:290:
    img[:, :, :, shape[-2]//2, :] in NCDHW == slicing spatial axis H)."""
    vol = np.asarray(vol)
    idx = vol.shape[axis] // 2
    return np.take(vol, idx, axis=axis)


def df_slice_channels(df: np.ndarray) -> np.ndarray:
    """Per the reference's 3D DF logging (models.py:293,301-302): slice
    the middle of spatial axis -2 and keep displacement channels
    (0, ndims-1) as the 2-channel flow.

    df: (B, D, H, W, 3) channels-last -> (B, D, W, 2)."""
    sl = middle_slice(df, axis=-3)  # (B, D, W, 3)
    return np.stack([sl[..., 0], sl[..., -1]], axis=-1)


def make_grid(imgs: np.ndarray, nrow: int | None = None, pad: int = 2) -> np.ndarray:
    """(B, H, W, C) -> single (H', W', C) tiled grid (min-max normalized
    per call like torchvision make_grid defaults are *not*; we keep raw
    values and let the writer normalize)."""
    b, h, w, c = imgs.shape
    if nrow is None:
        nrow = max(1, int(np.sqrt(b)))
    ncol = -(-b // nrow)
    grid = np.zeros((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c), imgs.dtype)
    for i in range(b):
        r, col = divmod(i, nrow)
        y0 = r * (h + pad) + pad
        x0 = col * (w + pad) + pad
        grid[y0 : y0 + h, x0 : x0 + w] = imgs[i]
    return grid
