"""Loss functions and regularizers.

Port of pulpo_tpu/ops/losses.py:24-348 (the reference's src/losses.py):
channels-last ((B, *spatial, C)), with the reference's reductions (sums
over spatial axes, means over batch and channel, a constant window
denominator in NCC, Bessel-corrected std). Each computes in its
inputs' dtype, as the JAX package does. NCC's box sums go through the
hand-written kernel (kernels/box_sum.py).
"""

from __future__ import annotations

import numpy as np
import torch

from pulpo_tpu_torch.kernels.box_sum import box_sum
from pulpo_tpu_torch.ops.resize import resize_linear


def _spatial_dims(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(1, x.dim() - 1))


# ---------------------------------------------------------------------------
# KL divergences
# ---------------------------------------------------------------------------


def kl_two_gauss_diag_cov(mu0, sigma0, mu1, sigma1, eps: float = 1e-10) -> torch.Tensor:
    """KL[p0 || p1] with diagonal covariances: flattened per sample,
    summed over features, averaged over the batch."""
    b = mu0.shape[0]
    s0 = torch.square(sigma0.reshape(b, -1))
    s1 = torch.square(sigma1.reshape(b, -1))
    log_s0 = torch.log(s0 + eps)
    log_s1 = torch.log(s1 + eps)
    m0 = mu0.reshape(b, -1)
    m1 = mu1.reshape(b, -1)
    per_sample = 0.5 * torch.sum(
        (s0 + torch.square(m1 - m0)) / (s1 + eps) + log_s1 - log_s0 - 1.0, dim=1)
    return torch.mean(per_sample)


def degree_matrix(spatial: tuple[int, ...]) -> np.ndarray:
    """Neighbour counts: a 3^nd ones-conv of a ones volume, minus 1, shaped
    (*spatial, 1). Built from the arrays' shape (DIVERGENCES 4)."""
    d = np.ones(spatial, dtype=np.float32)
    for ax in range(len(spatial)):
        k = np.ones(3, dtype=np.float32)
        d = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), ax, d)
    return (d - 1.0)[..., None]


def kl_nondiagonal(flow_mean, flow_sigma, prior_lambda: float = 20.0) -> torch.Tensor:
    """VoxelMorph-diff KL with a smoothness prior (reference losses.py:8-44)."""
    spatial = tuple(flow_mean.shape[1:-1])
    ndims = len(spatial)
    prodsize = 1
    for s in spatial:
        prodsize *= s
    sigma2 = torch.square(flow_sigma)
    d = torch.from_numpy(degree_matrix(spatial)).to(flow_sigma.device, flow_sigma.dtype)
    sigma_term = prior_lambda * d * sigma2 - torch.log(sigma2)
    sm = 0.0
    for ax in _spatial_dims(flow_mean):
        df = torch.diff(flow_mean, dim=ax)
        sm = sm + torch.mean(df * df)
    precision = 0.5 * sm / ndims
    return (torch.mean(sigma_term) + (prior_lambda / 2.0) * precision) * ndims * 0.5 * prodsize


# ---------------------------------------------------------------------------
# Reconstruction losses
# ---------------------------------------------------------------------------


def l2_loss(pred, target) -> torch.Tensor:
    """Squared error summed over spatial axes, averaged over batch and channel."""
    return torch.mean(torch.sum(torch.square(pred - target), dim=_spatial_dims(pred)))


def _box_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Box sum of a single-channel (B, *spatial, 1) volume."""
    assert x.shape[-1] == 1, f"NCC takes single-channel input, got C={x.shape[-1]}"
    return box_sum(x[..., 0], win)[..., None]


def ncc_loss(y_pred, y_true, win_size: int = 9, gamma: float = 0.05) -> torch.Tensor:
    """Local squared normalized cross-correlation: zero-padded box sums
    with a constant window-volume denominator even at borders; returns
    -sum(batch-mean cc) * gamma. 3D, C == 1."""
    ii, ji = y_true, y_pred
    ndims = ii.dim() - 2
    assert ndims == 3, "the box-sum kernel is 3D"
    i_sum = _box_sum(ii, win_size)
    j_sum = _box_sum(ji, win_size)
    i2_sum = _box_sum(ii * ii, win_size)
    j2_sum = _box_sum(ji * ji, win_size)
    ij_sum = _box_sum(ii * ji, win_size)
    w = float(win_size**ndims)
    u_i = i_sum / w
    u_j = j_sum / w
    cross = ij_sum - u_j * i_sum - u_i * j_sum + u_i * u_j * w
    i_var = i2_sum - 2 * u_i * i_sum + u_i * u_i * w
    j_var = j2_sum - 2 * u_j * j_sum + u_j * u_j * w
    cc = cross * cross / (i_var * j_var + 1e-8)
    cc = torch.mean(cc, dim=0)
    return -torch.sum(cc) * gamma


def soft_dice_loss(pred, target, dice_factor: float = 1.0) -> torch.Tensor:
    """Soft dice over the spatial axes (reference losses.py:137-145)."""
    dims = _spatial_dims(pred)
    prod_size = 1
    for s in pred.shape[1:-1]:
        prod_size *= s
    eps = 1e-6
    dice = (2.0 * torch.sum(target * pred, dim=dims) + eps) / (
        torch.sum(target**2, dim=dims) + torch.sum(pred**2, dim=dims) + eps)
    return torch.mean(1.0 - dice) * prod_size / dice_factor


# ---------------------------------------------------------------------------
# Deformation-field regularizers
# ---------------------------------------------------------------------------


def _central_diff(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(x[i+1] - x[i-1]) / 2 with replicated edges."""
    n = x.shape[dim]
    upper = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    lower = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return 0.5 * (upper - lower)


def jacobian_det(df: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Jacobian determinant of a displacement field (B, *spatial, nd) ->
    (B, *spatial), with the reference's flip-and-scale: channels flipped,
    then scaled by ((size_axis - 1) - 1) / 2 in the unflipped axis order."""
    spatial = df.shape[1:-1]
    ndims = len(spatial)
    assert ndims in (2, 3)
    if normalize:
        df = df * torch.tensor([2.0 / s for s in spatial], dtype=df.dtype, device=df.device)
    flipped = torch.flip(df, dims=(-1,))
    vox = torch.tensor([(s - 1 - 1) / 2.0 for s in spatial], dtype=df.dtype, device=df.device)
    disp_vox = flipped * vox
    grads = [_central_diff(disp_vox, 1 + i) for i in range(ndims)]
    if ndims == 2:
        j00 = grads[0][..., 0] + 1.0
        j01 = grads[0][..., 1]
        j10 = grads[1][..., 0]
        j11 = grads[1][..., 1] + 1.0
        return j00 * j11 - j10 * j01
    j = [[grads[i][..., c] + (1.0 if i == c else 0.0) for c in range(3)] for i in range(3)]
    return (j[0][0] * (j[1][1] * j[2][2] - j[2][1] * j[1][2])
            - j[0][1] * (j[1][0] * j[2][2] - j[2][0] * j[1][2])
            + j[0][2] * (j[1][0] * j[2][1] - j[2][0] * j[1][1]))


def jdet_std(df: torch.Tensor, lamb: float = 0.0, normalize: bool = True) -> torch.Tensor:
    """lamb * std(jacobian_det(df)), Bessel-corrected."""
    return lamb * torch.std(jacobian_det(df, normalize=normalize), correction=1)


def l2_reg(df: torch.Tensor, lamb: float = 0.0) -> torch.Tensor:
    """Diffusion regularizer: mean squared forward differences (cropped
    [1:] on every other axis, as the reference) * lamb * prod(spatial)."""
    spatial = df.shape[1:-1]
    ndims = len(spatial)
    prod_size = 1.0
    for s in spatial:
        prod_size *= s

    def crop_except(x, keep):
        for i in range(ndims):
            n = x.shape[1 + i]
            x = x.narrow(1 + i, 0, n - 1) if i == keep else x.narrow(1 + i, 1, n - 1)
        return x

    base = df
    for i in range(ndims):
        base = base.narrow(1 + i, 1, base.shape[1 + i] - 1)
    total = 0.0
    for i in range(ndims):
        total = total + torch.square(base - crop_except(df, i))
    return torch.mean(total) * lamb * prod_size


# ---------------------------------------------------------------------------
# Hierarchical wrappers (reference losses.py:225-355)
# ---------------------------------------------------------------------------


def hierarchical_kl_loss(prior_mus, prior_sigmas, posterior_mus, posterior_sigmas,
                         weight_dict, nondiagonal: bool = False,
                         prior_lambda: float = 20.0):
    total = 0.0
    levels = {}
    for l, w in weight_dict.items():
        if nondiagonal:
            levels[l] = w * kl_nondiagonal(posterior_mus[l], posterior_sigmas[l],
                                           prior_lambda=prior_lambda)
        else:
            levels[l] = w * kl_two_gauss_diag_cov(posterior_mus[l], posterior_sigmas[l],
                                                  prior_mus[l], prior_sigmas[l])
        total = total + levels[l]
    return total, levels


def hierarchical_reconstruction_loss(y_hat, y, weight_dict, recon_loss, window_size,
                                     gamma: float = 0.05, dice_factor: float = 1.0,
                                     y_hat_seg=None, seg_y=None):
    """Per level: the full-res target resized to y_hat[l]'s size, each
    selected loss added, divided by len(recon_loss), weighted, summed."""
    total = 0.0
    levels = {}
    for l, w in weight_dict.items():
        target = resize_linear(y, tuple(y_hat[l].shape[1:-1]))
        lvl = 0.0
        if "mse" in recon_loss:
            lvl = lvl + w * l2_loss(y_hat[l], target)
        if "ncc" in recon_loss:
            lvl = lvl + w * ncc_loss(y_hat[l], target, win_size=window_size[l], gamma=gamma)
        if "dice" in recon_loss:
            seg_target = resize_linear(seg_y, tuple(y_hat_seg[l].shape[1:-1]))
            lvl = lvl + w * soft_dice_loss(y_hat_seg[l], seg_target, dice_factor=dice_factor)
        levels[l] = lvl / len(recon_loss)
        total = total + levels[l]
    return total, levels


def hierarchical_regularization(dfs, weight_dict, regularizer: str = "L2",
                                lamb: float = 0.0):
    reg = l2_reg if regularizer == "L2" else jdet_std
    total = 0.0
    levels = {}
    for l, w in weight_dict.items():
        levels[l] = w * reg(dfs[l], lamb)
        total = total + levels[l]
    return total, levels
