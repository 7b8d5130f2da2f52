"""The port's losses (pulpo_tpu_torch/ops/losses.py) against the JAX
package's (pulpo_tpu/ops/losses.py), on the CPU, from the same numpy
inputs.

Tolerances (float32): values rtol 1e-5 (the same reductions in another
order); gradients of NCC, KL and l2_reg within 1e-4 of each gradient's
largest magnitude (NCC's ratio of box sums amplifies rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.ops import losses as JL
from pulpo_tpu_torch.ops import losses as TL
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(2, 16, 20, 24), (1, 15, 18, 21)]


def _rand(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref), rtol=rtol, atol=atol)


def _grad_close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _torch_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts)
    return out, grads


@pytest.mark.parametrize("shape", SHAPES)
def test_kl_diag_value_and_grads(shape):
    s = (*shape, 3)
    mu0, mu1 = _rand(s, 0, -1, 1), _rand(s, 1, -1, 1)
    sig0, sig1 = _rand(s, 2, 0.2, 1.5), _rand(s, 3, 0.5, 1.5)
    ref, ref_g = jax.value_and_grad(JL.kl_two_gauss_diag_cov, argnums=(0, 1))(
        *map(jnp.asarray, (mu0, sig0, mu1, sig1)))
    got, got_g = _torch_grads(lambda a, b: TL.kl_two_gauss_diag_cov(a, b, *_t(mu1, sig1)),
                              mu0, sig0)
    _close(got, ref)
    for g, r in zip(got_g, ref_g):
        _grad_close(g, r)


@pytest.mark.parametrize("shape", SHAPES)
def test_degree_matrix_and_kl_nondiagonal(shape):
    s = (*shape, 3)
    np.testing.assert_array_equal(TL.degree_matrix(shape[1:]),
                                  np.asarray(JL.degree_matrix(shape[1:])))
    mu, sig = _rand(s, 4, -2, 2), _rand(s, 5, 0.2, 1.5)
    fn = lambda m, sg: JL.kl_nondiagonal(m, sg, prior_lambda=20.0)
    ref, ref_g = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(sig))
    got, got_g = _torch_grads(lambda m, sg: TL.kl_nondiagonal(m, sg, prior_lambda=20.0),
                              mu, sig)
    _close(got, ref)
    for g, r in zip(got_g, ref_g):
        _grad_close(g, r)


@pytest.mark.parametrize("shape", SHAPES)
def test_l2_and_soft_dice(shape):
    p, t = _rand((*shape, 2), 6), _rand((*shape, 2), 7)
    _close(TL.l2_loss(*_t(p, t)), JL.l2_loss(jnp.asarray(p), jnp.asarray(t)))
    _close(TL.soft_dice_loss(*_t(p, t), dice_factor=50),
           JL.soft_dice_loss(jnp.asarray(p), jnp.asarray(t), dice_factor=50))


@pytest.mark.parametrize("win", [3, 9])
@pytest.mark.parametrize("shape", SHAPES)
def test_ncc_value_and_grad(shape, win):
    """The prediction's gradient, the path the training step takes (the
    box sums of j, j^2 and ij run backward)."""
    pred, true = _rand((*shape, 1), 8), _rand((*shape, 1), 9)
    fn = lambda a: JL.ncc_loss(a, jnp.asarray(true), win_size=win, gamma=0.05)
    ref, ref_g = jax.value_and_grad(fn)(jnp.asarray(pred))
    got, (got_g,) = _torch_grads(
        lambda a: TL.ncc_loss(a, torch.from_numpy(true), win_size=win, gamma=0.05), pred)
    _close(got, ref, rtol=1e-5)
    _grad_close(got_g, ref_g)


@pytest.mark.parametrize("shape", SHAPES)
def test_jacobian_det_and_jdet_std(shape):
    df = _rand((*shape, 3), 10, -2, 2)
    for normalize in (True, False):
        _close(TL.jacobian_det(torch.from_numpy(df), normalize=normalize),
               JL.jacobian_det(jnp.asarray(df), normalize=normalize), rtol=1e-5, atol=1e-5)
    _close(TL.jdet_std(torch.from_numpy(df), lamb=0.5),
           JL.jdet_std(jnp.asarray(df), lamb=0.5), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_l2_reg_value_and_grad(shape):
    df = _rand((*shape, 3), 11, -2, 2)
    ref, ref_g = jax.value_and_grad(lambda a: JL.l2_reg(a, lamb=0.025))(jnp.asarray(df))
    got, (got_g,) = _torch_grads(lambda a: TL.l2_reg(a, lamb=0.025), df)
    _close(got, ref)
    _grad_close(got_g, ref_g)


def _levels(seed, sizes, c):
    return {l: _rand((2, *s, c), seed + l, 0.2, 1.0) for l, s in sizes.items()}


@pytest.mark.parametrize("nondiagonal", [False, True])
def test_hierarchical_kl(nondiagonal):
    sizes = {0: (8, 10, 12), 1: (4, 5, 6)}
    pm, ps = _levels(0, sizes, 3), _levels(10, sizes, 3)
    qm, qs = _levels(20, sizes, 3), _levels(30, sizes, 3)
    w = {0: 1.0, 1: 8.0}
    tt = lambda d: {l: torch.from_numpy(a) for l, a in d.items()}
    jj = lambda d: {l: jnp.asarray(a) for l, a in d.items()}
    got, got_lv = TL.hierarchical_kl_loss(tt(pm), tt(ps), tt(qm), tt(qs), w,
                                          nondiagonal=nondiagonal)
    ref, ref_lv = JL.hierarchical_kl_loss(jj(pm), jj(ps), jj(qm), jj(qs), w,
                                          nondiagonal=nondiagonal)
    _close(got, ref)
    for l in w:
        _close(got_lv[l], ref_lv[l])


@pytest.mark.parametrize("recon", [("mse",), ("ncc",), ("ncc", "dice")])
def test_hierarchical_reconstruction(recon):
    """Per level: the full-res target resized to the prediction's size;
    with dice, the segmentation too."""
    full = (16, 20, 24)
    sizes = {0: full, 1: (8, 10, 12)}
    y_hat = _levels(40, sizes, 1)
    y = _rand((2, *full, 1), 50)
    seg_hat = _levels(60, sizes, 3)
    seg_y = _rand((2, *full, 3), 70)
    w, win = {0: 4.0 / 8, 1: 8.0}, {0: 5, 1: 3}
    tt = lambda d: {l: torch.from_numpy(a) for l, a in d.items()}
    jj = lambda d: {l: jnp.asarray(a) for l, a in d.items()}
    got, got_lv = TL.hierarchical_reconstruction_loss(
        tt(y_hat), torch.from_numpy(y), w, recon, win, gamma=0.05, dice_factor=50,
        y_hat_seg=tt(seg_hat), seg_y=torch.from_numpy(seg_y))
    ref, ref_lv = JL.hierarchical_reconstruction_loss(
        jj(y_hat), jnp.asarray(y), w, recon, win, gamma=0.05, dice_factor=50,
        y_hat_seg=jj(seg_hat), seg_y=jnp.asarray(seg_y))
    _close(got, ref, rtol=1e-5, atol=1e-5)
    for l in w:
        _close(got_lv[l], ref_lv[l], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("regularizer", ["L2", "jdet"])
def test_hierarchical_regularization(regularizer):
    sizes = {0: (16, 20, 24), 1: (8, 10, 12)}
    dfs = {l: _rand((2, *s, 3), 80 + l, -2, 2) for l, s in sizes.items()}
    w = {0: 1.0 / 8, 1: 8.0}
    got, got_lv = TL.hierarchical_regularization(
        {l: torch.from_numpy(a) for l, a in dfs.items()}, w, regularizer, lamb=0.025)
    ref, ref_lv = JL.hierarchical_regularization(
        {l: jnp.asarray(a) for l, a in dfs.items()}, w, regularizer, lamb=0.025)
    _close(got, ref)
    for l in w:
        _close(got_lv[l], ref_lv[l])
