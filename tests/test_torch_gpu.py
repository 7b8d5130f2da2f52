"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device. The
file imports no JAX (the card's machine has none), so it runs there
without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

TF32 is off in every comparison. The backward kernels that scatter with
float32 atomics (`warp_mgrad`, `squaring_step_bwd`) sum in an order
that changes from run to run, so they are held to 1e-5 of their scale,
not to bit-equality.
"""

import numpy as np
import pytest
import torch

from pulpo_tpu_torch.kernels import box_sum, squaring, vel_head, warp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The card, with TF32 off for comparisons; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return torch.from_numpy(v * (mag / np.abs(v).max()))


def _head_params(n0, zdim=3, seed=23):
    rng = np.random.default_rng(seed)
    r = lambda shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))
    return {
        "k1": r((n0, zdim, 3, 3, 3), 0.3), "b1": r((n0,), 0.1),
        "mean1": r((n0,), 0.5), "var1": r((n0,)).abs() + 0.1,
        "scale1": r((n0,)) + 1.0, "bias1": r((n0,), 0.2),
        "k2": r((n0, n0, 3, 3, 3), 0.2), "b2": r((n0,), 0.1),
        "mean2": r((n0,), 0.5), "var2": r((n0,)).abs() + 0.1,
        "scale2": r((n0,)) + 1.0, "bias2": r((n0,), 0.2),
        "k3": r((3, n0, 1, 1, 1), 0.5), "b3": r((3,), 0.1),
    }


def _permuted(v):
    """The same values with channels-first memory."""
    return v.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("mag", [0.3, 3.0, 15.0])
def test_warp_kernel_matches_plain(cuda_device, mag):
    rng = np.random.default_rng(10)
    m = torch.from_numpy(rng.random((2, 20, 24, 28, 1), dtype=np.float32)).to(cuda_device)
    d = _field((6, 20, 24, 28, 3), mag, 11).to(cuda_device)  # row r reads r % 2
    before = warp.launches
    got = warp.warp(m, d)
    torch.cuda.synchronize()
    assert warp.launches == before + 1
    torch.testing.assert_close(got, warp.warp_plain(m, d), rtol=0, atol=1e-5)
    torch.testing.assert_close(warp.warp(m, _permuted(d)), got, rtol=0, atol=0)
    mc = torch.from_numpy(rng.random((2, 40, 48, 56, 2), dtype=np.float32)).to(cuda_device)
    torch.testing.assert_close(warp.warp(mc, d), warp.warp_plain(mc, d), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mag", [2.0, 40.0])
def test_squaring_kernel_matches_plain(cuda_device, mag):
    v = _field((3, 20, 24, 28, 3), mag, 12).to(cuda_device)
    before = squaring.launches
    got = squaring.integrate_svf(v, 7)
    torch.cuda.synchronize()
    assert squaring.launches == before + 7
    ref = squaring.integrate_svf_plain(v, 7)
    tol = 1e-4 * float(ref.abs().max()) + 1e-4
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    # permuted memory (the decode's resized fields): buffers stay row-major
    torch.testing.assert_close(squaring.integrate_svf(_permuted(v), 7), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 0.02)])
@pytest.mark.parametrize("n0", [8, 32, 64])
def test_vel_head_kernel_matches_plain(cuda_device, dtype, rel, n0):
    p = {k: v.to(cuda_device) for k, v in _head_params(n0).items()}
    z = torch.randn((2, 13, 18, 21, 3), device=cuda_device).to(dtype)  # ragged tiles
    before = vel_head.launches
    got = vel_head.velocity_head(z, p)
    torch.cuda.synchronize()
    assert vel_head.launches == before + 1 and got.dtype == dtype
    ref = vel_head.velocity_head_plain(z, p)
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= rel * scale


def test_vel_head_kernel_raises_for_widths_it_does_not_take(cuda_device):
    p = {k: v.to(cuda_device) for k, v in _head_params(80).items()}
    with pytest.raises(ValueError):
        vel_head.velocity_head(torch.zeros((1, 8, 8, 8, 3), device=cuda_device), p)


def test_uq_on_the_card_matches_the_cpu(cuda_device):
    """A small UQ request: kernels on the card against plain versions on
    the CPU, same weights and draws; each leaf within 1e-3 of its scale."""
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8)
    cpu = PULPoModel(cfg, device="cpu")
    cpu.init(3)
    card = PULPoModel(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    x = rng.random((1, *cfg.input_size, 1), dtype=np.float32)
    y = rng.random((1, *cfg.input_size, 1), dtype=np.float32)
    noise = {l: torch.from_numpy(rng.standard_normal((4, 1, *cfg.level_sizes[l], 3),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    ref = predict_with_uncertainty(cpu, x, y, 4, chunk=2, noise=noise)
    got = predict_with_uncertainty(card, x, y, 4, chunk=2, noise=noise)
    for field, d in ref._asdict().items():
        if d is None:
            continue
        for l, r in d.items():
            g = getattr(got, field)[l].cpu()
            assert float((g - r).abs().max()) <= 1e-3 * max(1.0, float(r.abs().max())), field


def test_uq_chooses_a_fitting_chunk_on_the_card(cuda_device):
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8)
    model = PULPoModel(cfg, device=cuda_device)
    model.init(0)
    x = torch.rand((1, *cfg.input_size, 1), device=cuda_device)
    res = predict_with_uncertainty(model, x, x, 8, seed=1)
    assert len(model.decode_bytes) == 1 and next(iter(model.decode_bytes.values())) > 0
    assert 8 % res.outputs[0].shape[1] == 0
    assert all(bool(torch.isfinite(v).all()) for d in res if d is not None
               for v in d.values())


# ----------------------------------------------------------------------
# backward kernels
# ----------------------------------------------------------------------

def _close_scaled(got, ref, rel):
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= rel * scale and bool(torch.isfinite(got).all()), (err, scale)


@pytest.mark.parametrize("c,rows,mag", [(1, 6, 0.3), (1, 6, 15.0), (3, 2, 3.0)])
def test_warp_dfgrad_kernel_matches_plain(cuda_device, c, rows, mag):
    """Ragged sizes, C = 1 and 3, sample-tiled rows (row r reads r % 2),
    and a full-res moving image under a half-res df."""
    rng = np.random.default_rng(30)
    m = torch.from_numpy(rng.random((2, 20, 24, 28, c), dtype=np.float32)).to(cuda_device)
    d = _field((rows, 20, 24, 28, 3), mag, 31).to(cuda_device)
    g = torch.randn((rows, 20, 24, 28, c), device=cuda_device)
    before = warp.dfgrad_launches
    got = warp.warp_dfgrad(m, d, g)
    torch.cuda.synchronize()
    assert warp.dfgrad_launches == before + 1
    _close_scaled(got, warp.warp_dfgrad_plain(m, d, g), 1e-5)
    _close_scaled(warp.warp_dfgrad(m, _permuted(d), g), got, 0)
    mc = torch.from_numpy(rng.random((2, 40, 48, 56, c), dtype=np.float32)).to(cuda_device)
    _close_scaled(warp.warp_dfgrad(mc, d, g), warp.warp_dfgrad_plain(mc, d, g), 1e-5)


@pytest.mark.parametrize("c,rows,mag", [(1, 6, 3.0), (3, 2, 3.0), (3, 2, 15.0)])
def test_warp_mgrad_kernel_matches_plain(cuda_device, c, rows, mag):
    d = _field((rows, 20, 24, 28, 3), mag, 32).to(cuda_device)
    g = torch.randn((rows, 20, 24, 28, c), device=cuda_device)
    before = warp.mgrad_launches
    got = warp.warp_mgrad((2, 20, 24, 28, c), d, g)
    torch.cuda.synchronize()
    assert warp.mgrad_launches == before + 1
    _close_scaled(got, warp.warp_mgrad_plain((2, 20, 24, 28, c), d, g), 1e-5)
    _close_scaled(warp.warp_mgrad((2, 40, 48, 56, c), d, g),
                  warp.warp_mgrad_plain((2, 40, 48, 56, c), d, g), 1e-5)


@pytest.mark.parametrize("mag", [0.3, 3.0, 40.0])
def test_squaring_bwd_kernel_matches_plain(cuda_device, mag):
    v = _field((2, 20, 24, 28, 3), mag, 33).to(cuda_device)
    g = torch.randn((2, 20, 24, 28, 3), device=cuda_device)
    before = squaring.bwd_launches
    got = squaring.squaring_step_bwd(v, g)
    torch.cuda.synchronize()
    assert squaring.bwd_launches == before + 1
    _close_scaled(got, squaring.squaring_step_bwd_plain(v, g), 1e-5)
    _close_scaled(squaring.squaring_step_bwd(_permuted(v), g), got, 1e-5)


@pytest.mark.parametrize("win", [3, 5, 7, 9])
def test_box_sum_kernel_matches_plain(cuda_device, win):
    x = torch.randn((2, 13, 18, 21), device=cuda_device)  # ragged
    before = box_sum.launches
    got = box_sum.box_sum(x, win)
    torch.cuda.synchronize()
    assert box_sum.launches == before + 1
    _close_scaled(got, box_sum.box_sum_plain(x, win), 1e-5)


def _grads_on(device, fn, inputs, cot):
    xs = [t.to(device).requires_grad_(True) for t in inputs]
    out = fn(*xs)
    return torch.autograd.grad(out, xs, cot.to(device))


def test_backward_functions_on_the_card_match_the_cpu(cuda_device):
    """Warp (both cotangents), IntegrateSVF and BoxSum: the backward on the
    card (kernels) against the backward on the CPU (plain versions)."""
    rng = np.random.default_rng(34)
    m = torch.from_numpy(rng.random((2, 12, 14, 16, 3), dtype=np.float32))
    d = _field((4, 12, 14, 16, 3), 3.0, 35)
    cot = torch.from_numpy(rng.standard_normal((4, 12, 14, 16, 3)).astype(np.float32))
    for ref, got in zip(_grads_on("cpu", warp.warp, (m, d), cot),
                        _grads_on(cuda_device, warp.warp, (m, d), cot)):
        _close_scaled(got.cpu(), ref, 1e-5)

    v = _field((2, 12, 14, 16, 3), 6.0, 36)
    cot = torch.from_numpy(rng.standard_normal((2, 12, 14, 16, 3)).astype(np.float32))
    fn = lambda a: squaring.integrate_svf(a, 7)
    (ref,), (got,) = _grads_on("cpu", fn, (v,), cot), _grads_on(cuda_device, fn, (v,), cot)
    _close_scaled(got.cpu(), ref, 1e-4)

    x = torch.from_numpy(rng.standard_normal((2, 12, 14, 16)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 12, 14, 16)).astype(np.float32))
    fn = lambda a: box_sum.box_sum(a, 7)
    (ref,), (got,) = _grads_on("cpu", fn, (x,), cot), _grads_on(cuda_device, fn, (x,), cot)
    _close_scaled(got.cpu(), ref, 1e-5)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One small training step: the same weights, batch and draws on the
    card and on the CPU; losses rtol 1e-4, gradients within 1e-3 of each
    leaf's scale (of 1 % of the largest, for the conv biases that feed a
    train BatchNorm, whose gradient is 0 in exact arithmetic)."""
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train.step import compute_grads

    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8,
                      batch_size=2)
    cpu = PULPoModel(cfg, device="cpu")
    cpu.init(4)
    card = PULPoModel(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    batch = {k: rng.random((2, *cfg.input_size, 1), dtype=np.float32) for k in ("x", "y")}
    noise = {l: torch.from_numpy(rng.standard_normal((2, *cfg.level_sizes[l], 3),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    ref_g, ref_s, ref_m = compute_grads(cpu, batch, noise=noise)
    got_g, got_s, got_m = compute_grads(card, batch, noise=noise)
    for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-4, err_msg=k)
    top = max(float(g.abs().max()) for g in ref_g.values())
    for n, r in ref_g.items():
        scale = max(float(r.abs().max()), 1e-2 * top)
        assert float((got_g[n].cpu() - r).abs().max()) <= 1e-3 * scale, n
    for n, r in ref_s.items():
        torch.testing.assert_close(got_s[n].cpu(), r, rtol=0, atol=1e-5)
