"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device. The
file imports no JAX (the card's machine has none), so it runs there
without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

TF32 is off in every comparison. The backward kernels that scatter
(`warp_mgrad`, `squaring_step_bwd`) sum their terms order-free in 64-bit
fixed point (csrc/fixed.cuh), so each repeats itself bit for bit;
`warp_mgrad` is bit-equal to its plain version, which quantizes and sums
the same way, and `squaring_step_bwd` is held to 1e-5 of its scale.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    BF16_CHAIN_REL,
    Checks,
    chain_stages,
    check_eval_gradients,
    misaligned,
    pos_head_params,
    respiratory_field,
)
from pulpo_tpu_torch.kernels import box_sum, conv_chain, pos_head, squaring, vel_head, warp

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
    and a full-res moving image under a half-res df. C = 1 is bit-equal
    to the plain version; at C = 3 the plain version's channel `sum`
    adds in its own order on the card: 1e-5 of scale."""
    rng = np.random.default_rng(30)
    rel = 0.0 if c == 1 else 1e-5
    m = torch.from_numpy(rng.random((2, 20, 24, 28, c), dtype=np.float32)).to(cuda_device)
    d = _field((rows, 20, 24, 28, 3), mag, 31).to(cuda_device)
    g = torch.randn((rows, 20, 24, 28, c), device=cuda_device)
    before = warp.dfgrad_launches
    got = warp.warp_dfgrad(m, d, g)
    torch.cuda.synchronize()
    assert warp.dfgrad_launches == before + 1
    _close_scaled(got, warp.warp_dfgrad_plain(m, d, g), rel)
    _close_scaled(warp.warp_dfgrad(m, _permuted(d), g), got, 0)
    mc = torch.from_numpy(rng.random((2, 40, 48, 56, c), dtype=np.float32)).to(cuda_device)
    _close_scaled(warp.warp_dfgrad(mc, d, g), warp.warp_dfgrad_plain(mc, d, g), rel)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("moving,df,mag", [((2, 20, 24, 28), (6, 20, 24, 28), 3.0),
                                           ((2, 40, 48, 56), (6, 20, 24, 28), 3.0),
                                           ((3, 9, 5, 37), (9, 11, 7, 33), 15.0),
                                           ((1, 13, 17, 19), (5, 13, 17, 19), 0.3)])
def test_warp_dfgrad_on_the_gather_plan(cuda_device, monkeypatch, c, moving, df, mag):
    """The df-cotangent on the forward warp's tile plan: more df rows than
    moving rows (row r reads r % B), a moving image of another size than
    the df (the cross-resolution warp), ragged sizes, each df row group of
    one row and of several (the block's row walk). C = 1, the training
    step's width and its own instantiation: bit-equal to the plain
    version. C = 3 (the runtime channel loop): within 1e-5 of scale, as
    the plain version's channel `sum` on the card adds in its own order;
    the same output from one launch to the next. A permuted-memory df
    gives the contiguous one's output exactly."""
    from pulpo_tpu_torch.kernels import gather

    rng = np.random.default_rng(sum(moving) + sum(df) + c)
    m = torch.from_numpy(rng.random((*moving, c), dtype=np.float32)).to(cuda_device)
    d = _field((*df, 3), mag, 33 + c).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((*df, c)).astype(np.float32)).to(cuda_device)
    ref = warp.warp_dfgrad_plain(m, d, g)
    first = None
    for blocks in (gather.TARGET_BLOCKS, 1):
        monkeypatch.setattr(gather, "TARGET_BLOCKS", blocks)
        before = warp.dfgrad_launches
        got = warp.warp_dfgrad(m, d, g)
        torch.cuda.synchronize()
        assert warp.dfgrad_launches == before + 1
        if c == 1:
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
        else:
            _close_scaled(got, ref, 1e-5)
        first = got if first is None else first
        assert torch.equal(got, first)
        assert torch.equal(warp.warp_dfgrad(m, _permuted(d), g), got)


def test_warp_dfgrad_refuses_a_plan_it_cannot_walk(cuda_device, monkeypatch):
    """A plan whose tiles miss part of the output is refused at the C
    entry (gather::valid), not launched."""
    from pulpo_tpu_torch.kernels import gather

    real = gather.warp_plan
    monkeypatch.setattr(gather, "warp_plan", lambda *a, **k: dict(real(*a, **k), tiles_y=1))
    m = torch.rand((1, 13, 17, 19, 1), device=cuda_device)
    d = _field((2, 13, 17, 19, 3), 2.0, 64).to(cuda_device)
    g = torch.randn((2, 13, 17, 19, 1), device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        warp.warp_dfgrad(m, d, g)


@pytest.mark.parametrize("c,rows,mag", [(1, 6, 3.0), (3, 2, 3.0), (3, 2, 15.0)])
def test_warp_mgrad_kernel_matches_plain(cuda_device, c, rows, mag):
    d = _field((rows, 20, 24, 28, 3), mag, 32).to(cuda_device)
    g = torch.randn((rows, 20, 24, 28, c), device=cuda_device)
    before = warp.mgrad_launches
    got = warp.warp_mgrad((2, 20, 24, 28, c), d, g)
    torch.cuda.synchronize()
    assert warp.mgrad_launches == before + 1
    torch.testing.assert_close(got, warp.warp_mgrad_plain((2, 20, 24, 28, c), d, g),
                               rtol=0, atol=0)
    torch.testing.assert_close(warp.warp_mgrad((2, 40, 48, 56, c), d, g),
                               warp.warp_mgrad_plain((2, 40, 48, 56, c), d, g), rtol=0, atol=0)


@pytest.mark.parametrize("c,moving,df", [
    (3, (1, 20, 24, 28), (1, 20, 24, 28)), (1, (2, 40, 48, 56), (4, 20, 24, 28)),
    (2, (1, 13, 17, 19), (2, 13, 17, 19)), (36, (1, 8, 9, 10), (2, 8, 9, 10))])
def test_fixed_scatters_repeat_themselves_bit_for_bit(cuda_device, c, moving, df):
    """Ten launches of the moving-cotangent (#7: C = 3, a cross-resolution
    C = 1 with 2 df rows a moving row, C = 2 and C = 36, whose passes take
    one and three channels) and of the squaring backward (#2, whole and as
    two slabs' shares): the same bits every time, #7 also the plain
    version's."""
    d = _field((df[0], *df[1:], 3), 3.0, 34).to(cuda_device)
    g = torch.randn((df[0], *df[1:], c), device=cuda_device)
    shape = (*moving, c)
    first = warp.warp_mgrad(shape, d, g)
    assert torch.equal(first, warp.warp_mgrad_plain(shape, d, g))
    for _ in range(9):
        assert torch.equal(warp.warp_mgrad(shape, d, g), first)
    v = _field((1, 20, 24, 28, 3), 4.0, 35).to(cuda_device)
    g3 = torch.randn((1, 20, 24, 28, 3), device=cuda_device)
    whole = squaring.squaring_step_bwd(v, g3)
    shares = [squaring.squaring_step_bwd(v, g3[:, z0:z0 + 10].contiguous(), z0)
              for z0 in (0, 10)]
    _close_scaled(whole, squaring.squaring_step_bwd_plain(v, g3), 1e-5)
    for _ in range(9):
        assert torch.equal(squaring.squaring_step_bwd(v, g3), whole)
        for z0, share in zip((0, 10), shares):
            assert torch.equal(squaring.squaring_step_bwd(v, g3[:, z0:z0 + 10].contiguous(),
                                                          z0), share)


def test_sharded_squaring_backward_on_the_card_is_the_whole_one(cuda_device):
    """The squaring backward's slab launches of a sharded step (two ranks
    simulated by threads; the launch's three phases around the column's
    max and the exchange of its sums): the slabs of the whole backward,
    bit for bit, and of its plain version."""
    import threading

    v = _field((1, 20, 24, 28, 3), 4.0, 37).to(cuda_device)
    g = torch.randn((1, 20, 24, 28, 3), device=cuda_device)
    top = torch.maximum(warp.abs_max_bits(g[:, :10]), warp.abs_max_bits(g[:, 10:]))
    barrier, slots, outs = threading.Barrier(2), [None, None], [None, None]

    def exchange_of(rank):
        def exchange(acc):
            slots[rank] = acc.clone()
            barrier.wait()
            acc[:, 10 * rank:10 * (rank + 1)] += slots[1 - rank][:, 10 * rank:10 * (rank + 1)]
            barrier.wait()
        return exchange

    def run(r):
        outs[r] = squaring.squaring_step_bwd(
            v, g[:, 10 * r:10 * (r + 1)].contiguous(), 10 * r, (top, exchange_of(r)))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = torch.cat(outs, dim=1)
    assert torch.equal(got, squaring.squaring_step_bwd(v, g))
    assert torch.equal(got, squaring.squaring_step_bwd_plain(v, g))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_fixed_scatters_give_nan_for_a_non_finite_cotangent(cuda_device, bad):
    """One non-finite cotangent entry makes every output of #7 and #2 NaN,
    as in their plain versions (the launch's scale is not finite); an
    all-zero cotangent gives zeros, and #2 then its own terms."""
    d = _field((2, 10, 12, 14, 3), 2.0, 36).to(cuda_device)
    g = torch.randn((2, 10, 12, 14, 3), device=cuda_device)
    g[1, 3, 4, 5, 2] = bad
    got = warp.warp_mgrad((1, 10, 12, 14, 3), d, g)
    assert bool(torch.isnan(got).all())
    assert bool(torch.isnan(warp.warp_mgrad_plain((1, 10, 12, 14, 3), d, g)).all())
    v = d[:1].contiguous()
    assert bool(torch.isnan(squaring.squaring_step_bwd(v, g[1:].contiguous())).all())
    zero = torch.zeros_like(g)
    assert torch.equal(warp.warp_mgrad((1, 10, 12, 14, 3), d, zero),
                       torch.zeros((1, 10, 12, 14, 3), device=cuda_device))
    assert torch.equal(squaring.squaring_step_bwd(v, zero[:1].contiguous()),
                       squaring.squaring_step_bwd_plain(v, zero[:1]))


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
    torch.testing.assert_close(got, box_sum.box_sum_plain(x, win), rtol=0, atol=0)


@pytest.mark.parametrize("win", [3, 5, 7, 9, 11])
@pytest.mark.parametrize("shape", [(1, 7, 37, 45), (2, 3, 33, 14), (1, 21, 13, 1),
                                   (1, 40, 48, 56), (1, 12, 12, 13)])
def test_box_sum_one_launch_bit_equal_at_ragged_sizes(cuda_device, win, shape):
    """The 3D box sum at ragged sizes (innermost 45, 14, 1, 56, 13; depths
    shorter than the window and than a chunk), the step's windows and a
    wider one (11): one launch a call, bit-equal to the plain version,
    also from permuted memory and from a base 4 bytes past a 16-byte
    boundary (the scalar copies and stores)."""
    x = torch.from_numpy(np.random.default_rng(70).standard_normal(shape).astype(np.float32))
    x = x.to(cuda_device)
    ref = box_sum.box_sum_plain(x, win)
    before = box_sum.launches
    got = box_sum.box_sum(x, win)
    torch.cuda.synchronize()
    assert box_sum.launches == before + 1
    assert torch.equal(got, ref)
    perm = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert torch.equal(box_sum.box_sum(perm, win), ref)
    assert torch.equal(box_sum.box_sum(_misaligned(x), win), ref)


def test_box_sum_raises_past_its_widest_window(cuda_device):
    x = torch.zeros((1, 4, 8, 8), device=cuda_device)
    torch.testing.assert_close(box_sum.box_sum(x, box_sum.MAX_WINDOW), x)
    with pytest.raises(ValueError):
        box_sum.box_sum(x, box_sum.MAX_WINDOW + 2)


@pytest.mark.parametrize("blocks", [None, 1, 10**6])
@pytest.mark.parametrize("mag", [0.3, 2.5, 12.0, "smooth 3"])
@pytest.mark.parametrize("shape", [(1, 13, 17, 19), (2, 9, 30, 70), (1, 5, 7, 2)])
def test_squaring_bwd_kernel_at_ragged_sizes(cuda_device, monkeypatch, shape, mag, blocks):
    """The squaring backward at ragged sizes, under noise fields of |v|
    inside a voxel and past it (few terms merged) and a smooth 3-voxel
    field (most of a voxel's terms merged with the next plane's and the
    next lane's before they are sent), with z in the plan's chunks, in
    one chunk (`blocks` 1) and one plane a chunk (10**6), from permuted
    memory: within 1e-5 of scale of the plain version, one launch a call."""
    from chip_smoke import smooth_field
    from pulpo_tpu_torch.kernels import gather

    if blocks is not None:
        monkeypatch.setattr(gather, "BWD_TARGET_BLOCKS", blocks)
    if mag == "smooth 3":
        v = smooth_field(shape[0], shape[1:], 3.0, seed=72, device=cuda_device)
    else:
        v = _field((*shape, 3), mag, 71).to(cuda_device)
    g = torch.randn((*shape, 3), device=cuda_device)
    ref = squaring.squaring_step_bwd_plain(v, g)
    before = squaring.bwd_launches
    got = squaring.squaring_step_bwd(v, g)
    torch.cuda.synchronize()
    assert squaring.bwd_launches == before + 1
    _close_scaled(got, ref, 1e-5)
    _close_scaled(squaring.squaring_step_bwd(_permuted(v), g), ref, 1e-5)


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


# ----------------------------------------------------------------------
# the LungCT path: large displacements, the Trainer and the evaluation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("si", [8.0, 16.0, 24.0])
def test_warp_and_dfgrad_bit_equal_under_large_displacement(cuda_device, si):
    rng = np.random.default_rng(40)
    shape = (37, 30, 42)  # ragged
    m = torch.from_numpy(rng.random((1, *shape, 1), dtype=np.float32)).to(cuda_device)
    d = respiratory_field(shape, si, 4.0, cuda_device)
    g = torch.from_numpy(rng.standard_normal((1, *shape, 1)).astype(np.float32)).to(cuda_device)
    torch.testing.assert_close(warp.warp(m, d), warp.warp_plain(m, d), rtol=0, atol=0)
    torch.testing.assert_close(warp.warp(m, _permuted(d)), warp.warp_plain(m, d), rtol=0, atol=0)
    torch.testing.assert_close(warp.warp_dfgrad(m, d, g), warp.warp_dfgrad_plain(m, d, g),
                               rtol=0, atol=0)


@pytest.mark.parametrize("si", [8.0, 16.0])
def test_mgrad_and_squaring_under_large_displacement(cuda_device, si):
    rng = np.random.default_rng(41)
    shape = (19, 15, 21)  # ragged
    d = respiratory_field(shape, si, 4.0, cuda_device)
    g = torch.from_numpy(rng.standard_normal((1, *shape, 3)).astype(np.float32)).to(cuda_device)
    torch.testing.assert_close(warp.warp_mgrad((1, *shape, 3), d, g),
                               warp.warp_mgrad_plain((1, *shape, 3), d, g), rtol=0, atol=0)
    v = respiratory_field(shape, si / 2, 2.0, cuda_device)
    torch.testing.assert_close(squaring.integrate_svf(v, 7), squaring.integrate_svf_plain(v, 7),
                               rtol=0, atol=0)
    vk = v * (1.0 / 2**7)
    for _ in range(7):
        _close_scaled(squaring.squaring_step_bwd(vk, g), squaring.squaring_step_bwd_plain(vk, g),
                      1e-5)
        vk = squaring.squaring_step_plain(vk)


def _cpu_draws(monkeypatch):
    """Posterior draws made on the CPU and moved to the device, so that a
    run on the card and one on the CPU see the same noise."""
    from pulpo_tpu_torch.models import pulpo

    plain = pulpo.draw_normal
    monkeypatch.setattr(pulpo, "draw_normal",
                        lambda seed, samples, level, shape, device:
                        plain(seed, samples, level, shape, "cpu").to(device))


def test_trainer_on_the_card_repeats_itself_bit_for_bit(cuda_device, monkeypatch, tmp_path):
    """The Trainer test's two steps (validation, checkpoints and logging
    after each) twice on the card under cuDNN's deterministic algorithms:
    every logged value the same bits. The port's only scatters (#7, #2)
    sum order-free, so nothing of the step depends on the order of its
    adds."""
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.loader import DataLoader
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.train.loop import Trainer
    from pulpo_tpu_torch.train.metrics import read_metrics

    _cpu_draws(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8,
                      log_every_n_steps=1, dataset="synthetic")
    ds = SyntheticDataset(shape=cfg.input_size, n=4, seed=3)
    runs = []
    for i in range(2):
        trainer = Trainer(cfg, run_dir=tmp_path, experiment=f"run{i}", device=cuda_device)
        state = trainer.fit(DataLoader(ds, 1, shuffle=True, seed=0),
                            DataLoader(ds, 1, seed=1), max_steps=2)
        trainer.close()
        assert state.step == 2 and not state.nan_flag
        runs.append(read_metrics(trainer.run_dir))
    assert [r["step"] for r in runs[0]] == [1, 2]
    assert runs[0] == runs[1]


# The Trainer test's two steps on an NVIDIA H100 80GB HBM3 at 700 W
# (scripts/probe_trainer_spread.py: 72 runs under cuDNN's deterministic
# algorithms, in 14 processes over 3 machines). CARD_SPREAD: the largest
# relative difference between two runs in one process (30 runs;
# 2/val/regularization_loss; 1.35e-3 between any two of the 72), from the
# squaring step's backward when it added its scatter with float32 atomics
# in an order that changed from run to run; it now sums order-free in
# fixed point, and two card runs give the same bits
# (test_trainer_on_the_card_repeats_itself_bit_for_bit). CPU_GAP: with
# that backward replaced by its plain version too, the runs were
# bit-identical and at most 3.77e-4 from the CPU (step 2; 3.3e-4 at
# step 1).
CARD_SPREAD = 1.037e-3
CPU_GAP = 3.8e-4


def test_trainer_on_the_card_matches_the_cpu(cuda_device, monkeypatch, tmp_path):
    """Two Trainer steps (validation, checkpoints and logging after each)
    on the card and on the CPU from the same seed: every logged loss of
    step 1 within 1e-3 relative, of step 2 within the deterministic
    card's gap to the CPU plus the card's own run-to-run spread
    (CPU_GAP + CARD_SPREAD, 1.417e-3).

    The card's runs differ from one another from the first update on: the
    squaring step's backward (csrc/squaring_bwd.cu) sums with float32
    atomics, and cuDNN's default backward algorithms are not
    deterministic either. Measured (scripts/probe_trainer_spread.py, 72
    runs): with cuDNN's defaults runs came up to 1.48e-3 from the CPU (the
    test failed 1 run in 6 at rtol 1e-3); with
    `torch.backends.cudnn.deterministic`, set here, up to 1.22e-3 from the
    CPU at step 2 (mean 5.4e-4, standard deviation 2.7e-4) and 7.5e-4 at
    step 1; with the squaring backward's plain version too, bit-identical
    and at most 3.77e-4 from the CPU. The validation regularization loss
    moves most."""
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.loader import DataLoader
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.train.loop import Trainer
    from pulpo_tpu_torch.train.metrics import read_metrics

    _cpu_draws(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8,
                      log_every_n_steps=1, dataset="synthetic")
    ds = SyntheticDataset(shape=cfg.input_size, n=4, seed=3)
    rows = {}
    for dev in ("cpu", cuda_device):
        trainer = Trainer(cfg, run_dir=tmp_path, experiment=str(dev), device=dev)
        state = trainer.fit(DataLoader(ds, 1, shuffle=True, seed=0),
                            DataLoader(ds, 1, seed=1), max_steps=2)
        trainer.close()
        assert state.step == 2 and not state.nan_flag
        rows[str(dev)] = read_metrics(trainer.run_dir)
    ref, got = rows["cpu"], rows[str(cuda_device)]
    assert [r["step"] for r in got] == [1, 2] and [sorted(r) for r in got] == [sorted(r) for r in ref]
    for r, g in zip(ref, got):
        rtol = 1e-3 if r["step"] == 1 else CPU_GAP + CARD_SPREAD
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=rtol, atol=1e-6, err_msg=k)


def test_evaluate_performance_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The deterministic performance table on the card and on the CPU for
    the same weights: the same NaN pattern, entries within 1e-3 (both
    rounded to 3 decimals)."""
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.eval.evaluator import Evaluate
    from pulpo_tpu_torch.models import PULPoModel

    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8,
                      dataset="synthetic")
    tables = []
    for dev in ("cpu", cuda_device):
        model = PULPoModel(cfg, device=dev)
        model.init(7)
        ev = Evaluate(device=dev)
        ev.set_model(model, output_dir=tmp_path / str(dev))
        ev.load_data("synthetic", segs=True, lms=True, mask=False)
        tables.append(ev.performance())
    ref, got = tables
    assert got.columns == ref.columns
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(ref.values))
    np.testing.assert_allclose(got.values, ref.values, rtol=0, atol=1e-3 + 1e-9)


# ----------------------------------------------------------------------
# eval conv chains: the posterior head and the narrow-input ConvSequence
# ----------------------------------------------------------------------

# f32: summation order only, 1e-4 of scale; bf16: 4 bf16 ulps at the
# output's scale (an intermediate that rounds the other way moves an
# output by about one)
EVAL_TOL = [(torch.float32, 1e-4), (torch.bfloat16, BF16_CHAIN_REL)]


@pytest.mark.parametrize("dtype,rel", EVAL_TOL)
@pytest.mark.parametrize("c_fb,n_up,n_merge", [(5, 8, 8), (16, 96, 64), (16, 96, 192)])
def test_pos_head_kernel_matches_plain(cuda_device, dtype, rel, c_fb, n_up, n_merge):
    """R = 4 rows over B = 2 pairs (row r reads y2[r % 2]), a ragged
    volume, the scalar (c_fb 5) and 16-byte (c_fb 16) input gathers."""
    p = pos_head_params((c_fb, n_up, n_merge), 3, 40, cuda_device)
    fb = torch.randn((4, 5, 7, 9, c_fb), device=cuda_device).to(dtype)
    y2 = torch.randn((2, 5, 7, 9, n_merge), device=cuda_device).to(dtype)
    assert pos_head.takes(fb, p)
    before = pos_head.launches
    got = pos_head.posterior_head(fb, y2, p)
    torch.cuda.synchronize()
    assert pos_head.launches == before + 4
    for g, r in zip(got, pos_head.posterior_head_plain(fb, y2, p)):
        assert g.dtype == dtype and g.shape == r.shape
        _close_scaled(g.float(), r.float(), rel)


@pytest.mark.parametrize("dtype,rel", EVAL_TOL)
@pytest.mark.parametrize("widths", [(2, 32, 32, 32), (3, 8, 16), (8, 16, 16, 16, 16)])
def test_conv_chain_kernel_matches_plain(cuda_device, dtype, rel, widths):
    stages = chain_stages(widths, 41, cuda_device)
    x = torch.randn((2, 11, 13, 30, widths[0]), device=cuda_device).to(dtype)
    before = conv_chain.launches
    got = conv_chain.conv_chain(_permuted(x), stages)
    torch.cuda.synchronize()
    assert conv_chain.launches == before + len(stages) and got.dtype == dtype
    _close_scaled(got.float(), conv_chain.conv_chain_plain(x, stages).float(), rel)


def test_eval_kernels_raise_for_shapes_they_do_not_take(cuda_device):
    p = pos_head_params((16, 192, 384), 3, 42, cuda_device)
    fb = torch.zeros((2, 4, 4, 4, 16), device=cuda_device)
    with pytest.raises(ValueError):
        pos_head.posterior_head(fb, torch.zeros((1, 4, 4, 4, 384), device=cuda_device), p)
    p = pos_head_params((16, 96, 64), 3, 42, cuda_device)
    with pytest.raises(ValueError):  # y2 of the wrong width
        pos_head.posterior_head(fb, torch.zeros((1, 4, 4, 4, 32), device=cuda_device), p)
    with pytest.raises(ValueError):
        pos_head.posterior_head(fb.half(), torch.zeros((1, 4, 4, 4, 64), device=cuda_device), p)
    stages = chain_stages((16, 32), 42, cuda_device)
    with pytest.raises(ValueError):  # 16 input channels: not the narrow chain
        conv_chain.conv_chain(torch.zeros((1, 4, 4, 4, 16), device=cuda_device), stages)


def test_eval_kernel_gradients_are_the_plain_versions(cuda_device):
    """A gradient through each eval kernel's wrapper on the card (input and
    weights) equals the plain version's within 1e-5 of its scale (float32):
    before the autograd Functions, the card's velocity head returned no
    graph at all."""
    checks = Checks()
    check_eval_gradients(cuda_device, checks)
    assert not checks.failures


# ----------------------------------------------------------------------
# the channels-first kernels and the narrow conv
# ----------------------------------------------------------------------

def _cf(v):
    """A channels-last tensor's values in contiguous channels-first memory."""
    return v.permute(0, 4, 1, 2, 3).contiguous()


@pytest.mark.parametrize("mag", [0.3, 6.0, 40.0])
def test_cf_squaring_bit_equal_to_cl_and_plain(cuda_device, mag):
    v = _field((3, 20, 24, 28, 3), mag, 90).to(cuda_device)
    before = squaring.cf_launches
    got = squaring.integrate_svf_cf(_cf(v), 7)
    torch.cuda.synchronize()
    assert squaring.cf_launches == before + 7 and got.shape == (3, 3, 20, 24, 28)
    cl = got.permute(0, 2, 3, 4, 1)
    assert torch.equal(cl, squaring.integrate_svf(v, 7))
    assert torch.equal(cl, squaring.integrate_svf_plain(v, 7))
    # a non-contiguous CF input (channels-last memory)
    assert torch.equal(squaring.integrate_svf_cf(v.permute(0, 4, 1, 2, 3), 7), got)
    one = squaring.squaring_step_cf(_cf(v), scale=0.125)
    assert torch.equal(one, squaring.squaring_step_cf_plain(_cf(v) * 0.125))


@pytest.mark.parametrize("c", [1, 3])
def test_cf_warp_bit_equal_to_cl_and_plain(cuda_device, c):
    rng = np.random.default_rng(91)
    m = torch.from_numpy(rng.random((2, 20, 24, 28, c), dtype=np.float32)).to(cuda_device)
    d = _field((6, 20, 24, 28, 3), 9.0, 92).to(cuda_device)  # row r reads r % 2
    before = warp.cf_launches
    got = warp.warp_cf(_cf(m), _cf(d))
    torch.cuda.synchronize()
    assert warp.cf_launches == before + 1 and got.shape == (6, c, 20, 24, 28)
    assert torch.equal(got.permute(0, 2, 3, 4, 1), warp.warp(m, d))
    assert torch.equal(got, warp.warp_cf_plain(_cf(m), _cf(d)))
    assert torch.equal(warp.warp_cf(m.permute(0, 4, 1, 2, 3), d.permute(0, 4, 1, 2, 3)), got)
    # cross resolution: a full-size moving, a half-size df
    mc = torch.from_numpy(rng.random((2, 40, 48, 56, c), dtype=np.float32)).to(cuda_device)
    assert torch.equal(warp.warp_cf(_cf(mc), _cf(d)).permute(0, 2, 3, 4, 1), warp.warp(mc, d))


def test_cf_kernel_gradients_are_the_plain_versions(cuda_device):
    """A gradient through the CF kernels on the card is the plain
    version's (never a silent zero): float32, 1e-5 of its scale."""
    v = _field((1, 10, 12, 14, 3), 3.0, 93).to(cuda_device)
    m = torch.rand((1, 1, 10, 12, 14), device=cuda_device)
    cases = [(lambda a: squaring.integrate_svf_cf(a, 4),
              lambda a: squaring.integrate_svf_cf_plain(a, 4), [_cf(v)]),
             (warp.warp_cf, warp.warp_cf_plain, [m, _cf(v)])]
    for kernel, plain, inputs in cases:
        got_in = [t.clone().requires_grad_(True) for t in inputs]
        ref_in = [t.clone().requires_grad_(True) for t in inputs]
        g = torch.randn(kernel(*inputs).shape, device=cuda_device)
        got = torch.autograd.grad((kernel(*got_in) * g).sum(), got_in)
        ref = torch.autograd.grad((plain(*ref_in) * g).sum(), ref_in)
        for a, b in zip(got, ref):
            assert float(b.abs().max()) > 0
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, float(b.abs().max())))


def test_fullres_uq_on_the_card_matches_the_cpu(cuda_device):
    """A small full_res request (the channels-first decode and mean tail):
    kernels on the card against plain versions on the CPU, every leaf
    within 1e-3 of its scale."""
    from chip_smoke import FULLRES_KW, check_small_reference

    check_small_reference(cuda_device, size=(24, 28, 32), n=4, **FULLRES_KW)


def _narrow_weight(cin, cout, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3))
                             / np.sqrt(27 * cin)).astype(np.float32))


def _bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(1, 8), (2, 32), (3, 32), (4, 16), (3, 12)])
def test_conv_narrow_kernel_bf16_within_an_ulp_f32_bit_equal(cuda_device, dtype, cin, cout):
    """Ragged tiles (9 x 11 x 37), every cin, a cout that is not a multiple
    of 8, a permuted-memory input. The f32 body repeats the plain
    version's operations: equal. The bf16 body sums on the tensor cores
    in another order: within one bf16 ulp at the output's scale. A
    permuted input gives the contiguous one's output exactly."""
    from pulpo_tpu_torch.kernels import conv_narrow

    w = _narrow_weight(cin, cout, cin * 100 + cout).to(cuda_device)
    x = torch.randn((2, 9, 11, 37, cin), device=cuda_device).to(dtype)
    before = conv_narrow.launches
    with torch.no_grad():
        got = conv_narrow.conv_narrow(x, w)
        torch.cuda.synchronize()
        assert conv_narrow.launches == before + 1
        assert got.dtype == dtype and got.shape == (2, 9, 11, 37, cout)
        ref = conv_narrow.conv_narrow_plain(x, w)
        if dtype == torch.float32:
            assert torch.equal(got, ref)
        else:
            scale = max(1.0, float(ref.float().abs().max()))
            torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=_bf16_ulp(scale))
        assert torch.equal(conv_narrow.conv_narrow(_permuted(x), w), got)


@pytest.mark.parametrize("cin,cout,shape", [(1, 12, (1, 5, 9, 13)), (4, 12, (1, 4, 17, 40)),
                                            (1, 32, (2, 3, 19, 45)), (4, 32, (1, 11, 3, 33)),
                                            (2, 40, (1, 6, 10, 17)), (3, 64, (1, 12, 9, 17))])
def test_conv_narrow_tensor_cores_at_ragged_sizes(cuda_device, monkeypatch, cin, cout, shape):
    """The bf16 body on sizes that are not a multiple of its 8 x 32 tile
    (and thinner than it), cin 1 and 4 (odd and even: a pad channel or
    none), cout 12 (2-byte stores), cout past one 32-channel pass, and z
    chunks of one plane, three, and the whole depth: within one bf16 ulp
    at scale of the plain version; on integer-valued inputs, whose sums
    are exact in any order, equal to it."""
    from pulpo_tpu_torch.kernels import conv_narrow

    rng = np.random.default_rng(sum(shape) + cin + cout)
    for tz in (1, 3, shape[1]):
        monkeypatch.setattr(conv_narrow, "_launch_plan", lambda *a, tz=tz: conv_narrow.plan_arg(
            dict(conv_narrow.tile_plan(*a), tz=tz, chunks=-(-a[1] // tz))))
        for integer in (False, True):
            if integer:
                x = torch.from_numpy(rng.integers(-3, 4, (*shape, cin)).astype(np.float32))
                w = torch.from_numpy(rng.integers(-3, 4, (cout, cin, 3, 3, 3)).astype(np.float32))
            else:
                x = torch.from_numpy(rng.standard_normal((*shape, cin)).astype(np.float32))
                w = _narrow_weight(cin, cout, cin + cout)
            x = x.to(cuda_device).to(torch.bfloat16)
            w = w.to(cuda_device)
            with torch.no_grad():
                got = conv_narrow.conv_narrow(x, w)
                ref = conv_narrow.conv_narrow_plain(x, w)
            if integer:
                assert torch.equal(got, ref)
            else:
                scale = max(1.0, float(ref.float().abs().max()))
                torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                           atol=_bf16_ulp(scale))


def test_conv_narrow_gradient_matches_plain(cuda_device):
    """dx and dW through `NarrowConv` (the library conv backward) against
    the plain version's autograd, float32, 1e-5 of scale; dx only when
    asked for."""
    from pulpo_tpu_torch.kernels import conv_narrow

    x = torch.randn((2, 10, 12, 14, 3), device=cuda_device)
    w = _narrow_weight(3, 32, 94).to(cuda_device)
    g = torch.randn((2, 10, 12, 14, 32), device=cuda_device)
    for fn_x in (True, False):
        grads = []
        for fn in (conv_narrow.conv_narrow, conv_narrow.conv_narrow_plain):
            xs, ws = x.clone().requires_grad_(fn_x), w.clone().requires_grad_(True)
            grads.append(torch.autograd.grad((fn(xs, ws) * g).sum(),
                                             (xs, ws) if fn_x else (ws,)))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin", [2, 3])
def test_conv_narrow_at_an_output_channel_slice(cuda_device, dtype, cin):
    """#12 at cout 16, each half of a 32-channel weight, as the training
    step under the output-channel split at model 2 launches it
    (parallel/tp.py): one launch each, against the matching channels of
    the whole 32-channel launch and against the plain version; bit-equal
    to both in f32, within one bf16 ulp at scale of both in bf16."""
    from pulpo_tpu_torch.kernels import conv_narrow

    w = _narrow_weight(cin, 32, 200 + cin).to(cuda_device)
    x = torch.randn((1, 12, 20, 45, cin), device=cuda_device).to(dtype)
    with torch.no_grad():
        whole = conv_narrow.conv_narrow(x, w)
        for r in range(2):
            ws = w[16 * r:16 * (r + 1)]
            before = conv_narrow.launches
            got = conv_narrow.conv_narrow(x, ws)
            torch.cuda.synchronize()
            assert conv_narrow.launches == before + 1 and got.shape == (1, 12, 20, 45, 16)
            for ref in (whole[..., 16 * r:16 * (r + 1)], conv_narrow.conv_narrow_plain(x, ws)):
                if dtype == torch.float32:
                    assert torch.equal(got, ref)
                else:
                    scale = max(1.0, float(ref.float().abs().max()))
                    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                               atol=_bf16_ulp(scale))


def test_conv_narrow_raises_for_shapes_it_does_not_take(cuda_device):
    from pulpo_tpu_torch.kernels import conv_narrow

    w5 = _narrow_weight(5, 8, 95).to(cuda_device)
    with pytest.raises(ValueError):
        conv_narrow.conv_narrow(torch.zeros((1, 4, 4, 4, 5), device=cuda_device), w5)
    w = _narrow_weight(2, 8, 96).to(cuda_device)
    with pytest.raises(TypeError):
        conv_narrow.conv_narrow(torch.zeros((1, 4, 4, 4, 2), device=cuda_device).half(), w)


def test_train_step_runs_the_narrow_conv(cuda_device):
    """A small training step on the card launches the narrow conv once
    for each narrow down-block input and each velocity head."""
    from chip_smoke import train_narrow_launches
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import conv_narrow
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train.step import compute_grads

    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8,
                      batch_size=1)
    model = PULPoModel(cfg, device=cuda_device)
    model.init(5)
    rng = np.random.default_rng(2)
    batch = {k: rng.random((1, *cfg.input_size, 1), dtype=np.float32) for k in ("x", "y")}
    before = conv_narrow.launches
    compute_grads(model, batch)
    torch.cuda.synchronize()
    assert conv_narrow.launches - before == train_narrow_launches(cfg) == 1 + cfg.latent_levels


# ----------------------------------------------------------------------
# the 2D configuration: the 2D instantiations of squaring.cu, warp.cu
# and box_sum.cu, each bit-equal to its plain version
# ----------------------------------------------------------------------

def _permuted_2d(v):
    return v.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


@pytest.mark.parametrize("mag", [0.3, 4.0, 20.0])
def test_2d_squaring_kernel_bit_equal_to_plain(cuda_device, mag):
    v = _field((6, 40, 48, 2), mag, 40).to(cuda_device)
    before, before_3d = squaring.launches_2d, squaring.launches
    step = squaring.squaring_step(v)
    got = squaring.integrate_svf(v, 7)
    torch.cuda.synchronize()
    assert squaring.launches_2d == before + 8 and squaring.launches == before_3d
    torch.testing.assert_close(step, squaring.squaring_step_plain(v), rtol=0, atol=0)
    ref = squaring.integrate_svf_plain(v, 7)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(squaring.integrate_svf(_permuted_2d(v), 7), ref, rtol=0, atol=0)


@pytest.mark.parametrize("c", [1, 2])
def test_2d_warp_kernel_bit_equal_to_plain(cuda_device, c):
    rng = np.random.default_rng(41)
    m = torch.from_numpy(rng.random((2, 40, 48, c), dtype=np.float32)).to(cuda_device)
    before, before_3d = warp.launches_2d, warp.launches
    for d in (_field((6, 40, 48, 2), 3.0, 42), _field((4, 20, 24, 2), 2.0, 43),
              _field((2, 33, 47, 2), 30.0, 44)):  # same size, cross-res, ragged and clamped
        d = d.to(cuda_device)
        got = warp.warp(m, d)
        torch.testing.assert_close(got, warp.warp_plain(m, d), rtol=0, atol=0)
        torch.testing.assert_close(warp.warp(m, _permuted_2d(d)), got, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert warp.launches_2d == before + 6 and warp.launches == before_3d


@pytest.mark.parametrize("win", [3, 5, 7, 9])
def test_2d_box_sum_kernel_bit_equal_to_plain(cuda_device, win):
    x = torch.rand((2, 37, 45), device=cuda_device).requires_grad_(True)  # ragged
    g = torch.randn((2, 37, 45), device=cuda_device)
    before, before_3d = box_sum.launches_2d, box_sum.launches
    got = box_sum.box_sum(x, win)
    (gx,) = torch.autograd.grad(got, x, g)  # self-adjoint: the same kernel on g
    torch.cuda.synchronize()
    assert box_sum.launches_2d == before + 2 and box_sum.launches == before_3d
    torch.testing.assert_close(got, box_sum.box_sum_plain(x.detach(), win), rtol=0, atol=0)
    torch.testing.assert_close(gx, box_sum.box_sum_plain(g, win), rtol=0, atol=0)


def test_2d_gradients_are_the_plain_versions(cuda_device):
    """A 2D warp and integration on the card are differentiated as their
    plain versions (the JAX package's 2D backward is XLA's VJP): the
    gradients equal autograd through the plain versions on the card
    within 1e-5 of scale (the forward is bit-equal; the replay sums in
    autograd's order), and no backward kernel launches."""
    rng = np.random.default_rng(45)
    m = torch.from_numpy(rng.random((2, 24, 28, 1), dtype=np.float32))
    d = _field((4, 24, 28, 2), 3.0, 46)
    cot = torch.from_numpy(rng.standard_normal((4, 24, 28, 1)).astype(np.float32))
    bwd = (warp.dfgrad_launches, warp.mgrad_launches, squaring.bwd_launches)
    for ref, got in zip(_grads_on(cuda_device, warp.warp_plain, (m, d), cot),
                        _grads_on(cuda_device, warp.warp, (m, d), cot)):
        _close_scaled(got, ref, 1e-5)
    v = _field((2, 24, 28, 2), 6.0, 47)
    cot = torch.from_numpy(rng.standard_normal((2, 24, 28, 2)).astype(np.float32))
    (ref,) = _grads_on(cuda_device, lambda a: squaring.integrate_svf_plain(a, 7), (v,), cot)
    (got,) = _grads_on(cuda_device, lambda a: squaring.integrate_svf(a, 7), (v,), cot)
    torch.cuda.synchronize()
    _close_scaled(got, ref, 1e-5)
    assert (warp.dfgrad_launches, warp.mgrad_launches, squaring.bwd_launches) == bwd


def test_3d_launch_counts_are_not_the_2d_counters(cuda_device):
    """A 3D warp, integration and box sum count in the 3D counters only."""
    v = _field((1, 12, 14, 16, 3), 2.0, 48).to(cuda_device)
    img = torch.rand((1, 12, 14, 16, 1), device=cuda_device)
    counts = lambda: (warp.launches, squaring.launches, box_sum.launches,
                      warp.launches_2d, squaring.launches_2d, box_sum.launches_2d)
    before = counts()
    warp.warp(img, v)
    squaring.integrate_svf(v, 7)
    box_sum.box_sum(img[..., 0], 5)
    torch.cuda.synchronize()
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [1, 7, 1, 0, 0, 0]


def test_2d_kernels_raise_for_shapes_they_do_not_take(cuda_device):
    with pytest.raises(ValueError):
        squaring.squaring_step(torch.zeros((1, 8, 8, 3), device=cuda_device))
    with pytest.raises(ValueError):
        warp.warp(torch.zeros((1, 8, 8, 1), device=cuda_device),
                  torch.zeros((1, 8, 8, 8, 3), device=cuda_device))
    with pytest.raises(ValueError):
        box_sum.box_sum(torch.zeros((1, 8, 8), device=cuda_device, dtype=torch.float64), 3)


@pytest.mark.parametrize("check", ["uq", "train"])
def test_2d_small_paths_on_the_card_match_the_cpu(cuda_device, check):
    """Phase 4c of chip_smoke.py: a small 2D UQ request and train step on
    the card against the CPU (1e-3 of scale)."""
    from chip_smoke import check_small_reference, check_small_train

    (check_small_reference if check == "uq" else check_small_train)(cuda_device, size=(32, 40))


# ----------------------------------------------------------------------
# the tensor-core tilings of the velocity head and the conv unit
# ----------------------------------------------------------------------

# ragged bricks in every axis and across the row boundary (R = 3)
TC_SHAPES = [(3, 13, 18, 21), (1, 5, 3, 40), (2, 9, 8, 33)]


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 0.02)])
@pytest.mark.parametrize("shape", TC_SHAPES)
@pytest.mark.parametrize("n0", [8, 32, 64])
def test_vel_head_bricks_match_plain(cuda_device, dtype, rel, shape, n0):
    """Every width template (n0 8 -> 16, 32, 64: resident and streamed
    conv2 weights) on bricks cut by every edge; a permuted-memory input
    gives the same output."""
    p = {k: v.to(cuda_device) for k, v in _head_params(n0, seed=n0).items()}
    z = torch.randn((*shape, 3), device=cuda_device).to(dtype)
    before = vel_head.launches
    got = vel_head.velocity_head(z, p)
    torch.cuda.synchronize()
    assert vel_head.launches == before + 1
    _close_scaled(got.float(), vel_head.velocity_head_plain(z, p).float(), rel)
    assert torch.equal(vel_head.velocity_head(_permuted(z), p), got)


def _unit_params(cin, cout, seed, device):
    rng = np.random.default_rng(seed)
    r = lambda shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s)
                                              .astype(np.float32)).to(device)
    return {"k": r((cout, cin, 3, 3, 3), 1.0 / np.sqrt(27 * cin)), "b": r((cout,), 0.1),
            "mean": r((cout,), 0.3), "var": r((cout,)).abs() + 0.2,
            "scale": r((cout,)) + 1.0, "bias": r((cout,), 0.2)}


@pytest.mark.parametrize("dtype,rel", EVAL_TOL)
@pytest.mark.parametrize("cin,cout", [(2, 32), (15, 3), (16, 16), (16, 64), (96, 96),
                                      (40, 192), (128, 128)])
def test_conv_unit_modes_match_plain(cuda_device, dtype, rel, cin, cout):
    """One unit in each mode at every padded width (cout 3 .. 192, the
    scalar and 16-byte stores), narrow and ragged input widths (padded to
    the 16-channel K step), R = 6 rows over ragged bricks, UNIT_ADD with
    b_pair 3, a permuted-memory input."""
    from pulpo_tpu_torch.kernels import conv_unit as cu

    u = _unit_params(cin, cout, cin * 1000 + cout, cuda_device)
    x = torch.randn((6, 9, 13, 18, cin), device=cuda_device).to(dtype)
    y2 = torch.randn((3, 9, 13, 18, cout), device=cuda_device).to(dtype)
    _close_scaled(cu.launch(_permuted(x), u).float(), cu.unit_plain(x, u).float(), rel)
    _close_scaled(cu.launch(x, u, cu.UNIT_ADD, y2=y2).float(),
                  cu.unit_plain(x, u, y2).float(), rel)
    rng = np.random.default_rng(cout)
    heads = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32)).to(cuda_device)
             for s in ((3, cout, 1, 1, 1), (3,), (3, cout, 1, 1, 1), (3,))]
    got = cu.launch(x, u, cu.UNIT_HEADS, heads=tuple(heads))
    ref = cu.heads_plain(cu.unit_plain(x, u), *heads)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        _close_scaled(g.float(), r.float(), rel)


# ----------------------------------------------------------------------
# the gather kernels' tiles (csrc/gather.cuh): every instantiation at
# ragged sizes and misaligned bases, on both plans
# ----------------------------------------------------------------------

def _misaligned(t):
    """The same values in contiguous memory starting 4 bytes past a
    16-byte boundary: the kernels' 16-byte accesses must give way to
    their scalar path."""
    out = misaligned(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("cf_quads", [False, True])
@pytest.mark.parametrize("layout", ["cl", "cf", "2d"])
@pytest.mark.parametrize("c", [1, 3])
def test_gather_warp_instantiations_at_ragged_sizes(cuda_device, monkeypatch, layout, c,
                                                     cf_quads):
    """The warp's CL, CF and 2D instantiations at 13x17x19 (2D 13x17),
    C = 1 and 3, 2 moving rows read as r % 2 by 6 df rows, displacements
    past the tiles, the CF one at 1 and (`cf_quads`) 4 voxels a thread:
    bit-equal to the plain version, CF to CL, a permuted df and a
    misaligned base to the contiguous aligned call, one launch per call."""
    from pulpo_tpu_torch.kernels import gather

    monkeypatch.setattr(gather, "WARP_CF_QUADS_FROM", 0 if cf_quads else 2**62)
    size = (13, 17) if layout == "2d" else (13, 17, 19)
    nd = len(size)
    rng = np.random.default_rng(60 + c)
    m = torch.from_numpy(rng.random((2, *size, c), dtype=np.float32)).to(cuda_device)
    d = _field((6, *size, nd), 7.0, 61).to(cuda_device)
    ref = warp.warp_plain(m, d)
    counter = "cf_launches" if layout == "cf" else ("launches_2d" if nd == 2 else "launches")
    before = getattr(warp, counter)
    if layout == "cf":  # CF tensors in, the output viewed channels-last
        to = lambda t: t.movedim(-1, 1).contiguous()
        call = lambda mm, dd: warp.warp_cf(mm, dd).movedim(1, -1)
        perm = d.movedim(-1, 1)  # CF shape over channels-last memory
    else:
        to, call = (lambda t: t), warp.warp
        perm = d.movedim(-1, 1).contiguous().movedim(1, -1)
    got = call(to(m), to(d))
    torch.cuda.synchronize()
    assert getattr(warp, counter) == before + 1
    assert torch.equal(got, ref)
    assert torch.equal(call(to(m), perm), got)
    assert torch.equal(call(_misaligned(to(m)), _misaligned(to(d))), got)
    if layout == "cf":
        assert torch.equal(got, warp.warp(m, d))
    assert getattr(warp, counter) == before + 3


@pytest.mark.parametrize("layout", ["cl", "cf", "2d"])
@pytest.mark.parametrize("mag", [0.8, 4.0, 30.0])
def test_gather_squaring_instantiations_at_ragged_sizes(cuda_device, layout, mag):
    """The squaring step's CL, CF and 2D instantiations at 13x17x19 (2D
    13x17), sub-voxel and past the tile: one step bit-equal to the plain
    version, CF to CL, a permuted and a misaligned field to the
    contiguous aligned one; a 7-step integration bit-equal to the plain
    one; one launch a step."""
    size = (13, 17) if layout == "2d" else (13, 17, 19)
    nd = len(size)
    v = _field((3, *size, nd), mag, 62).to(cuda_device)
    ref = squaring.squaring_step_plain(v * 0.5)
    counter = "cf_launches" if layout == "cf" else ("launches_2d" if nd == 2 else "launches")
    before = getattr(squaring, counter)
    if layout == "cf":
        step = lambda a: squaring.squaring_step_cf(a.movedim(-1, 1).contiguous(),
                                                    scale=0.5).movedim(1, -1)
        integ = lambda a: squaring.integrate_svf_cf(a.movedim(-1, 1).contiguous(), 7).movedim(1, -1)
    else:
        step = lambda a: squaring.squaring_step(a.contiguous(), scale=0.5)
        integ = lambda a: squaring.integrate_svf(a, 7)
    got = step(v)
    torch.cuda.synchronize()
    assert getattr(squaring, counter) == before + 1
    assert torch.equal(got, ref)
    if layout == "cf":
        assert torch.equal(got, squaring.squaring_step(v, scale=0.5))
    else:
        perm = v.movedim(-1, 1).contiguous().movedim(1, -1)
        assert torch.equal(squaring.squaring_step(perm, scale=0.5), got)
        out = _misaligned(torch.empty_like(v))
        assert torch.equal(squaring.squaring_step(_misaligned(v), out, scale=0.5), got)
    before = getattr(squaring, counter)
    assert torch.equal(integ(v), squaring.integrate_svf_plain(v, 7))
    assert getattr(squaring, counter) == before + 7


@pytest.mark.parametrize("bad", [{"tiles_y": 1}, {"v": 4}, {"v": 2}])
def test_gather_entry_refuses_a_plan_it_cannot_walk(cuda_device, monkeypatch, bad):
    """A plan whose tiles miss part of the output, or quads on a
    channels-last warp, is refused at the C entry point (gather::valid),
    not launched."""
    from pulpo_tpu_torch.kernels import gather

    real = gather.warp_plan
    monkeypatch.setattr(gather, "warp_plan", lambda *a, **k: dict(real(*a, **k), **bad))
    m = torch.rand((1, 13, 17, 19, 1), device=cuda_device)
    d = _field((2, 13, 17, 19, 3), 2.0, 63).to(cuda_device)
    before = warp.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        warp.warp(m, d)
    assert warp.launches == before


# ----------------------------------------------------------------------
# the segmentation path: the warp and its df-cotangent at the 36 one-hot
# channels of the OASIS maps, and a remat step
# ----------------------------------------------------------------------

def _onehot(shape, classes, seed):
    labels = np.random.default_rng(seed).integers(0, classes, shape)
    return torch.from_numpy(np.eye(classes, dtype=np.float32)[labels])


@pytest.mark.parametrize("moving,df", [((2, 20, 24, 28), (4, 20, 24, 28)),
                                       ((1, 10, 12, 14), (1, 10, 12, 14)),
                                       ((1, 40, 48, 56), (2, 20, 24, 28))])
def test_warp_kernels_at_36_channels(cuda_device, moving, df):
    """#4 at C = 36 bit-equal to its plain version (the channel body: 9
    threads a voxel, each a 16-byte quad of its channels, each channel's
    operations in the plain version's order); #6 within 1e-5 of scale
    (one voxel a thread, its channels in 16-byte chunks, each corner's 36
    products added in channel order; the plain version's channel `sum`
    adds in its own order on the card); one launch each."""
    seg = _onehot(moving, 36, 60).to(cuda_device)
    d = _field((*df, 3), 3.0, 61).to(cuda_device)
    g = torch.from_numpy(np.random.default_rng(62).standard_normal(
        (*df, 36)).astype(np.float32)).to(cuda_device)
    before = (warp.launches, warp.dfgrad_launches)
    got, gd = warp.warp(seg, d), warp.warp_dfgrad(seg, d, g)
    torch.cuda.synchronize()
    assert (warp.launches, warp.dfgrad_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, warp.warp_plain(seg, d), rtol=0, atol=0)
    ref = warp.warp_dfgrad_plain(seg, d, g)
    torch.testing.assert_close(gd, ref, rtol=0, atol=1e-5 * max(1.0, float(ref.abs().max())))


def _channel_case(case, dev):
    """(moving, df, g, the plan's ch) of a channel-body case."""
    rng = np.random.default_rng(70)
    moving, df, c = {"c36": ((1, 18, 20, 30), (1, 18, 20, 30), 36),
                     "c5": ((2, 13, 17, 19), (4, 13, 17, 19), 5),
                     "misaligned": ((1, 18, 20, 30), (1, 18, 20, 30), 36),
                     "rows10": ((1, 12, 14, 30), (10, 12, 14, 30), 36),
                     "cross_res": ((1, 24, 28, 32), (2, 12, 14, 16), 36),
                     "c132": ((1, 6, 7, 9), (2, 6, 7, 9), 132)}[case]
    m = _onehot(moving, c, 71).to(dev)
    if case == "misaligned":
        m = _misaligned(m)
    d = _field((*df, 3), 3.0, 72).to(dev)
    g = torch.from_numpy(rng.standard_normal((*df, c)).astype(np.float32)).to(dev)
    if case == "misaligned":
        g = _misaligned(g)
    return m, d, g, 4 if c % 4 == 0 and case != "misaligned" else 1


@pytest.mark.parametrize("blocks", [None, 1])
@pytest.mark.parametrize("case", ["c36", "c5", "misaligned", "rows10", "cross_res", "c132"])
def test_channel_bodies_match_plain(cuda_device, monkeypatch, case, blocks):
    """The channel bodies of #4 (kernels/gather.py:channel_plan): 16-byte
    quads at C = 36 and 132 (past a warp's 32 lanes, so a lane takes
    several chunks); single channels at C = 5 and on a moving map (and
    cotangent) that start 4 bytes past a 16-byte boundary. #6 (one voxel
    a thread) takes 16-byte quads at C = 36 and a loop over single
    channels in the other cases. Also 10 df rows reading one
    moving row; a moving map of another size than the df; with the
    launch's own plans and (`blocks` 1) with tiles of up to 8 lines and
    one group of all df rows. The forward bit-equal to its plain version,
    the df-cotangent within 1e-5 of scale and the same from one launch to
    the next; one launch each."""
    from pulpo_tpu_torch.kernels import gather

    if blocks is not None:
        monkeypatch.setattr(gather, "TARGET_BLOCKS", blocks)
    m, d, g, ch = _channel_case(case, cuda_device)
    plan = warp.tile_plan(m.shape, d.shape, is_aligned=gather.aligned(m, g))
    lines = 1 << (min(gather.LINES, d.shape[2]).bit_length() - 1)
    assert plan["ch"] == ch and (blocks is None or plan["ty"] == lines)
    before = (warp.launches, warp.dfgrad_launches)
    got, gd = warp.warp(m, d), warp.warp_dfgrad(m, d, g)
    torch.cuda.synchronize()
    assert (warp.launches, warp.dfgrad_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, warp.warp_plain(m, d), rtol=0, atol=0)
    _close_scaled(gd, warp.warp_dfgrad_plain(m, d, g), 1e-5)
    assert torch.equal(warp.warp_dfgrad(m, d, g), gd)


def test_channel_body_refuses_a_plan_it_cannot_walk(cuda_device, monkeypatch):
    """A quad plan (ch = 4) on a moving map 4 bytes past a 16-byte
    boundary is refused at the forward's C entry, not launched (the
    wrapper chooses single channels there); the df-cotangent refuses a
    channel plan (it walks the voxel plan and takes its chunk width from
    the pointers)."""
    from pulpo_tpu_torch.kernels import gather

    m, d, g, _ = _channel_case("misaligned", cuda_device)
    monkeypatch.setattr(gather, "aligned", lambda *t: True)
    before = (warp.launches, warp.dfgrad_launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        warp.warp(m, d)
    monkeypatch.setattr(warp, "dfgrad_plan", warp.tile_plan)
    with pytest.raises(RuntimeError, match="CUDA error"):
        warp.warp_dfgrad(m, d, g)
    assert (warp.launches, warp.dfgrad_launches) == before


@pytest.mark.parametrize("misaligned_map", [False, True])
def test_2d_channel_body_at_36_channels(cuda_device, misaligned_map):
    """The 2D warp's channel body at C = 36 over 10 rows, quads and (a map
    off a 16-byte boundary) single channels: bit-equal to its plain
    version."""
    seg = _onehot((1, 40, 48), 36, 65).to(cuda_device).repeat_interleave(10, 0)
    if misaligned_map:
        seg = _misaligned(seg)
    d = _field((10, 40, 48, 2), 3.0, 66).to(cuda_device)
    torch.testing.assert_close(warp.warp(seg, d), warp.warp_plain(seg, d), rtol=0, atol=0)


def test_2d_warp_at_36_channels(cuda_device):
    """The 2D warp of 10 per-sample one-hot maps (`Evaluate.predict`'s 2D
    segmentations), bit-equal to its plain version."""
    seg = _onehot((1, 40, 48), 36, 63).to(cuda_device).repeat_interleave(10, 0)
    d = _field((10, 40, 48, 2), 3.0, 64).to(cuda_device)
    before = warp.launches_2d
    got = warp.warp(seg, d)
    torch.cuda.synchronize()
    assert warp.launches_2d == before + 1
    torch.testing.assert_close(got, warp.warp_plain(seg, d), rtol=0, atol=0)


def test_remat_step_on_the_card_matches_the_plain_step(cuda_device):
    """A segmentation step (NCC + Dice) under `remat_down=(0,)` and
    `remat` against the plain step: the loss and the BatchNorm statistics
    equal (the forward has no atomics), the gradients no further from
    the plain step's (relative L2 over the network) than a second plain
    step's are (twice that, or 1e-5: the squaring backward's float
    atomics), and the narrow conv launched again for each recomputed
    region."""
    from chip_smoke import grad_spread, remat_launches
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import conv_narrow
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train.step import compute_grads

    kw = dict(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8, batch_size=2,
              segs=True, recon_loss=("ncc", "dice"))
    rng = np.random.default_rng(65)
    batch = {k: rng.random((2, 24, 28, 32, 1), dtype=np.float32) for k in ("x", "y")}
    batch["seg_x"], batch["seg_y"] = (_onehot((2, 24, 28, 32), 36, s).numpy() for s in (66, 67))
    out = {}
    for name, knob in (("plain", {}), ("plain again", {}), ("remat_down", {"remat_down": (0,)}),
                       ("remat", {"remat": True})):
        cfg = PULPoConfig(**kw, **knob)
        model = PULPoModel(cfg, device=cuda_device)
        model.init(6)
        before = conv_narrow.launches
        grads, stats, metrics = compute_grads(model, batch, seed=7)
        torch.cuda.synchronize()
        extra = remat_launches(cfg, 1)["conv_narrow"]
        assert conv_narrow.launches - before == 1 + cfg.latent_levels + extra
        out[name] = grads, stats, float(metrics["total_loss"])
    ref_grads, ref_stats, ref_loss = out["plain"]
    spread = grad_spread(out["plain again"][0], ref_grads)[0]
    for name in ("remat_down", "remat"):
        grads, stats, loss = out[name]
        assert loss == ref_loss
        rel = grad_spread(grads, ref_grads)
        assert rel[0] <= max(2 * spread, 1e-5), (name, rel, spread)
        for n, v in stats.items():
            assert torch.equal(v, ref_stats[n]), (name, n)


# ----------------------------------------------------------------------
# the DIF-VoxelMorph baseline and the figures
# ----------------------------------------------------------------------

def _vxm_pair(size, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((1, *size, 1), dtype=np.float32),
            rng.random((1, *size, 1), dtype=np.float32))


def _rel(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def test_vxm_forward_and_predict_on_the_card_match_the_cpu(cuda_device):
    """The same weights and draws on the card (the narrow conv, squaring
    and warp kernels) and on the CPU (plain versions): every output
    within 1e-5 of its scale."""
    from pulpo_tpu_torch.kernels import conv_narrow
    from pulpo_tpu_torch.models.voxelmorph import VxmModel

    size = (24, 28, 32)
    models = {dev: VxmModel(size, device=dev) for dev in ("cpu", cuda_device)}
    models["cpu"].init(3)
    models[cuda_device].load_state_dict(models["cpu"].state_dict())
    x, y = _vxm_pair(size, 4)
    eps = torch.randn((5, 1, 12, 14, 16, 3), generator=torch.Generator().manual_seed(5))
    before = (conv_narrow.launches, squaring.launches, warp.launches)
    out = {dev: (m.apply(x, y, deterministic=True), m.predict(x, y, 5, eps=eps))
           for dev, m in models.items()}
    torch.cuda.synchronize()
    # two forwards: one narrow conv, 7 squaring steps and one warp each
    assert (conv_narrow.launches, squaring.launches, warp.launches) == (
        before[0] + 2, before[1] + 14, before[2] + 2)
    (det_c, pred_c), (det_g, pred_g) = out["cpu"], out[cuda_device]
    for g, r in zip((*det_g[:2], *det_g[2][:2], *pred_g), (*det_c[:2], *det_c[2][:2], *pred_c)):
        assert g.device.type == "cuda" and _rel(g, r) <= 1e-5


def test_conv_narrow_2_to_16_f32_matches_plain(cuda_device):
    """The VoxelMorph's first conv (2 -> 16 at the input size, float32) on
    the narrow-conv kernel: bit-equal to its plain version (the f32 body
    sums in the plain version's order), also from permuted memory."""
    from pulpo_tpu_torch.kernels import conv_narrow

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((1, 20, 24, 28, 2), dtype=np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.standard_normal((16, 2, 3, 3, 3)).astype(np.float32) * 0.2)
    w = w.to(cuda_device)
    before = conv_narrow.launches
    got = conv_narrow.conv_narrow(x, w)
    assert conv_narrow.launches == before + 1 and got.shape == (1, 20, 24, 28, 16)
    torch.testing.assert_close(got, conv_narrow.conv_narrow_plain(x, w), rtol=0, atol=0)
    torch.testing.assert_close(conv_narrow.conv_narrow(_permuted(x), w), got, rtol=0, atol=0)


def test_vxm_train_step_gradients_on_the_card_match_the_cpu(cuda_device):
    """One VoxelMorph-diff loss and its gradients on the card (the
    squaring backward and the warp's df-cotangent kernels) against the
    CPU's plain backward on the same weights and draw: the loss rtol
    1e-5, each leaf within 1e-5 of its scale."""
    from pulpo_tpu_torch.models.voxelmorph import VxmModel, vxm_grads

    size = (24, 28, 32)
    x, y = _vxm_pair(size, 8)
    eps = torch.randn((1, 12, 14, 16, 3), generator=torch.Generator().manual_seed(9))
    res = {}
    for dev in ("cpu", cuda_device):
        m = VxmModel(size, device=dev)
        m.init(2)
        before = (squaring.bwd_launches, warp.dfgrad_launches)
        res[str(dev)] = vxm_grads(m, {"x": x, "y": y}, eps.to(m.device))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (squaring.bwd_launches, warp.dfgrad_launches) == (before[0] + 7, before[1] + 1)
    (g_ref, m_ref), (g_got, m_got) = res["cpu"], res[str(cuda_device)]
    np.testing.assert_allclose(float(m_got["total_loss"]), float(m_ref["total_loss"]), rtol=1e-5)
    for name, g in g_got.items():
        assert _rel(g, g_ref[name]) <= 1e-5, name


def test_run_one_model_writes_the_figures_on_the_card(cuda_device, tmp_path):
    """`Evaluate.run_one_model(visualize=True)` on a small 2D synthetic
    task on the card: each loader's three figures as `.npz` panels with
    finite images (a `.png` only where matplotlib is installed) and the
    JDet tables."""
    import importlib.util

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.eval import visualize as vis
    from pulpo_tpu_torch.eval.evaluator import Evaluate
    from pulpo_tpu_torch.models import PULPoModel

    cfg = PULPoConfig(input_size=(32, 40), total_levels=5, latent_levels=4, n0=8)
    model = PULPoModel(cfg, device=cuda_device)
    model.init(0)
    ev = Evaluate(device=cuda_device)
    ev.set_model(model, tmp_path)
    before = warp.launches_2d
    perf, _ = ev.run_one_model(segs=True, N=3, task="synthetic", visualize=True)
    assert warp.launches_2d > before and np.isfinite(perf[("val", "Dice")]).all()
    png = importlib.util.find_spec("matplotlib") is not None
    for loader in ("train", "val", "test"):
        for pred in ("deterministic", "sample", "avg_3"):
            p = vis.load_panels(tmp_path / "vis" / f"allvis{loader}_{pred}.npz")
            assert p.rows == len(vis.default_visualizations(True, pred == "avg_3",
                                                            pred == "avg_3")[0])
            assert all(a.image is None or np.isfinite(a.image.astype(np.float64)).all()
                       for row in p.axes for a in row)
            assert (tmp_path / "vis" / f"allvis{loader}_{pred}.png").exists() == png
            assert (tmp_path / "jdet" / f"jdet_{loader}_{pred}.csv").exists()


# ----------------------------------------------------------------------
# ingest and the data-parallel step
# ----------------------------------------------------------------------

def test_ingest_on_the_card_matches_the_cpu(cuda_device):
    """`data/ingest.ingest` (resample and each normalisation) on the
    card against its CPU run on the same raw batch, within 1e-5 of
    scale."""
    from pulpo_tpu_torch.data.ingest import ingest

    raw = np.random.default_rng(70).gamma(2.0, 300.0, (2, 40, 48, 36, 1)).astype(np.float32)
    for target, normalize in (((24, 32, 28), "znorm"), ((24, 32, 28), "minmax"),
                              (None, "znorm"), ((48, 40, 44), "none")):
        ref = ingest(raw, target=target, normalize=normalize, device="cpu")
        got = ingest(raw, target=target, normalize=normalize)
        assert got.device.type == "cuda" and got.shape == ref.shape
        scale = float(ref.abs().max())
        assert float((got.cpu() - ref).abs().max()) <= 1e-5 * scale, (target, normalize)


def test_dp_step_at_world_size_1_over_nccl_matches_the_plain_step(cuda_device):
    """`make_dp_train_step` over NCCL at world size 1 against
    `make_train_step` on the same weights, batch and draws, with cuDNN
    deterministic: the losses and BatchNorm statistics equal bit for
    bit, the gradients within the plain step's own run-to-run spread
    (twice it, or 1e-5 relative L2: #2's float32 atomics), and the
    weights after one step of each within 2 * lr (Adam's first step is
    lr * sign(g))."""
    import socket

    from chip_smoke import grad_spread
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.parallel import multihost
    from pulpo_tpu_torch.parallel.dp import make_dp_train_step, replicate_state
    from pulpo_tpu_torch.parallel.mesh import make_mesh
    from pulpo_tpu_torch.train import create_train_state, make_train_step
    from pulpo_tpu_torch.train.step import compute_grads, dp_compute_grads

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8,
                      batch_size=2)
    rng = np.random.default_rng(71)
    batch = {k: torch.from_numpy(rng.random((2, 24, 28, 32, 1), dtype=np.float32)).to(cuda_device)
             for k in ("x", "y")}
    noise = {l: torch.from_numpy(rng.standard_normal((2, *cfg.level_sizes[l], cfg.zdim),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    assert multihost.initialize(f"tcp://localhost:{port}", 1, 0, device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = make_mesh(1)
        model = PULPoModel(cfg, device=cuda_device)
        model.init(8)
        ref = compute_grads(model, batch, noise=noise)
        again = compute_grads(model, batch, noise=noise)
        got = dp_compute_grads(model, batch, mesh, noise=noise)
        for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
            assert float(got[2][k]) == float(ref[2][k]), k
        for n, v in ref[1].items():
            assert torch.equal(got[1][n], v), n
        spread = grad_spread(again[0], ref[0])[0]
        assert grad_spread(got[0], ref[0])[0] <= max(2 * spread, 1e-5)

        after = {}
        for name in ("plain", "dp"):
            m = PULPoModel(cfg, device=cuda_device)
            state, tx = create_train_state(m, seed=8)
            if name == "dp":
                replicate_state(state, mesh)
                step = make_dp_train_step(m, tx, mesh)
            else:
                step = make_train_step(m, tx)
            state, metrics = step(state, batch, noise=noise)
            assert state.step == 1 and not state.nan_flag
            after[name] = m.state_dict()
        for n, v in after["plain"].items():
            atol = 1e-5 if "running_" in n else 2 * cfg.lr
            torch.testing.assert_close(after["dp"][n], v, rtol=0, atol=atol)
    finally:
        multihost.shutdown()
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.parametrize("whole,parts", [(20, 2), (16, 4), (80, 2)])
def test_slab_launches_are_bit_equal_to_the_whole_launch(cuda_device, whole, parts):
    """The slab launches of the depth-sharded model (#4 the warp and #6 its
    df-cotangent at C = 1, #1 the squaring step, #2 its backward): each
    slab bit-equal to the matching planes of the whole launch and to the
    plain version at its offset; #2's share (float32 atomics) within 1e-5
    of scale of the whole backward of the slab's cotangent, and the
    shares' sum of the whole backward."""
    rng = np.random.default_rng(31)
    size = (whole, 24, 28)
    per = whole // parts
    m = torch.from_numpy(rng.random((1, whole // 2, 12, 14, 1), dtype=np.float32)).to(cuda_device)
    df = _field((2, *size, 3), 3.0, 32).to(cuda_device)
    v = _field((1, *size, 3), 2.5, 33).to(cuda_device)
    g1 = torch.from_numpy(rng.standard_normal((2, *size, 1)).astype(np.float32)).to(cuda_device)
    g3 = torch.from_numpy(rng.standard_normal((1, *size, 3)).astype(np.float32)).to(cuda_device)
    whole_warp, whole_grad = warp.warp(m, df), warp.warp_dfgrad(m, df, g1)
    whole_step = squaring.squaring_step(v, scale=0.5)
    shares = torch.zeros_like(v)
    for r in range(parts):
        z0, sl = r * per, slice(r * per, (r + 1) * per)
        counts = (warp.launches, warp.dfgrad_launches, squaring.launches, squaring.bwd_launches)
        got = warp.warp(m, df[:, sl].contiguous(), z0, whole)
        grad = warp.warp_dfgrad(m, df[:, sl].contiguous(), g1[:, sl].contiguous(), z0, whole)
        step = squaring.squaring_step(v, scale=0.5, z0=z0, depth=per)
        share = squaring.squaring_step_bwd(v, g3[:, sl].contiguous(), z0)
        torch.cuda.synchronize()
        assert (warp.launches, warp.dfgrad_launches, squaring.launches,
                squaring.bwd_launches) == tuple(c + 1 for c in counts)
        assert torch.equal(got, whole_warp[:, sl])
        assert torch.equal(grad, whole_grad[:, sl])
        assert torch.equal(step, whole_step[:, sl])
        cpu = lambda t: t.cpu()
        assert torch.equal(got.cpu(), warp.warp_plain(cpu(m), cpu(df[:, sl]), z0, whole))
        assert torch.equal(grad.cpu(), warp.warp_dfgrad_plain(cpu(m), cpu(df[:, sl]),
                                                              cpu(g1[:, sl]), z0, whole))
        assert torch.equal(step.cpu(), squaring.squaring_step_plain(cpu(v) * 0.5, z0, per))
        masked = torch.zeros_like(g3)
        masked[:, sl] = g3[:, sl]
        ref = squaring.squaring_step_bwd(v, masked)
        assert float((share - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        shares += share
    ref = squaring.squaring_step_bwd(v, g3)
    assert float((shares - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-16-bytes"])
@pytest.mark.parametrize("whole,parts", [(20, 2), (40, 2)])
def test_slab_launches_at_36_channels_are_bit_equal_to_the_whole_launch(cuda_device, whole,
                                                                        parts, aligned):
    """The C = 36 slab launches of the Dice step's warp (#4) and its
    df-cotangent (#6) on a one-hot map: each slab bit-equal to the
    matching planes of the whole launch and to the plain version at its
    offset. A slab whose map and cotangent lie 4 bytes past a 16-byte
    boundary takes the single-channel bodies (the warp's `ch1`, the
    df-cotangent's `<0>`), an aligned one the 16-byte quads (`ch4`,
    `<36>`); both give the same bits. The df-cotangent's entry refuses
    the 16-byte body on the slab off the boundary."""
    rng = np.random.default_rng(35)
    size = (whole, 24, 28)
    per = whole // parts
    labels = rng.integers(0, 36, (1, *size))
    m = torch.from_numpy(np.eye(36, dtype=np.float32)[labels]).to(cuda_device)
    df = _field((1, *size, 3), 3.0, 36).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((1, *size, 36)).astype(np.float32)).to(cuda_device)
    whole_warp, whole_grad = warp.warp(m, df), warp.warp_dfgrad(m, df, g)
    mov = m if aligned else misaligned(m)
    bodies = (("warp", "ch4"), ("warp_dfgrad", "<36>")) if aligned else (
        ("warp", "ch1"), ("warp_dfgrad", "<0>"))
    for r in range(parts):
        z0, sl = r * per, slice(r * per, (r + 1) * per)
        d = df[:, sl].contiguous()
        c = g[:, sl].contiguous() if aligned else misaligned(g[:, sl])
        warp.slab_bodies.clear()
        got = warp.warp(mov, d, z0, whole)
        grad = warp.warp_dfgrad(mov, d, c, z0, whole)
        torch.cuda.synchronize()
        assert warp.slab_bodies == {b: 1 for b in bodies}
        assert torch.equal(got, whole_warp[:, sl])
        assert torch.equal(grad, whole_grad[:, sl])
        assert torch.equal(got.cpu(), warp.warp_plain(m.cpu(), d.cpu(), z0, whole))
        assert torch.equal(grad.cpu(), warp.warp_dfgrad_plain(m.cpu(), d.cpu(), c.cpu(), z0,
                                                              whole))
    if not aligned:
        # the entry refuses the 16-byte body on a map off the boundary
        out = torch.empty_like(d)
        with pytest.raises(RuntimeError, match="pulpo_warp_dfgrad"):
            warp._launch("warp_bwd", "pulpo_warp_dfgrad",
                         [mov.data_ptr(), d.data_ptr(), c.data_ptr(), out.data_ptr()], mov.shape,
                         d, plan=warp._slab(warp.dfgrad_plan(mov.shape, d.shape), d, z0, whole),
                         body=36)


@pytest.mark.parametrize("whole,parts", [(20, 2), (16, 4)])
def test_cf_slab_launches_are_bit_equal_to_the_whole_launch(cuda_device, whole, parts):
    """The channels-first slab launches of the sharded full_res decode (#3
    the CF squaring step, with and without the first step's scale; #8 the
    CF image warp of one moving image by 4 df rows): each slab bit-equal
    to the matching planes of the whole launch and to the plain version
    at its offset, one launch a call; at this size the warp takes the
    voxel body."""
    rng = np.random.default_rng(37)
    size = (whole, 24, 28)
    per = whole // parts
    v = _cf(_field((2, *size, 3), 2.5, 38).to(cuda_device))
    img = torch.from_numpy(rng.random((1, 1, *size), dtype=np.float32)).to(cuda_device)
    df = _cf(_field((4, *size, 3), 3.0, 39).to(cuda_device))
    for scale in (1.0 / 2**7, 1.0):
        whole_step = squaring.squaring_step_cf(v, scale=scale)
        for r in range(parts):
            z0 = r * per
            before = squaring.cf_launches
            step = squaring.squaring_step_cf(v, scale=scale, z0=z0, depth=per)
            assert squaring.cf_launches == before + 1 and step.shape == (2, 3, per, 24, 28)
            assert torch.equal(step, whole_step[:, :, z0:z0 + per])
            assert torch.equal(step.cpu(), squaring.squaring_step_cf_plain(v.cpu() * scale, z0,
                                                                           per))
    whole_warp = warp.warp_cf(img, df)
    for r in range(parts):
        z0 = r * per
        d = df[:, :, z0:z0 + per].contiguous()
        warp.slab_bodies.clear()
        before = warp.cf_launches
        got = warp.warp_cf(img, d, z0, whole)
        assert warp.cf_launches == before + 1 and warp.slab_bodies == {("warp_cf", "voxel"): 1}
        assert torch.equal(got, whole_warp[:, :, z0:z0 + per])
        assert torch.equal(got.cpu(), warp.warp_cf_plain(img.cpu(), d.cpu(), z0, whole))


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-16-bytes"])
def test_cf_warp_slab_body_follows_the_df_alignment(cuda_device, monkeypatch, aligned):
    """A CF warp slab of as many voxels as take 16-byte quads (the bound
    lowered to this size): an aligned df slab takes the quad body, one 4
    bytes past a 16-byte boundary the voxel body; both bit-equal to the
    whole launch's planes and to the plain version."""
    from pulpo_tpu_torch.kernels import gather

    monkeypatch.setattr(gather, "WARP_CF_QUADS_FROM", 1)
    rng = np.random.default_rng(40)
    size = (20, 24, 28)
    img = torch.from_numpy(rng.random((1, 1, *size), dtype=np.float32)).to(cuda_device)
    df = _cf(_field((4, *size, 3), 3.0, 41).to(cuda_device))
    whole_warp = warp.warp_cf(img, df)
    for z0 in (0, 10):
        d = df[:, :, z0:z0 + 10].contiguous()
        d = d if aligned else misaligned(d)
        warp.slab_bodies.clear()
        got = warp.warp_cf(img, d, z0, 20)
        assert warp.slab_bodies == {("warp_cf", "quad" if aligned else "voxel"): 1}
        assert torch.equal(got, whole_warp[:, :, z0:z0 + 10])
        assert torch.equal(got.cpu(), warp.warp_cf_plain(img.cpu(), d.cpu(), z0, 20))


# flagship-2d's sizes that split in two along H (sharded 2D model), in slabs of half
SLABS_2D = [((160, 192), 80), ((80, 96), 40), ((40, 48), 20), ((20, 24), 10)]
SLAB_IDS_2D = [f"{s[0]}x{s[1]}" for s, _ in SLABS_2D]


@pytest.mark.parametrize("size,per", SLABS_2D, ids=SLAB_IDS_2D)
def test_2d_squaring_slab_launches_are_bit_equal_to_the_whole_launch(cuda_device, size, per):
    """#1's 2D arm as a slab launch along H (lines z0.. of the whole 2D
    field), with and without the first step's 1/128 scale: each slab
    bit-equal to the matching lines of the whole launch and to the plain
    version at its offset, one 2D launch a call."""
    v = _field((2, *size, 2), 2.5, 42).to(cuda_device)
    for scale in (1.0 / 2**7, 1.0):
        whole = squaring.squaring_step(v, scale=scale)
        for z0 in range(0, size[0], per):
            before = squaring.launches_2d
            step = squaring.squaring_step(v, scale=scale, z0=z0, depth=per)
            torch.cuda.synchronize()
            assert squaring.launches_2d == before + 1 and step.shape == (2, per, size[1], 2)
            assert torch.equal(step, whole[:, z0:z0 + per])
            assert torch.equal(step.cpu(), squaring.squaring_step_plain(v.cpu() * scale, z0, per))


@pytest.mark.parametrize("size,per", SLABS_2D, ids=SLAB_IDS_2D)
def test_2d_warp_slab_launches_are_bit_equal_to_the_whole_launch(cuda_device, size, per):
    """The 2D warp at C = 1 as a slab launch along H (2 df rows of one
    image): each slab bit-equal to the whole launch's lines and to the
    plain version at its offset, in the voxel body, one 2D launch a
    call; its gradients the plain slab's."""
    rng = np.random.default_rng(43)
    m = torch.from_numpy(rng.random((1, *size, 1), dtype=np.float32)).to(cuda_device)
    df = _field((2, *size, 2), 3.0, 44).to(cuda_device)
    whole = warp.warp(m, df)
    for z0 in range(0, size[0], per):
        d = df[:, z0:z0 + per].contiguous().requires_grad_(True)
        warp.slab_bodies.clear()
        before = warp.launches_2d
        got = warp.warp(m, d, z0, size[0])
        torch.cuda.synchronize()
        assert warp.launches_2d == before + 1
        assert warp.slab_bodies == {("warp_2d", "voxel"): 1}
        assert torch.equal(got, whole[:, z0:z0 + per])
        assert torch.equal(got.detach().cpu(), warp.warp_plain(m.cpu(), d.detach().cpu(), z0,
                                                               size[0]))
        g = torch.ones_like(got)
        (gd,) = torch.autograd.grad(got, d, g)
        dp = d.detach().clone().requires_grad_(True)
        (ref,) = torch.autograd.grad(warp.warp_plain(m, dp, z0, size[0]), dp, g)
        assert torch.equal(gd, ref)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-16-bytes"])
@pytest.mark.parametrize("size,per", [SLABS_2D[0], SLABS_2D[2], SLABS_2D[3]],
                         ids=[SLAB_IDS_2D[0], SLAB_IDS_2D[2], SLAB_IDS_2D[3]])
def test_2d_warp_slab_launches_at_36_channels(cuda_device, size, per, aligned):
    """The 2D Dice step's C = 36 warp of its one-hot maps as a slab launch
    along H (2 rows), at the sharded 2D OASIS shapes (160x192, 40x48,
    20x24): each slab bit-equal to the whole launch's lines and to the
    plain version at its offset; an aligned map takes the 16-byte channel
    body (`ch4`), one 4 bytes past a 16-byte boundary the single-channel
    body (`ch1`)."""
    m = _onehot((2, *size), 36, 45).to(cuda_device)
    df = _field((2, *size, 2), 3.0, 46).to(cuda_device)
    whole = warp.warp(m, df)
    mov = m if aligned else misaligned(m)
    for z0 in range(0, size[0], per):
        d = df[:, z0:z0 + per].contiguous()
        warp.slab_bodies.clear()
        got = warp.warp(mov, d, z0, size[0])
        torch.cuda.synchronize()
        assert warp.slab_bodies == {("warp_2d", "ch4" if aligned else "ch1"): 1}
        assert torch.equal(got, whole[:, z0:z0 + per])
        assert torch.equal(got.cpu(), warp.warp_plain(m.cpu(), d.cpu(), z0, size[0]))


def test_2d_entries_refuse_a_slab_past_the_whole(cuda_device):
    """The 2D entries check the slab along H (`gather::valid_slab` on the
    plan's lines): a slab that runs past the whole field is refused."""
    from pulpo_tpu_torch.kernels import gather

    v = _field((1, 20, 24, 2), 1.0, 47).to(cuda_device)
    m = torch.rand((1, 20, 24, 1), device=cuda_device)
    d = v[:, :10].contiguous()
    out = torch.empty((1, 10, 24, 1), device=cuda_device)
    with pytest.raises(RuntimeError, match="pulpo_warp_2d"):
        warp._launch("warp", "pulpo_warp_2d", [m.data_ptr(), d.data_ptr(), out.data_ptr()],
                     m.shape, d, plan=gather.slab(warp.tile_plan(m.shape, d.shape), 11, 20))
    with pytest.raises(ValueError, match="a slab"):
        squaring.squaring_step(v, z0=11, depth=10)
