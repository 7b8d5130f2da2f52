"""The eval posterior head and the narrow-input conv chain: the port's
plain versions against the JAX package's Pallas kernels (interpret
mode) and XLA compositions, on the CPU, and the model's routing.

The same numpy-made inputs and flax-layout weights go to both sides;
the weights cross through `pulpo_tpu_torch.compat`. Tolerances: float32
1e-5 of the output's scale (summation order only); bfloat16 5 % of the
scale, as the JAX package's own kernel tests hold the Pallas kernels to
their XLA compositions (an intermediate that rounds the other way moves
an output by a few bf16 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import conv_chain_stages_from_jax, pos_head_params_from_jax
from pulpo_tpu_torch.kernels import conv_chain, conv_narrow, conv_unit, plain_vjp, pos_head
from pulpo_tpu_torch.models import PULPoModel


def _unit(rng, pre, n, cin, cout):
    r = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    return {f"{pre}k{n}": r((3, 3, 3, cin, cout), 0.2), f"{pre}b{n}": r((cout,), 0.1),
            f"{pre}mean{n}": r((cout,), 0.3), f"{pre}var{n}": np.abs(r((cout,))) + 0.1,
            f"{pre}scale{n}": r((cout,)) + 1.0, f"{pre}bias{n}": r((cout,), 0.2)}


def _head_params(seed, c_fb=5, n_up=8, n_merge=8, zd=3):
    """JAX pos_head.py parameter dict (flax layout), non-trivial BN statistics."""
    rng = np.random.default_rng(seed)
    p = {}
    p.update(_unit(rng, "u", 1, c_fb, n_up))
    p.update(_unit(rng, "u", 2, n_up, n_up))
    p.update(_unit(rng, "m", 1, n_up, n_merge))
    p.update(_unit(rng, "m", 2, n_merge, n_merge))
    for h in ("mu", "sig"):
        p[f"hk{h}"] = (rng.standard_normal((1, 1, 1, n_merge, zd)) * 0.5).astype(np.float32)
        p[f"hb{h}"] = (rng.standard_normal((zd,)) * 0.1).astype(np.float32)
    return p


def _stages(seed, widths):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(widths) - 1):
        u = _unit(rng, "", 0, widths[i], widths[i + 1])
        out.append({k: u[f"{k}0"] for k in conv_unit.UNIT_KEYS})
    return out


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * scale


def _port_head(fb, y2, p, dtype=torch.float32):
    pt = {k: v for k, v in pos_head_params_from_jax(p).items()}
    return pos_head.posterior_head(torch.from_numpy(fb).to(dtype),
                                   torch.from_numpy(y2).to(dtype), pt)


# ----------------------------------------------------------------------
# kernel level
# ----------------------------------------------------------------------

def test_pos_head_plain_matches_pallas_f32_pair_broadcast():
    """R = 4 sample-major rows over B = 2 pairs: row r reads y2[r % B]."""
    from pulpo_tpu.kernels.pos_head import posterior_head_fused

    p = _head_params(31)
    fb, y2 = _inputs(32, (4, 16, 10, 12, 5), (2, 16, 10, 12, 8))
    ref = posterior_head_fused(jnp.asarray(fb), jnp.asarray(y2),
                               {k: jnp.asarray(v) for k, v in p.items()}, interpret=True)
    got = _port_head(fb, y2, p)
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-5)


def test_pos_head_plain_matches_pallas_bf16():
    from pulpo_tpu.kernels.pos_head import posterior_head_fused

    p = _head_params(33, n_up=16, n_merge=16)
    fb, y2 = _inputs(34, (2, 8, 20, 24, 5), (1, 8, 20, 24, 16))
    ref = posterior_head_fused(jnp.asarray(fb, jnp.bfloat16), jnp.asarray(y2, jnp.bfloat16),
                               {k: jnp.asarray(v) for k, v in p.items()}, interpret=True)
    got = _port_head(fb, y2, p, torch.bfloat16)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), np.asarray(r, np.float32), 0.05)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 0.05)])
def test_pos_head_plain_matches_xla_where_the_tpu_kernel_does_not_go(dtype, rel):
    """n_merge 136 > 128 and a depth of 5 (not a multiple of 8): the TPU
    guard turns this away; the port's kernel takes it."""
    from pulpo_tpu.kernels.pos_head import posterior_head_xla

    p = _head_params(35, c_fb=4, n_up=12, n_merge=136)
    fb, y2 = _inputs(36, (2, 5, 6, 7, 4), (1, 5, 6, 7, 136))
    ref = posterior_head_xla(jnp.asarray(fb, dtype), jnp.asarray(y2, dtype),
                             {k: jnp.asarray(v) for k, v in p.items()})
    got = _port_head(fb, y2, p, getattr(torch, dtype))
    for g, r in zip(got, ref):
        _close(g.float().numpy(), np.asarray(r, np.float32), rel)


def test_conv_chain_plain_matches_pallas():
    from pulpo_tpu.attic.conv_chain import conv_chain_fused

    st = _stages(51, (2, 8, 8, 8))
    (x,) = _inputs(52, (2, 16, 10, 12, 2))
    ref = conv_chain_fused(jnp.asarray(x), [{k: jnp.asarray(v) for k, v in s.items()}
                                            for s in st], interpret=True)
    got = conv_chain.conv_chain(torch.from_numpy(x), conv_chain_stages_from_jax(st))
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 0.05)])
@pytest.mark.parametrize("widths", [(2, 16, 16, 16), (3, 8, 8), (2, 8, 8, 8, 8)])
def test_conv_chain_plain_matches_xla(widths, dtype, rel):
    from pulpo_tpu.attic.conv_chain import conv_chain_xla

    st = _stages(53, widths)
    (x,) = _inputs(54, (2, 5, 7, 9, widths[0]))
    ref = conv_chain_xla(jnp.asarray(x, dtype), [{k: jnp.asarray(v) for k, v in s.items()}
                                                 for s in st])
    got = conv_chain.conv_chain(torch.from_numpy(x).to(getattr(torch, dtype)),
                                conv_chain_stages_from_jax(st))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(ref, np.float32), rel)


def test_activations_match_jax():
    """Bit-equal in bfloat16; in float32 torch's and XLA's exp and log1p
    may differ by an ulp."""
    from pulpo_tpu.kernels.activations import leaky_from_f32, softplus_dt

    (v,) = _inputs(55, (4096,))
    v = v * 8
    for dt, rtol in (("float32", 1e-6), ("bfloat16", 0.0)):
        tdt = getattr(torch, dt)
        got = conv_unit.softplus_dt(torch.from_numpy(v).to(tdt))
        ref = softplus_dt(jnp.asarray(v, dt), getattr(jnp, dt))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=rtol, atol=0)
        got = conv_unit.leaky_from_f32(torch.from_numpy(v), tdt)
        ref = leaky_from_f32(jnp.asarray(v), getattr(jnp, dt))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


# ----------------------------------------------------------------------
# predicates, gradients
# ----------------------------------------------------------------------

def test_takes_is_a_function_of_shapes_and_dtype():
    p = pos_head_params_from_jax(_head_params(1, c_fb=16, n_up=96, n_merge=192))
    fb = torch.zeros((2, 4, 5, 6, 16))
    assert pos_head.takes(fb, p) and pos_head.takes(fb.bfloat16(), p)
    assert not pos_head.takes(fb.half(), p)
    assert not pos_head.takes(torch.zeros((2, 4, 5, 6, 15)), p)
    wide = pos_head_params_from_jax(_head_params(1, c_fb=16, n_up=96, n_merge=384))
    assert not pos_head.takes(fb, wide)  # n0 = 64's n_merge
    zd4 = pos_head_params_from_jax(_head_params(1, c_fb=16, n_up=96, n_merge=64, zd=4))
    assert not pos_head.takes(fb, zd4)
    st = conv_chain_stages_from_jax(_stages(2, (2, 32, 32, 32)))
    assert conv_chain.takes(torch.zeros((1, 4, 5, 6, 2)), st)
    assert not conv_chain.takes(torch.zeros((1, 4, 5, 6, 3)), st)
    assert not conv_chain.takes(torch.zeros((1, 4, 5, 6, 16)),
                                conv_chain_stages_from_jax(_stages(2, (16, 32))))
    assert not conv_chain.takes(torch.zeros((1, 4, 5, 6, 2)),
                                conv_chain_stages_from_jax(_stages(2, (2, 256))))


def test_plain_vjp_gives_the_plain_versions_gradient():
    """The autograd Function the card's wrappers use, with the plain
    version in the kernel's place: its gradients are the plain's."""
    p = pos_head_params_from_jax(_head_params(3))
    fb, y2, g1, g2 = (torch.from_numpy(a) for a in _inputs(
        4, (2, 5, 6, 7, 5), (1, 5, 6, 7, 8), (2, 5, 6, 7, 3), (2, 5, 6, 7, 3)))
    keys = pos_head.KEYS
    leaves = [fb, y2] + [p[k] for k in keys]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    plain = lambda fb, y2, *v: pos_head.posterior_head_plain(fb, y2, dict(zip(keys, v)))
    mu, sg = plain_vjp.apply(plain, plain, *leaves)
    got = torch.autograd.grad((mu * g1).sum() + (sg * g2).sum(), leaves)
    mu, sg = plain(*leaves)
    ref = torch.autograd.grad((mu * g1).sum() + (sg * g2).sum(), leaves)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------------------------------
# model level
# ----------------------------------------------------------------------

def test_eval_decode_routes_through_the_kernels(monkeypatch):
    """Each non-coarsest level's posterior head goes through
    `posterior_head` and down_block_0 (2 channels) through `conv_chain`;
    the results equal the unfused ConvUnits (float32)."""
    cfg = PULPoConfig(input_size=(16, 20, 24), total_levels=4, latent_levels=3, n0=16)
    model = PULPoModel(cfg, device="cpu")
    model.init(7)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for n, b in model.module.named_buffers():
            if n.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.3)
            elif n.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    rng = np.random.default_rng(9)
    x, y = (rng.random((1, *cfg.input_size, 1), dtype=np.float32) for _ in range(2))
    calls = {"pos_head": [], "conv_chain": []}
    ph, cc = pos_head.posterior_head, conv_chain.conv_chain

    def rec_head(fb, y2, p):
        calls["pos_head"].append((tuple(fb.shape), tuple(y2.shape)))
        return ph(fb, y2, p)

    def rec_chain(x, stages):
        calls["conv_chain"].append(tuple(x.shape))
        return cc(x, stages)

    monkeypatch.setattr(pos_head, "posterior_head", rec_head)
    monkeypatch.setattr(conv_chain, "conv_chain", rec_chain)
    outs = model.predict_output_samples(x, y, N=2, seed=3)
    assert calls["conv_chain"] == [(1, *cfg.input_size, 2)]
    assert [c[0][:-1] for c in calls["pos_head"]] == [
        (2, *cfg.level_sizes[l]) for l in reversed(range(cfg.latent_levels - 1))]
    assert all(c[1][0] == 1 for c in calls["pos_head"])  # y2 once per pair

    monkeypatch.setattr(pos_head, "takes", lambda *a: False)
    monkeypatch.setattr(conv_chain, "takes", lambda *a: False)
    # the unfused units' convs on F.conv3d, as the kernels' plain versions
    # compute them (models/blocks.py would take down_block_0's 2-channel
    # conv to the narrow-conv kernel, whose sum runs in another order)
    monkeypatch.setattr(conv_narrow, "takes", lambda *a: False)
    n_calls = len(calls["pos_head"])
    ref = model.predict_output_samples(x, y, N=2, seed=3)
    assert len(calls["pos_head"]) == n_calls
    for a, b in zip(outs, ref):
        for l in a:
            torch.testing.assert_close(a[l], b[l], rtol=0, atol=1e-6)
