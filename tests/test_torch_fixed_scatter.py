"""The order-free fixed-point scatter (csrc/fixed.cuh) in its plain
versions, on the CPU.

`warp_mgrad_plain` (the moving-cotangent, #7) and the data term of
`squaring_step_bwd_plain` (#2) quantize each term ``w * g`` to an int64 at
a scale fixed for the launch (`warp.fixed_scale`), sum the integers and
convert the sums to float32, as the CUDA kernels do; the kernels are held
to these bits on the card (tests/test_torch_gpu.py). Here:
- the sum does not depend on the order of the terms: the source voxels
  summed in reversed order (numpy, term by term), and B_df = 2B sample
  rows swapped, give the same bits; a slab is quantized as the whole
  launch at the same max;
- the scale follows g: an all-zero g gives zeros, a g scaled by 1e30 or
  1e-30 the unscaled result times the scale within float32 rounding (no
  overflow, no flush to zero);
- a NaN or Inf in g gives an output that is non-finite wherever the JAX
  `warp_image` VJP's is (everywhere: the launch's scale is not finite);
- the plain squaring backward stays within its tolerance (rtol / atol
  1e-5) of `_squaring_step_bwd_pallas` in interpret mode under its bound
  and of the XLA VJP at |v| = 3;
- a sharded step's slabs (ranks simulated by threads), their max and
  their integer sums taken over the column (`column`), give the whole
  squaring backward's planes bit for bit, and the planes a slab's terms
  reach lie within `squaring.reaches`;
- the march both kernels walk (`warp.mgrad_plan`, the squaring
  backward's plan over the df's output space) visits every source voxel
  of every df row once and delivers each corner term once to its cell,
  across resolutions and with df rows sharing a moving row.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu_torch.kernels import gather, squaring, warp
from test_torch_box_sum_bwd_plan import _walk_march
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return torch.from_numpy(v * (mag / np.abs(v).max()))


def _cotangent(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _reversed_sum(moving_shape, df, g):
    """`warp_mgrad_plain`'s terms, quantized at its scale, summed in numpy
    term by term with the source voxels, and the corners, in reversed
    order, then converted as the plain version converts."""
    spatial = tuple(moving_shape[1:-1])
    c = moving_shape[-1]
    i0, i1, w = warp._corners(df, spatial, torch.float32)
    base, strides = warp._flat_index(moving_shape, df)
    gflat = g.reshape(-1, c)
    up, down, finite = warp.fixed_scale(warp.abs_max_bits(gflat),
                                        df.shape[0] * int(np.prod(df.shape[1:-1])))
    assert bool(finite)
    acc = np.zeros((int(np.prod(moving_shape[:-1])), c), np.int64)
    for corner in reversed(range(8)):
        idx, weight = warp._corner(3, corner, i0, i1, w, base, strides)
        terms = torch.round((gflat * weight.reshape(-1, 1)).double() * up).to(torch.int64)
        for k in reversed(range(terms.shape[0])):
            acc[int(idx.reshape(-1)[k])] += terms[k].numpy()
    out = (torch.from_numpy(acc).double() * down).float()
    return out.reshape(moving_shape)


@pytest.mark.parametrize("case", ["reversed voxels", "rows swapped", "slab"])
def test_mgrad_plain_sums_order_free(case):
    """The same bits whatever the order of the adds."""
    if case == "reversed voxels":
        shape = (1, 6, 7, 8, 3)
        d, g = _field((1, 6, 7, 8, 3), 3.0, 1), _cotangent((1, 6, 7, 8, 3), 2)
        assert torch.equal(warp.warp_mgrad_plain(shape, d, g), _reversed_sum(shape, d, g))
    elif case == "rows swapped":
        shape = (2, 8, 9, 10, 2)  # B_df = 2B: rows r and r + 2 read moving row r
        d, g = _field((4, 8, 9, 10, 3), 4.0, 3), _cotangent((4, 8, 9, 10, 2), 4)
        order = [2, 3, 0, 1]
        assert torch.equal(warp.warp_mgrad_plain(shape, d, g),
                           warp.warp_mgrad_plain(shape, d[order], g[order]))
    else:
        shape = (1, 8, 9, 10, 1)
        d, g = _field((2, 8, 9, 10, 3), 3.0, 5), _cotangent((2, 8, 9, 10, 1), 6)
        g[:, 2:5] *= 4.0  # the slab holds the max
        masked = torch.zeros_like(g)
        masked[:, 2:5] = g[:, 2:5]
        assert torch.equal(warp.warp_mgrad_plain(shape, d[:, 2:5], g[:, 2:5], 2, 8),
                           warp.warp_mgrad_plain(shape, d, masked))


def test_mgrad_plain_is_the_exact_sum_rounded():
    """Within float32 rounding of the float64 sum of the float32 terms."""
    shape = (1, 9, 10, 11, 3)
    d, g = _field((2, 9, 10, 11, 3), 5.0, 7), _cotangent((2, 9, 10, 11, 3), 8)
    got = warp.warp_mgrad_plain(shape, d, g)
    i0, i1, w = warp._corners(d, shape[1:-1], torch.float32)
    base, strides = warp._flat_index(shape, d)
    exact = torch.zeros((int(np.prod(shape[:-1])), 3), dtype=torch.float64)
    for corner in range(8):
        idx, weight = warp._corner(3, corner, i0, i1, w, base, strides)
        exact.index_add_(0, idx.reshape(-1), (g.reshape(-1, 3) * weight.reshape(-1, 1)).double())
    exact = exact.reshape(shape)
    assert float((got.double() - exact).abs().max()) <= 2**-23 * float(exact.abs().max())


def test_all_zero_cotangent_gives_zeros():
    d = _field((2, 6, 7, 8, 3), 3.0, 9)
    zero = torch.zeros((2, 6, 7, 8, 3))
    assert torch.equal(warp.warp_mgrad_plain((1, 6, 7, 8, 3), d, zero),
                       torch.zeros((1, 6, 7, 8, 3)))
    assert torch.equal(squaring.squaring_step_bwd_plain(d[:1], zero[:1]),
                       torch.zeros_like(d[:1]))


@pytest.mark.parametrize("scale", [1e30, 1e-30])
def test_the_scale_follows_the_cotangent(scale):
    """A cotangent scaled by 1e30 or 1e-30: the unscaled result times the
    scale, within float32 rounding (8 ulps of the output's scale)."""
    shape = (1, 7, 8, 9, 3)
    d, g = _field((1, 7, 8, 9, 3), 3.0, 10), _cotangent((1, 7, 8, 9, 3), 11)
    ref = warp.warp_mgrad_plain(shape, d, g).double() * scale
    got = warp.warp_mgrad_plain(shape, d, g * scale).double()
    top = float(ref.abs().max())
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.5 * top
    assert float((got - ref).abs().max()) <= 8 * 2**-24 * top


def _jax_moving_vjp(m, d, g):
    from pulpo_tpu.ops.warp import warp_image

    _, vjp = jax.vjp(warp_image, jnp.asarray(m), jnp.asarray(d))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_non_finite_cotangent_is_non_finite_where_jax_is(bad):
    """JAX's VJP is NaN or Inf at the affected targets only; the plain
    version (and the kernel) is NaN everywhere, a superset. The squaring
    backward's output is NaN everywhere too."""
    m = np.random.default_rng(12).random((1, 6, 7, 8, 3), dtype=np.float32)
    d = _field((1, 6, 7, 8, 3), 2.0, 13)
    g = _cotangent((1, 6, 7, 8, 3), 14)
    g[0, 2, 3, 4, 1] = bad
    ref = _jax_moving_vjp(m, d.numpy(), g.numpy())
    got = warp.warp_mgrad_plain(m.shape, d, g).numpy()
    assert not np.isfinite(ref).all()
    assert not np.isfinite(got[~np.isfinite(ref)]).any()
    assert np.isnan(got).all()
    assert bool(torch.isnan(squaring.squaring_step_bwd_plain(d, g)).all())


def test_squaring_bwd_plain_matches_pallas_under_its_bound():
    from pulpo_tpu.kernels.warp_local import _squaring_step_bwd_pallas, local_bound

    shape = (1, 8, 9, 10, 3)
    v = _field(shape, 0.999 * local_bound(shape[1:-1]), 15).numpy()
    g = _cotangent(shape, 16).numpy()
    ref = _squaring_step_bwd_pallas(jnp.asarray(v), jnp.asarray(g), interpret=True)
    got = squaring.squaring_step_bwd(torch.from_numpy(v), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_squaring_bwd_plain_matches_xla_vjp_at_3_voxels():
    from pulpo_tpu.kernels.warp_local import _squaring_step_xla

    shape = (1, 12, 13, 14, 3)
    v = _field(shape, 3.0, 17).numpy()
    g = _cotangent(shape, 18).numpy()
    _, vjp = jax.vjp(_squaring_step_xla, jnp.asarray(v))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    got = squaring.squaring_step_bwd(torch.from_numpy(v), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("blocks", [None, 1])
@pytest.mark.parametrize("moving,df,mag", [
    ((1, 9, 10, 11), (1, 9, 10, 11), 0.4), ((1, 9, 10, 11), (1, 9, 10, 11), 3.0),
    ((2, 12, 14, 16), (4, 6, 7, 8), 2.0), ((1, 6, 7, 8), (2, 11, 13, 15), 1.0)])
def test_mgrad_march_delivers_every_term_once(monkeypatch, moving, df, mag, blocks):
    """The moving-cotangent's launch (`warp.mgrad_plan`) walked as the
    kernel walks it: every output voxel of every df row scattered once,
    each of its 8 corner terms delivered once to its cell of moving row
    r % B, with the plan's chunks along z and one chunk (`blocks` 1), at
    equal sizes and across resolutions (a coarser and a finer df)."""
    if blocks is not None:
        monkeypatch.setattr(gather, "BWD_TARGET_BLOCKS", blocks)
    d = _field((df[0], *df[1:], 3), mag, 19)
    i0, i1, w = warp._corners(d, moving[1:], torch.float32)
    plan = warp.mgrad_plan(d.shape)
    assert plan["zg"] == df[1] and plan["z0"] == 0
    scattered, sent, _ = _walk_march([a.numpy() for a in i0], [a.numpy() for a in i1],
                                     [a.numpy() for a in w], moving[0], plan, own=False)
    assert (scattered == 1).all()
    assert len(sent) == 8 * scattered.size and set(sent.values()) == {1}


def columns(g, ranks):
    """Each of `ranks` simulated ranks' `column` for `squaring_step_bwd`
    on its slab of g (one thread a rank): the largest `abs_max_bits` of
    the slabs, and an exchange that adds the other ranks' int64 sums of
    its planes into its own, the ranks meeting at a barrier."""
    per = g.shape[1] // ranks
    top = max(warp.abs_max_bits(g[:, r * per:(r + 1) * per]) for r in range(ranks))
    barrier, slots = threading.Barrier(ranks), [None] * ranks

    def exchange_of(rank):
        def exchange(acc):
            slots[rank] = acc.clone()
            barrier.wait()
            mine = slice(rank * per, (rank + 1) * per)
            for other in range(ranks):
                if other != rank:
                    acc[:, mine] += slots[other][:, mine]
            barrier.wait()
        return exchange

    return [(top, exchange_of(r)) for r in range(ranks)]


def sharded_backward(fn, v, g, ranks):
    """`fn` (the squaring backward) of each rank's slab of g with the
    column's `column`, run as one thread a rank; the slabs joined."""
    per = v.shape[1] // ranks
    outs, cols = [None] * ranks, columns(g, ranks)

    def run(r):
        outs[r] = fn(v, g[:, r * per:(r + 1) * per].contiguous(), r * per, cols[r])

    threads = [threading.Thread(target=run, args=(r,)) for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_squaring_backward_is_the_whole_one(ranks):
    """The slabs' shares summed over the column in fixed point: the slabs
    of the whole backward, bit for bit."""
    v = _field((2, 8, 9, 10, 3), 3.0, 20)
    g = _cotangent((2, 8, 9, 10, 3), 21)
    got = sharded_backward(squaring.squaring_step_bwd, v, g, ranks)
    assert torch.equal(got, squaring.squaring_step_bwd_plain(v, g))


@pytest.mark.parametrize("mag", [0.3, 3.0, 8.0, float("nan")])
def test_reaches_hold_every_plane_a_slab_adds_into(mag):
    """`squaring.reaches`: the z corners of every slab's source voxels
    (the planes its data term adds into) lie within its reach; a
    non-finite field reaches every plane."""
    v = _field((2, 16, 5, 6, 3), 3.0 if mag != mag else mag, 22)
    if mag != mag:
        v[1, 9, 2, 3, 0] = mag
    for depth in (2, 4, 8):
        got = squaring.reaches(v, depth)
        assert len(got) == 16 // depth
        for r, (lo, hi) in enumerate(got):
            if mag != mag and r == 9 // depth:
                assert (lo, hi) == (0, 16)
                continue
            i0, i1, _ = warp._corners(v[:, r * depth:(r + 1) * depth], (16, 5, 6),
                                      torch.float32, r * depth, 16)
            assert lo <= int(i0[0].min()) and int(i1[0].max()) < hi, (depth, r, lo, hi)
            assert 0 <= lo < hi <= 16
