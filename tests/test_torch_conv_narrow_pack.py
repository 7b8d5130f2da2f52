"""The narrow conv's tensor-core body (csrc/conv_narrow.cu), walked on the CPU.

The bf16 body is an implicit GEMM on `mma.sync.m16n8k16`: the wrapper
packs the weights into a (K_pad, N_pad) bf16 matrix (`pack_weights`) and
computes the launch's tile plan (`tile_plan`); a block stages planes of
its 8 x 32 tile with a 1-voxel halo in a ring of shared memory (each
plane twice), and each lane reads its A fragments at fixed offsets from
the three-plane window. These tests emulate that walk in numpy (`_emulate`
mirrors the kernel's staging order, ring slots, per-lane offsets, the pad
masks, the B fragments' rows and columns, and the epilogue's writes) and
hold it to `conv_narrow_plain`: bit-equal on integer-valued inputs (their
sums are exact in any order), within one bf16 ulp at the output's scale
on random ones (the GEMM sums in another order), each output written
exactly once. Also the packed matrix itself and the plans at the
training step's shapes. No JAX and no card are needed.
"""

import math

import numpy as np
import pytest
import torch

from pulpo_tpu_torch.kernels import conv_narrow
from test_torch_threads import one_torch_thread  # noqa: F401

MX, MY, RING, NC = 32, 8, 5, 32  # csrc/conv_narrow.cu
PX, PY = MX + 2, MY + 2
SMS = 132


def _weights(cin, cout, rng, integer):
    if integer:
        return torch.from_numpy(rng.integers(-3, 4, (cout, cin, 3, 3, 3)).astype(np.float32))
    return torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3))
                             / np.sqrt(27 * cin)).astype(np.float32))


def _input(shape, cin, rng, integer):
    if integer:
        x = rng.integers(-3, 4, (*shape, cin)).astype(np.float32)
    else:
        x = rng.standard_normal((*shape, cin)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _lane_offsets(cin):
    """koff[ks, tq, i] (bf16 elements from a window position) and whether
    the column is a pad tap, as the kernel's kp / pad compute them."""
    cp = conv_narrow.pair_channels(cin)
    k_real, ks_n = 27 * cp, conv_narrow.k_pad(cin) // 16
    koff = np.zeros((ks_n, 4, 2), np.int64)
    pad = np.zeros((ks_n, 4, 2), bool)
    plane = PY * PX * cp
    for ks in range(ks_n):
        for tq in range(4):
            for i in range(2):
                k = 16 * ks + 2 * tq + 8 * i
                tap, ci = divmod(k, cp)
                pad[ks, tq, i] = k >= k_real
                if k < k_real:
                    koff[ks, tq, i] = ((tap // 9) * plane
                                       + ((tap // 3) % 3 * PX + tap % 3) * cp + ci)
    return koff, pad


def _emulate(x, packed, cout, plan):
    """The bf16 body's output for x (B, S0, S1, S2, cin) bf16 and the packed
    weights, as float64 sums rounded once to bf16, and how often each
    output element was written."""
    b_n, s0, s1, s2, cin = x.shape
    cp = conv_narrow.pair_channels(cin)
    plane = PY * PX * cp
    ks_n = packed.shape[0] // 16
    n_pad = packed.shape[1]
    xv = x.float().numpy()
    wv = packed.float().numpy().astype(np.float64)
    koff, pad = _lane_offsets(cin)
    ks_i, tq_i, i_i, e_i = np.meshgrid(np.arange(ks_n), np.arange(4), np.arange(2),
                                       np.arange(2), indexing="ij")
    cols = (16 * ks_i + 2 * tq_i + 8 * i_i + e_i).ravel()
    offs = (koff[ks_i, tq_i, i_i] + e_i).ravel()
    pads = pad[ks_i, tq_i, i_i].ravel()
    out = np.zeros((b_n, s0, s1, s2, cout), np.float64)
    writes = np.zeros(out.shape, np.int32)
    g = np.arange(8)
    for b in range(b_n):
        for bx in range(plan["tiles_x"] * plan["tiles_y"]):
            x0, y0 = bx % plan["tiles_x"] * MX, bx // plan["tiles_x"] * MY
            for chunk in range(plan["chunks"]):
                z_begin = chunk * plan["tz"]
                z_end = min(z_begin + plan["tz"], s0)
                ring = np.full(2 * RING * plane, np.nan)

                def stage(iz):
                    e = np.arange(plane)
                    hy, hx, c = e // (PX * cp), e // cp % PX, e % cp
                    gy, gx = y0 - 1 + hy, x0 - 1 + hx
                    ok = (c < cin) & (gy >= 0) & (gy < s1) & (gx >= 0) & (gx < s2)
                    vals = np.zeros(plane)
                    if 0 <= iz < s0:
                        vals[ok] = xv[b, iz, gy[ok], gx[ok], c[ok]]
                    slot = (iz + 1) % RING
                    ring[slot * plane:(slot + 1) * plane] = vals
                    ring[(slot + RING) * plane:(slot + RING + 1) * plane] = vals

                for iz in range(z_begin - 1, z_begin + 1):
                    stage(iz)
                for z in range(z_begin, z_end):
                    stage(z + 1)
                    wb = (z % RING) * plane
                    for warp in range(MY):
                        y = y0 + warp
                        if y >= s1:
                            continue
                        for c0 in range(0, -(-cout // NC) * NC, NC):
                            for r in range(MX // 16):
                                xr0 = x0 + 16 * r
                                if xr0 >= s2:
                                    break
                                a = np.zeros((16, 16 * ks_n))
                                for h in range(2):
                                    xb = wb + (warp * PX + 16 * r + g + 8 * h) * cp
                                    # row g + 8 h, column (ks, tq, i, e): the lane's
                                    # offset, its pair's second element at + 1
                                    vals = ring[xb[:, None] + offs[None, :]]
                                    a[np.ix_(g + 8 * h, cols)] = np.where(pads[None, :], 0.0, vals)
                                d = a @ wv[:, c0:min(c0 + NC, n_pad)]
                                for row in range(16):
                                    xo = xr0 + row
                                    if xo >= s2:
                                        continue
                                    n = min(cout - c0, NC)
                                    out[b, z, y, xo, c0:c0 + n] = d[row, :n]
                                    writes[b, z, y, xo, c0:c0 + n] += 1
    return torch.from_numpy(out).to(torch.bfloat16), writes


def _bf16_ulp(scale):
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.mark.parametrize("cin", [1, 2, 3, 4])
@pytest.mark.parametrize("cout", [8, 12, 32])
def test_packed_weights_are_taps_by_channel_pairs(cin, cout):
    """Row k = tap * cin_p + ci (taps in (kz, ky, kx) order, cin_p = cin
    rounded up to even), column = output channel, the bf16 weight; zero in
    the pad channel, past the 27 cin_p rows (K_pad: a multiple of 16) and
    past cout (N_pad: a multiple of 8)."""
    w = _weights(cin, cout, np.random.default_rng(cin * 10 + cout), False)
    packed = conv_narrow.pack_weights(w)
    cp = conv_narrow.pair_channels(cin)
    assert cp == cin + cin % 2 and packed.dtype == torch.bfloat16
    assert packed.shape == (-(-27 * cp // 16) * 16, -(-cout // 8) * 8)
    assert conv_narrow.k_pad(cin) == {1: 64, 2: 64, 3: 112, 4: 112}[cin]
    want = torch.zeros(packed.shape, dtype=torch.bfloat16)
    wb = w.to(torch.bfloat16)
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                tap = (kz * 3 + ky) * 3 + kx
                for ci in range(cin):
                    want[tap * cp + ci, :cout] = wb[:, ci, kz, ky, kx]
    assert torch.equal(packed, want)


CASES = [((1, 5, 9, 13), 1, 12), ((1, 4, 17, 40), 4, 12), ((2, 3, 10, 33), 2, 32),
         ((1, 6, 7, 8), 3, 32), ((1, 3, 8, 35), 3, 40), ((1, 4, 9, 17), 2, 8)]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("tz", [1, 3, None])
@pytest.mark.parametrize("shape,cin,cout", CASES)
def test_emulated_walk_equals_the_plain_version(shape, cin, cout, tz, integer):
    """The kernel's walk, emulated, on ragged sizes (thinner and narrower
    than a tile, x past one tile), every cin (odd ones with their zero
    pad channel), cout 8, 12, 32 and past one 32-channel pass, z chunks of
    one plane, three and the plan's: every output written once, bit-equal
    to `conv_narrow_plain` on integer-valued inputs, within one bf16 ulp
    at scale on random ones."""
    rng = np.random.default_rng(sum(shape) * 7 + cin + cout)
    x = _input(shape, cin, rng, integer)
    w = _weights(cin, cout, rng, integer)
    plan = conv_narrow.tile_plan(*shape, SMS)
    if tz is not None:
        plan = dict(plan, tz=tz, chunks=-(-shape[1] // tz))
    got, writes = _emulate(x, conv_narrow.pack_weights(w), cout, plan)
    ref = conv_narrow.conv_narrow_plain(x, w)
    assert (writes == 1).all()
    if integer:
        assert torch.equal(got, ref)
    else:
        scale = max(1.0, float(ref.float().abs().max()))
        err = float((got.float() - ref.float()).abs().max())
        assert err <= _bf16_ulp(scale), (err, scale)


def _plan_ok(plan, b, s0, s1, s2):
    """The checks the C entry makes (csrc/conv_narrow.cu:NarrowPlan::ok)."""
    tx, ty, tz, ch = (plan[k] for k in conv_narrow.PLAN_KEYS)
    return (tx * MX >= s2 > (tx - 1) * MX and ty * MY >= s1 > (ty - 1) * MY
            and tz * ch >= s0 > tz * (ch - 1) and ch <= 65535 and b <= 65535)


TRAIN_SHAPES = [(160, 192, 224), (80, 96, 112), (40, 48, 56), (20, 24, 28), (10, 12, 14),
                (192, 192, 208), (96, 96, 104), (48, 48, 52), (24, 24, 26), (12, 12, 13)]


@pytest.mark.parametrize("size", TRAIN_SHAPES)
def test_plans_at_the_training_shapes(size):
    """At the shapes a flagship and a LungCT step launch: the plan passes
    the entry's checks, marches at most MAX_TZ planes a block, and its
    chunks are the ones of least cost (waves of blocks over the SMs times
    a block's planes plus 4)."""
    plan = conv_narrow.tile_plan(1, *size, SMS)
    assert _plan_ok(plan, 1, *size) and plan["tz"] <= conv_narrow.MAX_TZ
    per_chunk = plan["tiles_x"] * plan["tiles_y"]
    cost = lambda tz: -(-per_chunk * -(-size[0] // tz) // SMS) * (tz + 4)
    assert cost(plan["tz"]) == min(cost(tz) for tz in range(1, min(size[0], 32) + 1))
    assert list(conv_narrow.plan_arg(plan)) == [plan[k] for k in conv_narrow.PLAN_KEYS]


def test_plans_of_the_step_launches():
    """The plans the flagship step's launches take (PERF.md's table): 23
    planes a block at the input size, 16 at latent level 0, one plane a
    block at the two smallest levels."""
    tz = [conv_narrow.tile_plan(1, *s, SMS)["tz"] for s in TRAIN_SHAPES[:5]]
    assert tz == [23, 16, 4, 1, 1]
