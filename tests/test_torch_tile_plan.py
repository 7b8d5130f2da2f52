"""The bf16 kernels' launch plans and packed weight layouts, on the CPU.

The conv-unit and velocity-head kernels (csrc/conv_unit.cu,
csrc/vel_head.cu) take bricks of output voxels from a plan the wrappers
compute (`tile_plan`, ordered as `_build.tile_origin` and handed over
by `_build.plan_arg`) and weights the wrappers pack (`pack_tc`). These tests hold the Python side to what the kernels
assume: every packed layout unpacks to the conv weights exactly, the
bricks cover every output voxel of a ragged volume exactly once, and
the conv unit's stage walk (16-channel chunks x tap planes, zero-filled
boxes with a 1-voxel halo, wgmma rows addressed by descriptor strides)
computes the convolution. No JAX and no card are needed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pulpo_tpu_torch.kernels import _build, conv_unit, vel_head
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(1, 13, 18, 21), (3, 5, 7, 9), (2, 20, 24, 28)]


def unpack_unit(w, cout, cin):
    """The conv weights (cout, cin, 3, 3, 3) back from
    `conv_unit.pack_tc`'s (cp / 16, 3, 9, 2, npad, 8) layout."""
    nc, _, _, _, npad, _ = w.shape
    k = w.reshape(nc, 3, 3, 3, 2, npad, 8).permute(5, 0, 4, 6, 1, 2, 3)
    return k.reshape(npad, nc * conv_unit.TC_CHUNK, 3, 3, 3)[:cout, :cin]


def unpack_head(w1, w2, n0, zdim):
    """k1 (n0, zdim, 3, 3, 3) and k2 (n0, n0, 3, 3, 3) back from
    `vel_head.pack_tc`'s w1 (n0p, K1), k = 4 tap + ci, and w2 (27, out, in)."""
    z = vel_head.MAX_ZDIM
    k1 = w1[:n0, :27 * z].reshape(n0, 3, 3, 3, z)[..., :zdim].permute(0, 4, 1, 2, 3)
    k2 = w2[:, :n0, :n0].reshape(3, 3, 3, n0, n0).permute(3, 4, 0, 1, 2)
    return k1, k2


def _weights(cout, cin, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((cout, cin, 3, 3, 3), generator=g).to(torch.bfloat16)


@pytest.mark.parametrize("cin,cout", [(2, 32), (15, 96), (16, 96), (96, 64), (128, 192),
                                      (16, 3), (40, 16)])
def test_conv_unit_pack_tc_unpacks_to_the_weights(cin, cout):
    k = _weights(cout, cin, cin + cout)
    npad = conv_unit.width(cout)
    w = conv_unit.pack_tc(k, npad)
    cp = -(-cin // conv_unit.TC_CHUNK) * conv_unit.TC_CHUNK
    assert tuple(w.shape) == (cp // 16, 3, 9, 2, npad, 8) and w.dtype == torch.bfloat16
    assert torch.equal(unpack_unit(w, cout, cin), k)
    # the padding is zeros: padded channels add exact zeros
    assert float(w.double().abs().sum()) == float(k.double().abs().sum())
    # one element: chunk c, tap (dz, dy, dx), half h, output n, channel e
    c, dz, dy, dx, n = 0, 2, 1, 0, cout - 1
    for ch in {0, min(cin, 16) - 1}:
        assert w[c, dz, 3 * dy + dx, ch // 8, n, ch % 8] == k[n, ch, dz, dy, dx]


def test_conv_unit_f32_pack_unpacks_to_the_weights():
    u = {"k": torch.randn((20, 7, 3, 3, 3)), "b": torch.randn(20), "mean": torch.randn(20),
         "var": torch.rand(20) + 0.1, "scale": torch.randn(20), "bias": torch.randn(20)}
    w, b, bn = conv_unit._pack(u, torch.float32, "cpu")
    assert tuple(w.shape) == (32, 192) and tuple(bn.shape) == (3, 32)
    k = w[:20, :27 * 7].reshape(20, 3, 3, 3, 7).permute(0, 4, 1, 2, 3)
    assert torch.equal(k, u["k"]) and float(w[20:].abs().sum() + w[:, 189:].abs().sum()) == 0


@pytest.mark.parametrize("n0,zdim", [(8, 3), (32, 3), (64, 3), (32, 4), (16, 1)])
def test_vel_head_pack_tc_unpacks_to_the_weights(n0, zdim):
    g = torch.Generator().manual_seed(n0 + zdim)
    p = {"k1": torch.randn((n0, zdim, 3, 3, 3), generator=g),
         "k2": torch.randn((n0, n0, 3, 3, 3), generator=g)}
    n0p = next(w for w in (16, 32, 64) if w >= n0)
    w1, w2 = vel_head.pack_tc(p, n0p, "cpu")
    assert tuple(w1.shape) == (n0p, vel_head.K1) and tuple(w2.shape) == (27, n0p, n0p)
    k1, k2 = unpack_head(w1, w2, n0, zdim)
    assert torch.equal(k1, p["k1"].bfloat16()) and torch.equal(k2, p["k2"].bfloat16())
    assert float(w1.double().abs().sum()) == float(k1.double().abs().sum())
    # k = 4 tap + ci, tap = 9 dz + 3 dy + dx; w2[tap, out, in]
    assert w1[n0 - 1, 4 * (9 * 2 + 3 * 1 + 0) + zdim - 1] == k1[n0 - 1, zdim - 1, 2, 1, 0]
    assert w2[9 * 0 + 3 * 2 + 1, 0, n0 - 1] == k2[0, n0 - 1, 0, 2, 1]


def _coverage(plan, brick, shape, origin):
    rows, *size = shape
    hits = np.zeros(shape, np.int32)
    for t in range(plan["tiles"]):
        r, z0, y0, x0 = origin(plan, t)
        assert 0 <= r < rows and z0 < size[0] and y0 < size[1] and x0 < size[2]
        hits[r, z0:z0 + brick[0], y0:y0 + brick[1], x0:x0 + brick[2]] += 1
    return hits


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("npad", conv_unit.WIDTHS)
def test_conv_unit_bricks_cover_every_voxel_once(npad, shape):
    plan = conv_unit.tile_plan(shape[0], shape[1:], npad, sms=132)
    # the brick's planes are those of the two warpgroups' accumulators
    tz = 8 if npad <= 64 else 4 if npad <= 128 else 2
    assert plan["brick"] == (tz, conv_unit.TILE_YX, conv_unit.TILE_YX)
    assert np.all(_coverage(plan, plan["brick"], shape, _build.tile_origin) == 1)
    assert plan["grid"] == min(plan["tiles"], 132)
    # the persistent walk (block b takes tiles b, b + grid, ...) takes each tile once
    walked = sorted(t for b in range(plan["grid"]) for t in range(b, plan["tiles"], plan["grid"]))
    assert walked == list(range(plan["tiles"]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n0p", (16, 32, 64))
def test_vel_head_bricks_cover_every_voxel_once(n0p, shape):
    plan = vel_head.tile_plan(shape[0], shape[1:], n0p, sms=5)
    assert plan["brick"] == (4 if n0p <= 32 else 2, 8, 16)
    assert np.all(_coverage(plan, plan["brick"], shape, _build.tile_origin) == 1)
    assert plan["grid"] == 5


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_arg_is_the_plan_the_kernels_walk(shape):
    """The six ints a kernel takes (csrc/tc.cuh:BrickPlan): tz, the tiles
    along z, y and x of a row, the tiles and the grid, and the coverage
    that BrickPlan::ok asks of them."""
    plan = vel_head.tile_plan(shape[0], shape[1:], 32, sms=132)
    arg = list(_build.plan_arg(plan))
    assert arg == [plan["brick"][0], *plan["per_axis"], plan["tiles"], plan["grid"]]
    tz, nz, ny, nx, tiles, grid = arg
    assert tiles == shape[0] * nz * ny * nx and 1 <= grid <= tiles
    assert all(n * b >= s and (n - 1) * b < s
               for n, b, s in zip((nz, ny, nx), plan["brick"], shape[1:]))


def _stage_walk(x, k, npad):
    """The conv sums as csrc/conv_unit.cu's bf16 path forms them, in
    float64: for each brick and each stage (chunk c, tap plane dz), two
    8-channel planes of a zero-filled (tz, 10, 10) box at (z0 + dz - 1,
    y0 - 1, x0 - 1), and for each output plane and tap (dy, dx) the 64
    rows a wgmma descriptor addresses (8 row groups at the line stride,
    8 consecutive positions each) times the packed weights."""
    R, S0, S1, S2, cin = x.shape
    cp = -(-cin // 16) * 16
    xp = np.zeros((R, S0, S1, S2, cp))
    xp[..., :cin] = x
    w = conv_unit.pack_tc(k, npad).double().numpy()
    plan = conv_unit.tile_plan(R, (S0, S1, S2), npad, sms=3)
    tz, hy, hx = plan["brick"][0], 10, 10
    rows = np.array([i * hx + j for i in range(8) for j in range(8)])
    out = np.zeros((R, S0, S1, S2, npad))
    for t in range(plan["tiles"]):
        r, z0, y0, x0 = _build.tile_origin(plan, t)
        acc = np.zeros((tz, 64, npad))
        for c in range(cp // 16):
            for dz in range(3):
                box = np.zeros((tz, hy, hx, 16))
                for a in range(tz):
                    for b in range(hy):
                        for d in range(hx):
                            gz, gy, gx = z0 + dz - 1 + a, y0 - 1 + b, x0 - 1 + d
                            if 0 <= gz < S0 and 0 <= gy < S1 and 0 <= gx < S2:
                                box[a, b, d] = xp[r, gz, gy, gx, 16 * c:16 * c + 16]
                planes = box.reshape(tz * hy * hx, 2, 8).transpose(1, 0, 2)
                for zo in range(tz):
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        a_rows = planes[:, (zo * hy + dy) * hx + dx + rows, :]
                        acc[zo] += np.einsum("gme,gne->mn", a_rows, w[c, dz, tap])
        for zo in range(tz):
            for m in range(64):
                z, y, xx = z0 + zo, y0 + m // 8, x0 + m % 8
                if z < S0 and y < S1 and xx < S2:
                    out[r, z, y, xx] = acc[zo, m]
    return out[..., :k.shape[0]]


@pytest.mark.parametrize("cin,cout,shape", [(5, 8, (2, 5, 7, 9)), (16, 96, (1, 9, 10, 17)),
                                            (20, 192, (1, 3, 9, 11))])
def test_conv_unit_stage_walk_computes_the_conv(cin, cout, shape):
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((*shape, cin))
    k = _weights(cout, cin, cout)
    got = _stage_walk(x, k, conv_unit.width(cout))
    ref = F.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), k.double(), padding=1)
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 4, 1).numpy(), rtol=0, atol=1e-9)


def test_build_includes_follow_quoted_headers(tmp_path):
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "x.cuh"\n  # include "y.cuh"\n')
    (tmp_path / "x.cuh").write_text('#pragma once\n#include "z.cuh"\n#include "y.cuh"\n')
    (tmp_path / "y.cuh").write_text("// y\n")
    (tmp_path / "z.cuh").write_text("// z\n")
    assert _build.includes(tmp_path / "a.cu") == [tmp_path / n for n in ("x.cuh", "y.cuh",
                                                                         "z.cuh")]
    assert _build.includes(tmp_path / "y.cuh") == []
    assert _build.includes(_build.CSRC / "conv_unit.cu") == [_build.CSRC / "tc.cuh"]
    assert _build.includes(_build.CSRC / "vel_head.cu") == [_build.CSRC / "tc.cuh"]


def test_build_hash_changes_with_an_included_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return H; }\n')
    (tmp_path / "h.cuh").write_text("#define H 1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"k": ("k.cu", [])})
    first = _build._target("k")[0]
    assert _build._target("k")[0] == first
    (tmp_path / "h.cuh").write_text("#define H 2\n")
    assert _build._target("k")[0] != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return H + 0; }\n')
    assert _build._target("k")[0] != first
