"""The frozen work functions: hand counts at a tiny configuration, and at
full size the bounds that the port's kernel table (PERF.md) gives for
#11, #13, #10, #1, #4, #12, #2, #6 and #9."""

import math

import pytest

from conftest import TINY
from portbench import harness
from portbench.work import flops, kernel_ops, peaks

FULL = harness.cell("oasis-uq32").model
BF16 = peaks.FLOPS["bfloat16"]
BW = peaks.HBM_BYTES_PER_S


def tiny(cell="oasis-uq32"):
    return dict(harness.cell(cell).model, **TINY)


def test_conv_flops_by_hand_at_a_tiny_size():
    m = tiny()  # 32x40x48, levels 3 / 2, n0 4: channels 4, 8, 16; latent levels at 16x20x24, 8x10x12
    v = [32 * 40 * 48, 16 * 20 * 24, 8 * 10 * 12]
    c = 2 * 27  # 2 k^3
    enc = c * (v[0] * (2 * 4 + 2 * 4 * 4) + v[1] * (4 * 8 + 2 * 8 * 8) + v[2] * (8 * 16 + 2 * 16 * 16))
    assert flops.encode(m) == enc
    fb = 3 + 3 + 3 + 3 + 3 + 1  # samples, velocity, individual, combined, final, transformed
    vel = lambda vox: vox * (c * (3 * 4 + 4 * 4) + 2 * 4 * 3)
    heads = lambda ch, vox: 2 * 2 * ch * 3 * vox
    sample = (v[1] * c * (fb * 12 + 12 * 12 + 12 * 8 + 8 * 8) + heads(8, v[1]) + vel(v[1])
              + vel(v[2]))
    pair = v[1] * c * 8 * 8 + heads(16, v[2])
    assert flops.decode_parts(m) == (sample, pair)
    assert flops.uq_request(m, 32) == enc + pair + 32 * sample
    assert flops.train_step(m, 2) == 3 * (flops.encode(m, 2) + 2 * (pair + sample))


def test_a_full_size_request_is_about_44_tflop():
    assert flops.uq_request(FULL, 32) == pytest.approx(43.888e12, rel=1e-4)


def by_kernel(ops, kernel):
    return [op for op in ops if op[0] == kernel]


def test_kernel_ops_by_hand_at_a_tiny_size():
    m = tiny()
    ops = kernel_ops.uq_request(m, 8, 4)
    counts = {k: d["launches"] for k, d in kernel_ops.least_by_kernel(ops).items()}
    # 2 decodes: 4 posterior-head units at the one non-coarsest level, 2 velocity
    # heads, 7 squarings and a warp a level; the tail: 7 squarings and a warp a level
    assert counts == {"conv_chain": 3, "pos_head": 8, "vel_head": 4, "squaring": 42, "warp": 6}
    sq = by_kernel(ops, "squaring")[0]
    assert sq[2] == 2 * 4 * 16 * 20 * 24 * 3 * 4
    warp0 = by_kernel(ops, "warp")[0]  # level 0 warps the full-size moving image
    assert warp0[2] == (32 * 40 * 48 + 4 * 32 * 40 * 48 * 4) * 4
    train = kernel_ops.least_by_kernel(kernel_ops.train_step(m, 1))
    assert {k: d["launches"] for k, d in train.items()} == {
        "conv_narrow": 3, "squaring": 14, "squaring_bwd": 14, "warp": 2, "warp_dfgrad": 2,
        "box_sum": 16}


def ms(seconds):
    return seconds * 1e3


@pytest.mark.parametrize("level, bound", [(0, 31.570), (1, 7.412), (2, 1.552)])
def test_posterior_head_bounds(level, bound):
    ops = kernel_ops.uq_request(FULL, 32, 32)
    per_level = by_kernel(ops, "pos_head")[4 * level:4 * level + 4]
    assert ms(sum(op[1] for op in per_level) / BF16) == pytest.approx(bound, abs=1e-3)


def test_conv_chain_velocity_head_squaring_and_warp_bounds():
    ops = kernel_ops.uq_request(FULL, 32, 32)
    assert ms(sum(op[1] for op in by_kernel(ops, "conv_chain")) / BF16) == pytest.approx(
        0.794, abs=1e-3)
    assert ms(by_kernel(ops, "vel_head")[0][1] / BF16) == pytest.approx(1.689, abs=1e-3)
    assert ms(by_kernel(ops, "squaring")[0][2] / BW) == pytest.approx(0.197, abs=1e-3)
    assert ms(by_kernel(ops, "warp")[0][2] / BW) == pytest.approx(1.060, abs=1e-3)


def test_training_kernel_bounds():
    ops = kernel_ops.train_step(dict(FULL), 1)
    narrow = by_kernel(ops, "conv_narrow")
    assert ms(narrow[0][2] / BW) == pytest.approx(0.140, abs=1e-3)   # 2 -> 32, full size
    assert ms(narrow[1][2] / BW) == pytest.approx(0.018, abs=1e-3)   # 3 -> 32, level 0
    assert ms(by_kernel(ops, "squaring_bwd")[0][2] / BW) == pytest.approx(0.009, abs=1e-3)
    assert ms(by_kernel(ops, "warp_dfgrad")[0][2] / BW) == pytest.approx(0.066, abs=1e-3)
    assert ms(by_kernel(ops, "box_sum")[0][2] / BW) == pytest.approx(0.016, abs=1e-3)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0, "bfloat16") == 1.0
    assert peaks.least_seconds(1, 3.35e12, "bfloat16") == 1.0
    assert math.isclose(peaks.least_seconds(67e12, 0, "float32"), 1.0)
