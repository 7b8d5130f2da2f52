"""The eval narrow-input ConvSequence: `depth` launches of the conv-unit
kernel, and its plain version.

Replaces the TPU's `pulpo_tpu/attic/conv_chain.py:conv_chain_fused`: a
plain eval ConvSequence (a chain of conv3^3 + bias + eval BatchNorm +
LeakyReLU(0.2), no split operand) on an input of at most 8 channels,
which in the flagship and LungCT configurations is the encoder's
full-resolution `down_block_0` (2 -> n0 -> n0 -> n0). On the card each
unit is one launch of `csrc/conv_unit.cu` with its epilogue fused.

stages: one dict per unit (kernels/conv_unit.py's layout: k (cout,
cin, 3, 3, 3), b, mean, var, scale, bias). x: (R, S0, S1, S2, cin)
channels-last, bfloat16 or float32; the output has x's dtype.
"""

from __future__ import annotations

import torch

from pulpo_tpu_torch.kernels import conv_unit, plain_vjp

MAX_CIN = 8

launches = 0  # conv-unit kernel launches of `conv_chain`


def reset_count() -> None:
    global launches
    launches = 0


def conv_chain_plain(x: torch.Tensor, stages: list[dict]) -> torch.Tensor:
    """The chain's plain PyTorch version, with the kernel's rounding points
    (pulpo_tpu/attic/conv_chain.py:conv_chain_xla)."""
    for u in stages:
        x = conv_unit.unit_plain(x, u)
    return x


def takes(x: torch.Tensor, stages: list[dict]) -> bool:
    """Whether the kernel takes this chain: a function of shapes and dtype
    only (an input of at most 8 channels, every width <= 192, bfloat16 or
    float32)."""
    if not conv_unit.check_input(x) or x.shape[-1] > MAX_CIN or not stages:
        return False
    cin = x.shape[-1]
    for u in stages:
        if not conv_unit.check_unit(u, cin):
            return False
        cin = u["k"].shape[0]
    return True


def _flat(stages):
    return [u[k] for u in stages for k in conv_unit.UNIT_KEYS]


def _stages(vals):
    n = len(conv_unit.UNIT_KEYS)
    return [dict(zip(conv_unit.UNIT_KEYS, vals[i:i + n])) for i in range(0, len(vals), n)]


def _kernel(x, *vals):
    global launches
    for u in _stages(vals):
        x = conv_unit.launch(x, u)
        launches += 1
    return x


def _plain(x, *vals):
    return conv_chain_plain(x, _stages(vals))


def conv_chain(x: torch.Tensor, stages: list[dict]) -> torch.Tensor:
    """The conv-unit kernel chain for a tensor on the card, the plain
    version on the CPU. On the card it raises for a chain that `takes`
    rejects; a gradient through it is the plain version's."""
    if x.device.type == "cpu":
        return conv_chain_plain(x, stages)
    if not takes(x, stages):
        raise ValueError(
            f"conv chain kernel does not take x {tuple(x.shape)} {x.dtype} with widths "
            f"{[tuple(u['k'].shape[:2]) for u in stages]} (cin <= {MAX_CIN}, widths <= "
            f"{conv_unit.MAX_WIDTH})")
    return plain_vjp.apply(_kernel, _plain, x, *_flat(stages))
