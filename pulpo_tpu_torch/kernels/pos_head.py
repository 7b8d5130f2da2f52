"""The eval posterior head: four launches of the conv-unit kernel, and
its plain version.

Replaces the TPU's `pulpo_tpu/kernels/pos_head.py:posterior_head_fused`:
for each non-coarsest latent level of an eval decode,

    up_block: ConvUnit(c_fb -> n_up) -> ConvUnit(n_up -> n_up)
    merge:    ConvUnit(up + y2 -> n_merge) -> ConvUnit(n_merge -> n_merge)
    heads:    1x1 mu, 1x1 sigma -> softplus

where y2 (B, *, n_merge) is the merge conv's activation half, computed
once per pair outside the head (no bias); row r of the R = S*B
sample-major rows reads y2[r % B]. On the card each ConvUnit is one
launch of `csrc/conv_unit.cu` with its epilogue fused (the last one
with the heads); the intermediates cross device memory in the compute
type (the kernel's header says why).

Parameters use the JAX kernel's keys (pos_head.py:286-299) in
PyTorch's layout: uk1 (n_up, c_fb, 3, 3, 3), ub1, umean1, uvar1,
uscale1, ubias1, the same for uk2, mk1 (the feedback half of the split
merge kernel, (n_merge, n_up, 3, 3, 3)), mk2, and hkmu, hksig
(zd, n_merge, 1, 1, 1), hbmu, hbsig. fb: (R, S0, S1, S2, c_fb)
channels-last, bfloat16 or float32; mu and sigma have fb's dtype.
"""

from __future__ import annotations

import torch

from pulpo_tpu_torch.kernels import conv_unit, plain_vjp
from pulpo_tpu_torch.kernels.conv_unit import UNIT, UNIT_ADD, UNIT_HEADS

ZDIM = 3
HEAD_KEYS = ("hkmu", "hbmu", "hksig", "hbsig")
KEYS = tuple(f"{pre}{k}{n}" for pre in "um" for n in (1, 2) for k in conv_unit.UNIT_KEYS) \
    + HEAD_KEYS

launches = 0  # conv-unit kernel launches of `posterior_head`


def reset_count() -> None:
    global launches
    launches = 0


def units(p: dict) -> list[dict]:
    """The four ConvUnits (up1, up2, merge1, merge2) as conv_unit dicts."""
    return [{k: p[f"{pre}{k}{n}"] for k in conv_unit.UNIT_KEYS}
            for pre in "um" for n in (1, 2)]


def posterior_head_plain(fb: torch.Tensor, y2: torch.Tensor, p: dict):
    """The kernel chain's plain PyTorch version, with its rounding points
    (pulpo_tpu/kernels/pos_head.py:posterior_head_xla): (mu, sigma)."""
    u1, u2, m1, m2 = units(p)
    x = conv_unit.unit_plain(fb, u1)
    x = conv_unit.unit_plain(x, u2)
    x = conv_unit.unit_plain(x, m1, y2)
    x = conv_unit.unit_plain(x, m2)
    return conv_unit.heads_plain(x, *(p[k] for k in HEAD_KEYS))


def takes(fb: torch.Tensor, p: dict) -> bool:
    """Whether the kernel takes this head: a function of shapes and dtype
    only (every width <= 192, zdim 3, bfloat16 or float32)."""
    if not conv_unit.check_input(fb):
        return False
    u1, u2, m1, m2 = units(p)
    n_up, n_merge = u1["k"].shape[0], m1["k"].shape[0]
    heads = [p[k] for k in HEAD_KEYS]
    return (conv_unit.check_unit(u1, fb.shape[-1]) and conv_unit.check_unit(u2, n_up)
            and conv_unit.check_unit(m1, n_up) and conv_unit.check_unit(m2, n_merge)
            and tuple(heads[0].shape) == tuple(heads[2].shape) == (ZDIM, n_merge, 1, 1, 1)
            and tuple(heads[1].shape) == tuple(heads[3].shape) == (ZDIM,))


def _check_y2(fb: torch.Tensor, y2: torch.Tensor, p: dict) -> None:
    n_merge = p["mk1"].shape[0]
    if (y2.dim() != 5 or tuple(y2.shape[1:]) != (*fb.shape[1:4], n_merge)
            or fb.shape[0] % y2.shape[0]):
        raise ValueError(f"posterior head: y2 {tuple(y2.shape)} is not (B, "
                         f"{', '.join(map(str, fb.shape[1:4]))}, {n_merge}) with B "
                         f"dividing the {fb.shape[0]} rows")


def _kernel(fb, y2, *vals):
    global launches
    p = dict(zip(KEYS, vals))
    u1, u2, m1, m2 = units(p)
    x = conv_unit.launch(fb, u1, UNIT)
    launches += 1
    x = conv_unit.launch(x, u2, UNIT)
    launches += 1
    x = conv_unit.launch(x, m1, UNIT_ADD, y2=y2)
    launches += 1
    out = conv_unit.launch(x, m2, UNIT_HEADS, heads=tuple(p[k] for k in HEAD_KEYS))
    launches += 1
    return out


def _plain(fb, y2, *vals):
    return posterior_head_plain(fb, y2, dict(zip(KEYS, vals)))


def posterior_head(fb: torch.Tensor, y2: torch.Tensor, p: dict):
    """(mu, sigma): the conv-unit kernel chain for a tensor on the card, the
    plain version on the CPU. On the card it raises for a head that
    `takes` rejects; a gradient through it is the plain version's."""
    if fb.device.type == "cpu":
        return posterior_head_plain(fb, y2, p)
    if not takes(fb, p):
        raise ValueError(
            f"posterior head kernel does not take fb {tuple(fb.shape)} {fb.dtype} with "
            f"uk1 {tuple(p['uk1'].shape)}, mk1 {tuple(p['mk1'].shape)}, hkmu "
            f"{tuple(p['hkmu'].shape)} (widths <= {conv_unit.MAX_WIDTH}, zdim {ZDIM})")
    _check_y2(fb, y2, p)
    return plain_vjp.apply(_kernel, _plain, fb, y2.to(fb.dtype), *(p[k] for k in KEYS))
