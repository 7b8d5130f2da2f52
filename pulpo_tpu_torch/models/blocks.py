"""Network building blocks (channels-last at their boundaries).

Port of pulpo_tpu/models/blocks.py:171-318. Each block takes `train`:
False applies BatchNorm with its running statistics, True with the
batch's (and records the running statistics' update without applying
it; see `BatchNorm`). Module and parameter names
follow the reference state_dict (`_op.{i}` sequences, `_op.0` the conv
and `_op.1` the BatchNorm of a ConvUnit), so that `state_dict()` is a
reference checkpoint. Parameters are float32; each block computes in
its `dtype`, with the JAX package's rounding points: a conv's sum is
rounded to the compute type before its bias add, BatchNorm runs in
float32 in flax's order, LeakyReLU in the compute type.

Convs run on NCDHW views of channels-last tensors (a free permute: the
memory is PyTorch's channels_last_3d layout).

Not ported: the 96->128 channel pad and the tap-sum conv backward of
the JAX `_RawConv` (TPU workarounds that compute the same function).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pulpo_tpu_torch.kernels.vel_head import bn_affine, eval_bn, leaky, velocity_head


def conv3d_cl(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """conv3d of a channels-last x by a (O, I, *K) weight, in x's dtype."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype), padding=pad)
    return y.permute(0, 2, 3, 4, 1)


def conv1x1_cl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1x1 conv of a channels-last x, as a matmul over channels."""
    return torch.matmul(x, w.reshape(w.shape[0], w.shape[1]).to(x.dtype).T)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def tile_rows(y2: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, ...) -> (S*B, ...) sample-major: row r is y2[r % B]."""
    s = rows // y2.shape[0]
    assert s * y2.shape[0] == rows, (rows, y2.shape)
    return y2.unsqueeze(0).expand(s, *y2.shape).reshape(rows, *y2.shape[1:])


class BatchNorm(nn.Module):
    """flax's BatchNorm (momentum 0.9, epsilon 1e-5) on a channels-last x,
    applied as ``(f32(x) - mean) * (rsqrt(var + eps) * scale) + bias`` in
    float32 and cast back to x's dtype.

    Eval: the running statistics. Train: the batch's, in float32 over
    (B, *spatial), with flax's fast variance ``max(0, E[x^2] - E[x]^2)``
    (biased; `nn.BatchNorm3d` would take the unbiased one). A train call
    does not touch the buffers: it leaves the running statistics' update
    ``0.9 * old + 0.1 * batch`` in `pending`, which the training step
    commits (or drops, when its NaN guard fires)."""

    momentum = 0.9

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.pending: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return eval_bn(x, *bn_affine(self.running_mean, self.running_var,
                                         self.weight, self.bias))
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp_min(torch.mean(xf * xf, dims) - mean * mean, 0.0)
        assert self.pending is None, "a BatchNorm ran twice in one train forward"
        m = self.momentum
        self.pending = (m * self.running_mean + (1 - m) * mean.detach(),
                        m * self.running_var + (1 - m) * var.detach())
        return eval_bn(x, *bn_affine(mean, var, self.weight, self.bias))


class ConvUnit(nn.Module):
    """Conv(k=3, SAME) -> BatchNorm -> LeakyReLU(0.2).

    ``forward(x, x2)`` computes the unit on ``concat([x, x2], -1)`` as two
    halves of one kernel, without the concat; when x2 has fewer rows (B)
    than x (S*B, samples folded into the batch), its half is convolved
    once per pair and broadcast over the samples
    (pulpo_tpu/models/blocks.py:_RawConv)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self._op = nn.ModuleList([nn.Conv3d(cin, cout, 3, padding=1),
                                  BatchNorm(cout)])

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        conv, bn = self._op
        dt = self.dtype
        x = x.to(dt)
        if x2 is None:
            y = conv3d_cl(x, conv.weight, 1)
        else:
            c1 = x.shape[-1]
            y = conv3d_cl(x, conv.weight[:, :c1], 1)
            y2 = conv3d_cl(x2.to(dt), conv.weight[:, c1:], 1)
            if y2.shape[0] != y.shape[0]:
                y2 = tile_rows(y2, y.shape[0])
            y = y + y2
        y = y + conv.bias.to(dt)
        return leaky(bn(y, train))


class ConvSequence(nn.Module):
    """`depth` chained ConvUnits; the first changes the channel count and
    takes the optional split operand x2."""

    def __init__(self, cin: int, cout: int, depth: int, dtype: torch.dtype):
        super().__init__()
        self._op = nn.ModuleList(
            [ConvUnit(cin if i == 0 else cout, cout, dtype) for i in range(depth)])

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        for i, unit in enumerate(self._op):
            x = unit(x, x2 if i == 0 else None, train)
        return x


class MuSigmaBlock(nn.Module):
    """Two 1x1 convs: a linear mu head and a softplus sigma head."""

    def __init__(self, cin: int, zdim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self._conv_mu = nn.Conv3d(cin, zdim, 1)
        # reference layout `_conv_sigma.0` (its softplus is applied below)
        self._conv_sigma = nn.ModuleList([nn.Conv3d(cin, zdim, 1)])

    def forward(self, x: torch.Tensor):
        dt = self.dtype
        x = x.to(dt)
        cm, cs = self._conv_mu, self._conv_sigma[0]
        mu = conv1x1_cl(x, cm.weight) + cm.bias.to(dt)
        sigma = conv1x1_cl(x, cs.weight) + cs.bias.to(dt)
        return mu, softplus(sigma)


class VelocityField(nn.Module):
    """Latent sample -> stationary velocity field.

    depth >= 2: ConvUnit(z -> n0), (depth - 2) ConvUnits, 1x1 conv
    (n0 -> ndims). depth 1: one unpadded k=3 conv. depth 0: identity.
    In eval, a depth-3 head runs as one fused kernel on the card
    (kernels/vel_head.py) and as its plain version on the CPU; in train
    it runs the plain chain of ConvUnits (batch statistics), as the JAX
    package does (its fused head is eval only)."""

    def __init__(self, zdim: int, ndims: int, n0: int, depth: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        if depth == 1:
            ops = [nn.Conv3d(zdim, ndims, 3)]
        elif depth >= 2:
            ops = ([ConvUnit(zdim, n0, dtype)]
                   + [ConvUnit(n0, n0, dtype) for _ in range(depth - 2)]
                   + [nn.Conv3d(n0, ndims, 1)])
        else:
            ops = []
        self._op = nn.ModuleList(ops)

    def head_params(self) -> dict:
        """The depth-3 head's parameters, keyed as kernels/vel_head.py takes them."""
        p = {}
        for i in (1, 2):
            conv, bn = self._op[i - 1]._op
            p.update({f"k{i}": conv.weight, f"b{i}": conv.bias,
                      f"scale{i}": bn.weight, f"bias{i}": bn.bias,
                      f"mean{i}": bn.running_mean, f"var{i}": bn.running_var})
        p["k3"], p["b3"] = self._op[2].weight, self._op[2].bias
        return p

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        if self.depth == 0:
            return z
        if self.depth == 1:
            conv = self._op[0]
            return conv3d_cl(z.to(dt), conv.weight, 0) + conv.bias.to(dt)
        if self.depth == 3 and not train:
            return velocity_head(z.to(dt), self.head_params())
        x = z
        for unit in self._op[:-1]:
            x = unit(x, train=train)
        head = self._op[-1]
        return conv1x1_cl(x, head.weight) + head.bias.to(dt)
