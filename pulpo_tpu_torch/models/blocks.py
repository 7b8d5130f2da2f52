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

Dimension-generic, as the JAX blocks are: `ndims` 3 (volumes,
`nn.Conv3d`) or 2 (slices, `nn.Conv2d`), with the same state_dict
names. Convs run on NCDHW / NCHW views of channels-last tensors (a free
permute: the memory is PyTorch's channels_last layout), but a 3D k = 3,
pad = 1 conv of at most 4 input channels, which runs on the
narrow-conv kernel (`conv_cl`). The eval kernels (velocity head,
posterior head, conv chain, narrow conv) are 3D: a 2D network runs the
library convs, as the JAX package runs XLA's there.

Under spatial sharding (parallel/spatial.py) a conv runs on this
rank's depth slab (a 2D conv on its slab of lines) with a halo, and the
fused eval chains on a halo as deep as the chain (`spatial.conv`,
`spatial.on_halo`); under the
output-channel split (parallel/tp.py) each eval unit computes its
channel slice and the channels are all-gathered before the next conv
(`tp.sequence`, `tp.velocity`).

Not ported: the 96->128 channel pad and the tap-sum conv backward of
the JAX `_RawConv` (TPU workarounds that compute the same function).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from pulpo_tpu_torch.kernels import conv_chain, conv_narrow
from pulpo_tpu_torch.kernels.vel_head import bn_affine, eval_bn, leaky, velocity_head
from pulpo_tpu_torch.parallel import spatial, tp
from pulpo_tpu_torch.parallel.mesh import mean_over


def conv_cl(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """conv2d / conv3d (by x's rank) of a channels-last x by a (O, I, *K)
    weight, in x's dtype. A 3D k = 3, pad = 1 conv of an input with at
    most 4 channels is the narrow-conv kernel's (kernels/conv_narrow.py),
    on every device."""
    if spatial.active():
        return spatial.conv(x, w, pad)
    w = w.to(x.dtype)
    if pad == 1 and conv_narrow.takes(x, w):
        return conv_narrow.conv_narrow(x, w)
    nd = x.dim() - 2
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(x.movedim(-1, 1), w, padding=pad)
    return y.movedim(1, -1)


def conv_module(ndims: int):
    """The library conv module of a network with `ndims` spatial axes."""
    return {2: nn.Conv2d, 3: nn.Conv3d}[ndims]


def conv1x1_cl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv of a channels-last x, as a matmul over channels."""
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
    commits (or drops, when its NaN guard fires). A recomputation of the
    forward in the backward (`replaying`, under remat) records nothing:
    the forward recorded the update, from the same batch.

    Inside `synced(mesh)` (the data-parallel step) a train call averages
    its float32 ``E[x]`` and ``E[x^2]``, as one tensor, over the mesh's
    ranks before it forms the variance: flax's BatchNorm with an
    `axis_name` (a `pmean` of both moments), so every rank normalises
    with the global batch's statistics and records the same running
    update. `nn.SyncBatchNorm` would weight by counts and update with the
    unbiased variance."""

    momentum = 0.9
    _replaying = False  # process-wide: autograd may recompute on its own thread
    _mesh = None  # process-wide, as `_replaying`: the mesh of `synced`

    @classmethod
    @contextlib.contextmanager
    def replaying(cls):
        """Train BatchNorms inside record no running-statistics update."""
        before, cls._replaying = cls._replaying, True
        try:
            yield
        finally:
            cls._replaying = before

    @classmethod
    @contextlib.contextmanager
    def synced(cls, mesh):
        """Train BatchNorms inside take their statistics over `mesh`'s ranks."""
        before, cls._mesh = cls._mesh, mesh
        try:
            yield
        finally:
            cls._mesh = before

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
        mean2 = torch.mean(xf * xf, dims)
        if BatchNorm._mesh is not None:
            mean, mean2 = mean_over(torch.stack([mean, mean2]), BatchNorm._mesh).unbind(0)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        if not BatchNorm._replaying:
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

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, ndims: int = 3):
        super().__init__()
        self.dtype = dtype
        self._op = nn.ModuleList([conv_module(ndims)(cin, cout, 3, padding=1),
                                  BatchNorm(cout)])

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        conv, bn = self._op
        dt = self.dtype
        x = x.to(dt)
        if x2 is None:
            y = conv_cl(x, conv.weight, 1)
        else:
            c1 = x.shape[-1]
            y = conv_cl(x, conv.weight[:, :c1], 1)
            y2 = conv_cl(x2.to(dt), conv.weight[:, c1:], 1)
            if y2.shape[0] != y.shape[0]:
                y2 = tile_rows(y2, y.shape[0])
            y = y + y2
        y = y + conv.bias.to(dt)
        return leaky(bn(y, train))


class ConvSequence(nn.Module):
    """`depth` chained ConvUnits; the first changes the channel count and
    takes the optional split operand x2.

    An eval call without x2 whose input the conv-chain kernel takes (at
    most 8 channels: the encoder's down_block_0) runs as one
    `kernels/conv_chain.conv_chain` (pulpo_tpu/models/blocks.py:216-244)."""

    def __init__(self, cin: int, cout: int, depth: int, dtype: torch.dtype, ndims: int = 3):
        super().__init__()
        self._op = nn.ModuleList(
            [ConvUnit(cin if i == 0 else cout, cout, dtype, ndims) for i in range(depth)])

    def stages(self) -> list[dict]:
        """Each unit's parameters, keyed as kernels/conv_unit.py takes them."""
        out = []
        for unit in self._op:
            conv, bn = unit._op
            out.append({"k": conv.weight, "b": conv.bias, "mean": bn.running_mean,
                        "var": bn.running_var, "scale": bn.weight, "bias": bn.bias})
        return out

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        if tp.active():
            return tp.sequence(self, x, x2, train)
        if x2 is None and not train:
            xt = x.to(self._op[0].dtype)
            stages = self.stages()
            if conv_chain.takes(xt, stages):
                if spatial.active():
                    return spatial.on_halo(lambda t: conv_chain.conv_chain(t, stages), xt,
                                           depth=len(stages))
                return conv_chain.conv_chain(xt, stages)
        for i, unit in enumerate(self._op):
            x = unit(x, x2 if i == 0 else None, train)
        return x


class MuSigmaBlock(nn.Module):
    """Two 1x1 convs: a linear mu head and a softplus sigma head."""

    def __init__(self, cin: int, zdim: int, dtype: torch.dtype, ndims: int = 3):
        super().__init__()
        self.dtype = dtype
        conv = conv_module(ndims)
        self._conv_mu = conv(cin, zdim, 1)
        # reference layout `_conv_sigma.0` (its softplus is applied below)
        self._conv_sigma = nn.ModuleList([conv(cin, zdim, 1)])

    def forward(self, x: torch.Tensor):
        dt = self.dtype
        x = x.to(dt)
        cm, cs = self._conv_mu, self._conv_sigma[0]
        mu = conv1x1_cl(x, cm.weight) + cm.bias.to(dt)
        sigma = conv1x1_cl(x, cs.weight) + cs.bias.to(dt)
        if tp.active():
            mu, sigma = tp.channels(mu, cm), tp.channels(sigma, cs)
        return mu, softplus(sigma)


class VelocityField(nn.Module):
    """Latent sample -> stationary velocity field.

    depth >= 2: ConvUnit(z -> n0), (depth - 2) ConvUnits, 1x1 conv
    (n0 -> ndims). depth 1: one unpadded k=3 conv. depth 0: identity.
    In eval, a 3D depth-3 head runs as one fused kernel on the card
    (kernels/vel_head.py) and as its plain version on the CPU; in train,
    and in 2D (the JAX `vel_head_mode` takes only ndims == 3,
    pulpo_tpu/kernels/vel_head.py:327), it runs the plain chain of
    ConvUnits, as the JAX package does (its fused head is eval only)."""

    def __init__(self, zdim: int, ndims: int, n0: int, depth: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        self.ndims = ndims
        conv = conv_module(ndims)
        if depth == 1:
            ops = [conv(zdim, ndims, 3)]
        elif depth >= 2:
            ops = ([ConvUnit(zdim, n0, dtype, ndims)]
                   + [ConvUnit(n0, n0, dtype, ndims) for _ in range(depth - 2)]
                   + [conv(n0, ndims, 1)])
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
            return conv_cl(z.to(dt), conv.weight, 0) + conv.bias.to(dt)
        if tp.active():
            return tp.velocity(self, z, train)
        if self.depth == 3 and self.ndims == 3 and not train:
            if spatial.active():
                return spatial.on_halo(lambda t: velocity_head(t, self.head_params()),
                                       z.to(dt), depth=2)
            return velocity_head(z.to(dt), self.head_params())
        x = z
        for unit in self._op[:-1]:
            x = unit(x, train=train)
        head = self._op[-1]
        return conv1x1_cl(x, head.weight) + head.bias.to(dt)
