"""The output-channel split of the eval forward over a `model` mesh.

Port of pulpo_tpu/parallel/tp.py. The JAX module is a hook: rules that
shard every output-channel-major tensor over a `model` axis, after
which XLA partitions the convs and inserts the collectives. Here the
split is done by hand:

- `param_sharding_rules(model, mesh)`: each tensor of the state_dict
  whose OUTPUT-channel dimension (dim 0 in PyTorch's (O, I, *K) layout;
  the JAX rule reads the last dim of a flax kernel (*K, I, O)) is
  divisible by the axis size n and at least 2n is split along it: conv
  weights and biases, and BatchNorm's scale, bias and running
  statistics, which follow their conv's channels; the rest (the heads of
  3 channels) is replicated. The same tensors as the JAX rule's, name for
  name through `compat.from_jax_variables`;
- `shard_params(model, mesh)` keeps each rank's slice of the split
  tensors, in place;
- under `sharded(mesh)`, each eval unit (conv3^3 + bias, BatchNorm,
  LeakyReLU) computes its channel slice from the whole input, and the
  channels are all-gathered (rank order) before the next conv. The fused
  eval chains cannot fuse across that all-gather: each unit runs alone on
  the conv-unit kernel (`csrc/conv_unit.cu`, the kernel of the posterior
  head #11 and the conv chain #13) at the sliced width, counted in
  `conv_chain.launches`. Its `wgmma` tiling takes any width up to 192
  padded to 16, 32, 64, 96, 128 or 192: the flagship's halves (16 .. 96)
  are template widths. The velocity head #10 fuses its second conv on
  the first's whole output, so under the split its two units run on the
  conv-unit kernel too and its 3-channel 1x1 head, whole, as a float32
  1x1 conv (its plain version's rounding). The posterior head likewise
  runs as its units.

The JAX test covers the eval forward only (`predict_deterministic`), and
so does this port: a train forward under `sharded` raises. Collectives
are all-gathers: NCCL's on the card, gloo's through the host (gloo's
all-gather takes CPU tensors).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from pulpo_tpu_torch.kernels import conv_chain, conv_unit
from pulpo_tpu_torch.kernels.vel_head import _conv_f32
from pulpo_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["make_model_mesh", "param_sharding_rules", "shard_params", "sharded"]

_mesh: Mesh | None = None


def make_model_mesh(n_model: int) -> Mesh:
    """The `model` mesh over the whole world, which must hold n_model ranks."""
    return make_mesh(n_model)


def _splits(t: torch.Tensor, n: int) -> bool:
    return t.is_floating_point() and t.dim() >= 1 and t.shape[0] >= 2 * n \
        and t.shape[0] % n == 0


def param_sharding_rules(model, mesh: Mesh) -> dict[str, int | None]:
    """{state_dict name: 0 (split along dim 0 over the mesh) or None
    (replicated)} for every tensor of `model` (a PULPoModel or a module)
    or of a state_dict."""
    state = model if isinstance(model, dict) else _module(model).state_dict()
    return {name: (0 if _splits(t, mesh.size) else None) for name, t in state.items()}


def _module(model) -> torch.nn.Module:
    return getattr(model, "module", model)


def shard_params(model, mesh: Mesh):
    """Keep this rank's slice of every split tensor of `model`'s weights
    and statistics, in place; returns `model`."""
    rules = param_sharding_rules(model, mesh)
    module = _module(model)
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    with torch.no_grad():
        for name, dim in rules.items():
            if dim is not None:
                t = tensors[name]
                t.data = t.data.chunk(mesh.size, dim)[mesh.rank].clone()
    return model


@contextlib.contextmanager
def sharded(mesh: Mesh):
    """Eval forwards inside compute each split conv's channel slice and
    all-gather the channels (module doc)."""
    global _mesh
    before, _mesh = _mesh, mesh
    try:
        yield
    finally:
        _mesh = before


def active() -> bool:
    return _mesh is not None


def _gather(y: torch.Tensor) -> torch.Tensor:
    """The whole channels of a channels-last slice, all-gathered in rank
    order."""
    if _mesh.size == 1:
        return y
    y = y.contiguous()
    if dist.get_backend(_mesh.group) == "nccl":
        out = y.new_empty((_mesh.size, *y.shape))
        dist.all_gather_into_tensor(out, y, group=_mesh.group)
        parts = out.unbind(0)
    else:  # gloo's all-gather takes CPU tensors
        host = y.cpu()
        parts = [torch.empty_like(host) for _ in range(_mesh.size)]
        dist.all_gather(parts, host, group=_mesh.group)
        parts = [p.to(y.device) for p in parts]
    return torch.cat(parts, dim=-1)


def channels(y: torch.Tensor, conv) -> torch.Tensor:
    """`conv`'s output with all its channels: gathered when its weight is
    split."""
    return _gather(y) if conv.weight.shape[0] != conv.out_channels else y


def _unit(x: torch.Tensor, unit, y2: torch.Tensor | None = None,
          k: torch.Tensor | None = None) -> torch.Tensor:
    """One eval ConvUnit's channel slice, whole channels out: the
    conv-unit kernel on the card, its plain version on the CPU."""
    conv, bn = unit._op
    u = {"k": conv.weight if k is None else k, "b": conv.bias, "mean": bn.running_mean,
         "var": bn.running_var, "scale": bn.weight, "bias": bn.bias}
    if x.device.type == "cpu":
        y = conv_unit.unit_plain(x, u, y2)
    else:
        if not (conv_unit.check_input(x) and conv_unit.check_unit(u, x.shape[-1])):
            raise ValueError(f"conv-unit kernel does not take x {tuple(x.shape)} {x.dtype} "
                             f"with k {tuple(u['k'].shape)}")
        y = conv_unit.launch(x, u, conv_unit.UNIT_ADD if y2 is not None else conv_unit.UNIT,
                             y2=y2)
        conv_chain.launches += 1
    return channels(y, conv)


def _refuse_train(train: bool) -> None:
    if train:
        raise NotImplementedError("the output-channel split covers the eval forward only")


def sequence(seq, x: torch.Tensor, x2: torch.Tensor | None = None,
             train: bool = False) -> torch.Tensor:
    """An eval ConvSequence unit by unit; the first unit's split operand
    x2 (per-pair rows) is convolved by its half of the kernel and added
    in the unit's epilogue."""
    _refuse_train(train)
    from pulpo_tpu_torch.models.blocks import conv_cl

    for i, unit in enumerate(seq._op):
        xt = x.to(unit.dtype)
        if i == 0 and x2 is not None:
            w = unit._op[0].weight
            c1 = xt.shape[-1]
            y2 = conv_cl(x2.to(unit.dtype), w[:, c1:], 1)
            x = _unit(xt, unit, y2, k=w[:, :c1])
        else:
            x = _unit(xt, unit)
    return x


def velocity(vf, z: torch.Tensor, train: bool = False) -> torch.Tensor:
    """An eval VelocityField of depth >= 2: its units, then its 1x1 head
    (3 channels, whole) with the fused head's rounding."""
    _refuse_train(train)
    if vf.depth < 2:
        raise NotImplementedError(f"a velocity head of depth {vf.depth} under the "
                                  "output-channel split")
    x = z
    for unit in vf._op[:-1]:
        x = _unit(x.to(unit.dtype), unit)
    head = vf._op[-1]
    return channels(_conv_f32(x, head.weight, 0) + head.bias.to(x.dtype), head)
