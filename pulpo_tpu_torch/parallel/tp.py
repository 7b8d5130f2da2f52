"""The output-channel split of the model over a `model` mesh.

Port of pulpo_tpu/parallel/tp.py. The JAX module is a hook: rules that
shard every output-channel-major tensor over a `model` axis, after which
XLA partitions any jitted function on params placed with them (the eval
forward and the training step alike) and inserts the collectives. Here
the split is done by hand:

- `param_sharding_rules(model, mesh)`: each tensor of the state_dict
  whose OUTPUT-channel dimension (dim 0 in PyTorch's (O, I, *K) layout;
  the JAX rule reads the last dim of a flax kernel (*K, I, O)) is
  divisible by the axis size n and at least 2n is split along it: conv
  weights and biases, and BatchNorm's scale, bias and running
  statistics, which follow their conv's channels; the rest is
  replicated: the 1x1 heads (mu, sigma and the velocity head's last
  conv) have zdim = ndims channels, fewer than 2n at n >= 2, so they
  never split and run as unsplit. The same tensors as the JAX rule's,
  name for name through `compat.from_jax_variables`;
- `shard_params(model, mesh)` keeps each rank's slice of the split
  tensors, in place, and notes the mesh on the module: `PULPoModel.init`
  (and so `create_train_state`) then draws the unsplit weights from its
  seed and keeps this rank's slice of each;
- under `sharded(mesh)` each ConvUnit (conv3^3 + bias, BatchNorm,
  LeakyReLU) computes its channel slice from the whole input, and the
  channels are all-gathered (rank order) before the next conv. A 3D eval
  unit runs alone on the conv-unit kernel (`csrc/conv_unit.cu`, the
  kernel of the posterior head #11 and the conv chain #13) at the sliced
  width, counted in `conv_chain.launches`: the fused eval chains cannot
  fuse across the all-gather. Its `wgmma` tiling takes any width up to
  192 padded to 16, 32, 64, 96, 128 or 192: the flagship's halves (16 ..
  96) are template widths. A train unit, and every 2D unit, runs as
  `ConvUnit.forward` runs it unsplit, at the slice: `conv_cl` on the
  slice's weight (a 3D conv of <= 4 input channels on the narrow-conv
  kernel #12 at cout n0 / n, a 2D conv the library's), the bias,
  BatchNorm (in train the batch statistics of its own channels, their
  running update left in `pending` on the slice as unsplit) and the
  LeakyReLU. The velocity head #10 fuses its second conv on the first's
  whole output, so under the split its units run alone too, then its
  1x1 head: in 3D eval as a float32 1x1 conv (the fused head's
  rounding), in train and in 2D as the unsplit chain's matmul. The
  posterior head likewise runs as its units.

Training: Megatron's pair of differentiable collectives. `copy_in` (the
identity; its backward sums the cotangent over the ranks) stands on the
input of every split conv, the gather-out `channels` (the all-gather;
its backward keeps this rank's channel slice) on its output. Why not a reduce-scatter
in the gather's backward: one activation feeds split convs and also
replicated consumers (the losses, the skip and feedback paths, the
1x1 heads). A split conv gives each rank a partial cotangent of
its input, a replicated consumer every rank the same whole one; the
pair sums the partials alone (in `copy_in`, before the replicated terms
join) and slices the whole cotangent of a gathered output, where a
reduce-scatter would sum the replicated terms n times. The replicated
leaves' gradients are not averaged over the ranks: every rank computes
them from the same inputs by the same operations (#2's scatter is
order-free), and they come out bit-equal, so the weights stay one;
chip_smoke.py phase 11h and tests/test_torch_tp.py hold the ranks'
replicated gradients and updated weights bit-equal.

How the split trains (the JAX hook's use; no other entry point):

    mesh = tp.make_model_mesh(n)
    tp.shard_params(model, mesh)
    state, tx = create_train_state(model)   # Adam moments on the slices
    with tp.sharded(mesh):
        step = make_train_step(model, tx)
        state, metrics = step(state, batch)

Every rank takes the whole batch, and draws the same noise (the state's
generator is seeded alike). Adam is elementwise, so it stays on each
rank's slices; the NaN flag and the metrics come from replicated fields,
so every rank computes the same.

Remat: a checkpointed region recomputes in the backward under the mesh
its forward saw (`snapshot`, then `sharded`; models/pulpo.py:remat), so
it issues the forward's all-gathers again, in the same order on every
rank (every rank's autograd replays the same graph); `traffic` counts
them apart ("<kind>_recomputed", mesh.py:`recomputing`).

Collectives: NCCL's on the card, else gloo's: the all-reduces are
mesh.py's (a copy of the cotangent on the collective's device), the
all-gather goes through the host under gloo (its all-gather takes CPU
tensors).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from pulpo_tpu_torch.kernels import conv_chain, conv_unit
from pulpo_tpu_torch.kernels.vel_head import _conv_f32
from pulpo_tpu_torch.parallel.mesh import Mesh, Traffic, _all_reduce_mean, make_mesh

__all__ = ["make_model_mesh", "param_sharding_rules", "shard_params", "sharded", "traffic",
           "reset_traffic"]

_mesh: Mesh | None = None

# bytes and calls of each exchange on this rank since `reset_traffic`:
# "gather" (the channel all-gathers of split outputs; bytes the gathered
# buffer's), "reduce" (the all-reduces of a split conv's input cotangent
# and of the replicated leaves' gradients; bytes the reduced buffer's); a
# checkpointed region's recomputation counts its gathers apart,
# "gather_recomputed"
traffic = Traffic()
reset_traffic = traffic.clear


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
    and statistics, in place, and note on the module the mesh (`tp_mesh`)
    and the names of the split tensors (`tp_split`); returns `model`."""
    rules = param_sharding_rules(model, mesh)
    module = _module(model)
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    with torch.no_grad():
        for name, dim in rules.items():
            if dim is not None:
                t = tensors[name]
                t.data = t.data.chunk(mesh.size, dim)[mesh.rank].clone()
    module.tp_mesh = mesh
    module.tp_split = frozenset(n for n, d in rules.items() if d is not None)
    return model


def own_slice(whole: torch.Tensor, like: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's slice of `whole` along dim 0 where `like` holds one
    (a tensor that `shard_params` split over `mesh`), else `whole`."""
    if like.shape[0] == whole.shape[0]:
        return whole
    return whole.chunk(mesh.size, 0)[mesh.rank]


@contextlib.contextmanager
def sharded(mesh: Mesh | None):
    """Forwards inside (eval and train) compute each split conv's channel
    slice and all-gather the channels (module doc); `None` turns the
    split off."""
    global _mesh
    before, _mesh = _mesh, mesh
    try:
        yield
    finally:
        _mesh = before


def snapshot() -> Mesh | None:
    """The mesh in force, for a checkpointed region to recompute under
    (`sharded`): the mesh is process-wide, and autograd may recompute on
    its own thread, so the recomputation sets it rather than trusting it."""
    return _mesh


def active() -> bool:
    return _mesh is not None


def split(conv) -> bool:
    """Whether `conv`'s weight holds a slice of its output channels."""
    return conv.weight.shape[0] != conv.out_channels


def _all_gather(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole channels of a channels-last slice, all-gathered in rank
    order."""
    y = y.contiguous()
    traffic.count("gather", y.numel() * y.element_size() * mesh.size)
    if dist.get_backend(mesh.group) == "nccl":
        out = y.new_empty((mesh.size, *y.shape))
        dist.all_gather_into_tensor(out, y, group=mesh.group)
        parts = out.unbind(0)
    else:  # gloo's all-gather takes CPU tensors
        host = y.cpu()
        parts = [torch.empty_like(host) for _ in range(mesh.size)]
        dist.all_gather(parts, host, group=mesh.group)
        parts = [p.to(y.device) for p in parts]
    return torch.cat(parts, dim=-1)


class _CopyIn(torch.autograd.Function):
    """The identity, with the sum of the cotangents over the ranks as its
    backward: the input of a split conv."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        traffic.count("reduce", g.numel() * g.element_size())
        return _all_reduce_mean(g, ctx.mesh, mean=False), None


class _GatherOut(torch.autograd.Function):
    """The channel all-gather, with this rank's channel slice of the
    cotangent as its backward: the output of a split conv."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return _all_gather(y, mesh)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.mesh.size, -1)[ctx.mesh.rank], None


def copy_in(x: torch.Tensor, conv) -> torch.Tensor:
    """`x` as the input of `conv`: through `_CopyIn` where `conv` is split
    under `sharded`, else `x` itself."""
    if _mesh is None or not split(conv):
        return x
    return _CopyIn.apply(x, _mesh)


def channels(y: torch.Tensor, conv) -> torch.Tensor:
    """`conv`'s output with all its channels: gathered (`_GatherOut`) where
    its weight is split."""
    if _mesh is None or not split(conv):
        return y
    return _GatherOut.apply(y, _mesh)


def _unit(x: torch.Tensor, unit, x2: torch.Tensor | None = None,
          train: bool = False) -> torch.Tensor:
    """One ConvUnit's channel slice, whole channels out. A 3D eval unit on
    the conv-unit kernel on the card (its plain version on the CPU); a
    train or 2D unit as `ConvUnit.forward`, between `copy_in` and
    `channels` (module doc)."""
    conv, bn = unit._op
    if train or x.dim() != 5:
        x2 = None if x2 is None else copy_in(x2, conv)
        return channels(unit(copy_in(x, conv), x2, train), conv)
    xt = x.to(unit.dtype)
    k, y2 = conv.weight, None
    if x2 is not None:  # the split operand: its half of the kernel, added in the epilogue
        from pulpo_tpu_torch.models.blocks import conv_cl

        c1 = xt.shape[-1]
        k, y2 = conv.weight[:, :c1], conv_cl(x2.to(unit.dtype), conv.weight[:, c1:], 1)
    u = {"k": k, "b": conv.bias, "mean": bn.running_mean, "var": bn.running_var,
         "scale": bn.weight, "bias": bn.bias}
    if xt.device.type == "cpu":
        y = conv_unit.unit_plain(xt, u, y2)
    else:
        if not (conv_unit.check_input(xt) and conv_unit.check_unit(u, xt.shape[-1])):
            raise ValueError(f"conv-unit kernel does not take x {tuple(xt.shape)} {xt.dtype} "
                             f"with k {tuple(u['k'].shape)}")
        y = conv_unit.launch(xt, u, conv_unit.UNIT_ADD if y2 is not None else conv_unit.UNIT,
                             y2=y2)
        conv_chain.launches += 1
    return channels(y, conv)


def sequence(seq, x: torch.Tensor, x2: torch.Tensor | None = None,
             train: bool = False) -> torch.Tensor:
    """A ConvSequence unit by unit (`_unit`); the first unit's split
    operand x2 (per-pair rows) is convolved by its half of the kernel."""
    for i, unit in enumerate(seq._op):
        x = _unit(x, unit, x2 if i == 0 else None, train)
    return x


def velocity(vf, z: torch.Tensor, train: bool = False) -> torch.Tensor:
    """A VelocityField of depth >= 2: its units (`_unit`), then its 1x1
    head (ndims channels, never split): with the fused head's rounding in
    3D eval, as the unsplit plain chain in train and in 2D."""
    x = z
    for unit in vf._op[:-1]:
        x = _unit(x.to(unit.dtype), unit, train=train)
    head = vf._op[-1]
    if train or x.dim() != 5:
        from pulpo_tpu_torch.models.blocks import conv1x1_cl

        return conv1x1_cl(x, head.weight) + head.bias.to(vf.dtype)
    return _conv_f32(x, head.weight, 0) + head.bias.to(x.dtype)
