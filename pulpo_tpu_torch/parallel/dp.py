"""Data-parallel training over the ranks of a mesh.

Port of pulpo_tpu/parallel/dp.py:24-65. The JAX package maps its step
over a `data` mesh axis with shard_map; here each rank is a process that
runs the step on its rows of the global batch (train/step.py,
`make_train_step(..., mesh=)`): BatchNorm statistics over the ranks,
draws decorrelated by rank, gradients and metrics averaged in one flat
float32 all-reduce each. The state starts the same everywhere
(`replicate_state`: rank 0's, broadcast) and stays so, since every rank
applies the same averaged update.
"""

from __future__ import annotations

import torch

from pulpo_tpu_torch.models.api import PULPoModel
from pulpo_tpu_torch.parallel.mesh import Mesh, broadcast_
from pulpo_tpu_torch.train.step import Adam, TrainState, make_train_step


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Make every rank's state rank 0's, in place: the weights and
    BatchNorm statistics, the Adam moments and count, the step, the NaN
    latch and the draw generator."""
    model_tensors = list(state.model.module.state_dict(keep_vars=True).values())
    adam = state.opt_state
    moments = [adam.mu[n] for n in sorted(adam.mu)] + [adam.nu[n] for n in sorted(adam.nu)]
    meta = torch.tensor([state.step, adam.count, int(state.nan_flag)], dtype=torch.int64)
    rng = state.rng.get_state()
    broadcast_([t.data for t in model_tensors] + moments + [meta, rng], mesh)
    state.step, adam.count, state.nan_flag = int(meta[0]), int(meta[1]), bool(meta[2])
    state.rng.set_state(rng)
    return state


def make_dp_train_step(model: PULPoModel, tx: Adam, mesh: Mesh):
    """The data-parallel training step: ``step(state, batch, noise=None)
    -> (state, metrics)`` with `batch` (and `noise`) this rank's rows of
    the global batch; the metrics are the means over the ranks."""
    return make_train_step(model, tx, mesh=mesh)
