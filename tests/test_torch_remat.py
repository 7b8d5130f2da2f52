"""Activation recomputation (`remat`, `remat_down`) in the port's
training step, on the CPU (no JAX: the reference is the port's own
plain step).

A checkpointed region computes the same operations again in the
backward, so on the CPU the remat step equals the plain step bit for
bit: the loss, every gradient, the committed BatchNorm statistics and
the parameters after Adam. Each BatchNorm records its running-statistics
update once (in the forward, not again in the recomputation), and the
recomputation does run (more BatchNorm forwards than BatchNorms).
"""

import numpy as np
import pytest
import torch

from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.models.blocks import BatchNorm
from pulpo_tpu_torch.parallel.mesh import in_recomputation, recomputing
from pulpo_tpu_torch.train import create_train_state, make_train_step
from pulpo_tpu_torch.train.step import compute_grads
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4, batch_size=2,
          segs=True, recon_loss=("ncc", "dice"), dice_factor=50)
KNOBS = {"remat": dict(remat=True), "remat_down_0": dict(remat_down=(0,)),
         "remat_down_0_1": dict(remat_down=(0, 1))}


def _batch(seed=0, classes=5):
    rng = np.random.default_rng(seed)
    size = KW["input_size"]
    eye = np.eye(classes, dtype=np.float32)
    return {"x": rng.random((2, *size, 1), dtype=np.float32),
            "y": rng.random((2, *size, 1), dtype=np.float32),
            "seg_x": eye[rng.integers(0, classes, (2, *size))],
            "seg_y": eye[rng.integers(0, classes, (2, *size))]}


def _counting(monkeypatch):
    """Count BatchNorm forwards and the updates they record."""
    counts = {"forwards": 0, "records": 0}
    forward = BatchNorm.forward

    def counted(self, x, train=False):
        before = self.pending
        out = forward(self, x, train)
        counts["forwards"] += train
        counts["records"] += self.pending is not before
        return out

    monkeypatch.setattr(BatchNorm, "forward", counted)
    return counts


def _grads(knob, monkeypatch):
    model = PULPoModel(PULPoConfig(**KW, **knob), device="cpu")
    model.init(0)
    counts = _counting(monkeypatch)
    grads, stats, metrics = compute_grads(model, _batch(), seed=3)
    return model, grads, stats, metrics, counts


@pytest.fixture(scope="module")
def plain():
    mp = pytest.MonkeyPatch()
    try:
        return _grads({}, mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_remat_gradients_and_statistics_equal_the_plain_step(plain, name, monkeypatch):
    model, grads, stats, metrics, counts = _grads(KNOBS[name], monkeypatch)
    _, ref_grads, ref_stats, ref_metrics, ref_counts = plain
    n_bn = len(model.batch_norms())
    assert ref_counts == {"forwards": n_bn, "records": n_bn}
    assert counts["records"] == n_bn  # one update a BatchNorm
    assert counts["forwards"] > n_bn  # the checkpointed regions ran again
    for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
        assert torch.equal(metrics[k], ref_metrics[k]), k
    assert sorted(grads) == sorted(ref_grads)
    for n, g in grads.items():
        assert torch.equal(g, ref_grads[n]), n
    assert sorted(stats) == sorted(ref_stats)
    for n, s in stats.items():
        assert torch.equal(s, ref_stats[n]), n


def _stepped(knob):
    """The state after one training step from seed 0."""
    model = PULPoModel(PULPoConfig(**KW, **knob), device="cpu")
    state, tx = create_train_state(model, seed=0)
    make_train_step(model, tx)(state, _batch())
    assert all(bn.pending is None for bn in model.batch_norms().values())
    return model.state_dict()


@pytest.fixture(scope="module")
def plain_step():
    return _stepped({})


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_remat_step_commits_what_the_plain_step_commits(plain_step, name):
    """The weights after Adam and the committed BatchNorm statistics."""
    got = _stepped(KNOBS[name])
    for n, v in plain_step.items():
        assert torch.equal(got[n], v), n


def test_replaying_records_nothing_and_restores_the_flag():
    bn = BatchNorm(3)
    x = torch.randn(2, 4, 5, 6, 3)
    with recomputing():
        y = bn(x, train=True)
        assert bn.pending is None
    assert not in_recomputation()
    assert torch.equal(bn(x, train=True), y) and bn.pending is not None
    with pytest.raises(AssertionError, match="ran twice"):
        bn(x, train=True)
