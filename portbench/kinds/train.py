"""Training steps: the port's `train.step.make_train_step`, one step after
another on batches of the pool, with no loader.

Set-up makes the weights and the pool from the run's seed, builds the
kernels, builds one object, the step with its model and Adam state, and
drives it through its first `checked_steps` steps on batches that all
differ: they warm every shape and are what is checked. The window goes
on with the same object. The step's posterior seeds come from the
state's CPU generator, seeded from the run's seed.

Checked, against the plain reference's same steps from the same weights,
batches and seeds (`reference.pulpo_ref.train_steps`): each step's total
loss, as the gap over the sum of its terms' sizes (the first step's, and
the worst step's); the first
step's gradient as Adam got it (its first moment after one step over 1 -
b1), and the change of every parameter and BatchNorm statistic over the
checked steps, each by `compare.leaf_gaps` over the leaves that
`compare.moving_leaves` keeps, the worst, the 90th percentile and the
median leaf's.
The cell's `limits` say which of these it compares.

Traffic keys: `batch`, `pool`, `checked_steps`, `trace_seconds`.
"""

from __future__ import annotations

import torch

from portbench import compare, pool
from portbench.kinds.uq import port_config
from portbench.reference import pulpo_ref as R

SPAN = "step"
UNIT = "steps"


class Driver:
    """One run of the kind. `program`: "port", or a precision of the
    reference put in the port's place (the control)."""

    def __init__(self, model: dict, traffic: dict, seed: int, device, program: str = "port"):
        self.m, self.t, self.seed = model, traffic, int(seed)
        self.dev = torch.device(device)
        self.program = program
        self.batch = int(traffic["batch"])
        self.checked = int(traffic["checked_steps"])
        self.rng_seed = pool.derive(self.seed, "steps")
        self.failed = 0
        self.info: dict = {}

    def batch_at(self, i: int) -> dict:
        n = len(self.pairs)
        rows = [self.pairs[(i * self.batch + r) % n] for r in range(self.batch)]
        return {"x": torch.cat([x for x, _ in rows]), "y": torch.cat([y for _, y in rows])}

    def setup(self) -> None:
        self.weights = pool.make_weights(self.m, self.seed, self.dev)
        self.pairs = pool.make_pairs(tuple(self.m["input_size"]), int(self.t["pool"]),
                                     self.seed, self.dev)
        if self.checked * self.batch > len(self.pairs):
            raise ValueError("the checked steps' rows have to differ: pool too small")
        self.info.update(batch=self.batch, pool=len(self.pairs))
        if self.program != "port":
            batches = [self.batch_at(i) for i in range(self.checked)]
            self.losses, self.grads, after = R.train_steps(
                self.m, self.weights, [(b["x"], b["y"]) for b in batches],
                R.step_seeds(self.rng_seed, self.checked), self.program)
            self.after = after
            return
        from pulpo_tpu_torch.models import PULPoModel
        from pulpo_tpu_torch.train.step import Adam, TrainState, make_train_step

        if self.dev.type == "cuda":
            from pulpo_tpu_torch.kernels import _build

            _build.build_all()
        model = PULPoModel(port_config(self.m), device=self.dev)
        model.load_state_dict(self.weights)
        self.tx = Adam(float(self.m["lr"]))
        self.state = TrainState(step=0, model=model,
                                opt_state=self.tx.init(dict(model.module.named_parameters())),
                                rng=torch.Generator().manual_seed(self.rng_seed))
        self.step = make_train_step(model, self.tx)
        self.losses = []
        for i in range(self.checked):
            self.state, met = self.step(self.state, self.batch_at(i))
            self.losses.append(tuple(float(met[k]) for k in (
                "total_loss", "kl_loss", "reconstruction_loss", "regularization_loss")))
            if i == 0:
                self.grads = {n: v.detach().clone() / (1 - self.tx.b1)
                              for n, v in self.state.opt_state.mu.items()}
        self.after = {n: v.detach().clone() for n, v in model.state_dict().items()}
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run_unit(self, i: int) -> None:
        self.state, _ = self.step(self.state, self.batch_at(self.checked + i))
        self.failed += int(self.state.nan_flag)

    def finish(self, units: int) -> None:
        self._sync()

    def release(self) -> None:
        self.state = self.step = self.tx = None

    def compare(self) -> dict[str, float]:
        """Every gap that the cell may compare: the first step's loss gap
        and the worst step's, and of the first gradient and of the change
        the worst leaf's gap, the 90th percentile leaf's and the median
        leaf's."""
        batches = [self.batch_at(i) for i in range(self.checked)]
        losses, grads, after = R.train_steps(
            self.m, self.weights, [(b["x"], b["y"]) for b in batches],
            R.step_seeds(self.rng_seed, self.checked))
        loss_gaps = [abs(p[0] - r[0]) / max(abs(r[1]) + abs(r[2]) + abs(r[3]), 1e-300)
                     for p, r in zip(self.losses, losses)]
        moving = compare.moving_leaves(grads)
        grad = compare.leaf_gaps(self.grads, grads, moving)
        stats = {n for n in after if n.endswith(("running_mean", "running_var"))}
        delta = lambda s: {n: s[n] - self.weights[n] for n in moving | stats}
        change = compare.leaf_gaps(delta(self.after), delta(after), moving | stats)
        self.info.update(grad_leaf=max(grad, key=grad.get), change_leaf=max(change, key=change.get),
                         left_out=len(grads) - len(moving),
                         losses=[p[0] for p in self.losses], ref_losses=[r[0] for r in losses])
        out = {"loss1_gap": loss_gaps[0], "loss_gap": max(loss_gaps)}
        for name, gaps in (("grad1", grad), ("change", change)):
            out[f"{name}_gap"] = max(gaps.values())
            out[f"{name}_p90_gap"] = compare.quantile(gaps, 0.9)
            out[f"{name}_median_gap"] = compare.quantile(gaps, 0.5)
        return out
