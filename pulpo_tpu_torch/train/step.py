"""Training and evaluation steps.

Port of pulpo_tpu/train/step.py:26-187 (the reference's Lightning
training_step / validation_step / configure_optimizers):
``loss = beta * KL + recon + reg``, Adam at the config's lr with optax's
arithmetic, and the sticky NaN guard.

The model holds its weights (a `PULPoModel`); a step updates them and
the optimizer state in place and returns the state with its metrics.
Each step draws its posterior noise from a seed that it takes from the
state's generator, as the JAX step splits its key; `noise=` replaces the
draws (the tests feed the JAX package's).

Data parallelism (`axis_name` in the JAX package, `mesh` here; built by
parallel/dp.py): every rank runs the step on its rows of the global
batch with the same weights. Its train BatchNorms take the global
batch's statistics (`BatchNorm.synced`), its draws come from the step's
seed folded with its rank, and after the backward its gradients and
floating metrics (the NaN flag as a float) are averaged over the ranks
in one flat float32 all-reduce each, JAX's `pmean`. The weights, Adam
state and running statistics therefore stay the same on every rank.
The model is not wrapped in DDP: `compute_grads` takes its gradients
with `torch.autograd.grad`, which DDP's backward hooks do not see.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.models.api import PULPoModel, _as_tensor, transform_segmentation
from pulpo_tpu_torch.models.blocks import BatchNorm
from pulpo_tpu_torch.models.pulpo import prior_like
from pulpo_tpu_torch.ops import losses as L
from pulpo_tpu_torch.parallel import spatial
from pulpo_tpu_torch.parallel.mesh import Mesh, bucket_mean, fold_in

LevelDict = dict[int, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the step count and both moments."""
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), in optax's
    order: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, the
    float32 bias corrections ``1 - b**count``, then
    ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamState,
               params: dict[str, torch.Tensor]) -> None:
        """Apply one step to `params` and `state`, in place."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        bc1 = float(1 - np.float32(b1) ** np.float32(count))
        bc2 = float(1 - np.float32(b2) ** np.float32(count))
        for name, p in params.items():
            g = grads[name]
            mu = (1 - b1) * g + b1 * state.mu[name]
            nu = (1 - b2) * (g * g) + b2 * state.nu[name]
            state.mu[name], state.nu[name] = mu, nu
            p.add_(-self.lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)))
        state.count = count


@dataclasses.dataclass
class TrainState:
    """What a step reads and advances. The weights and BatchNorm
    statistics live in `model`; `rng` is a CPU generator from which each
    step draws its sample seed. `nan_flag` is the sticky NaN latch."""
    step: int
    model: PULPoModel
    opt_state: AdamState
    rng: torch.Generator
    nan_flag: bool = False

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.module.named_parameters())


def create_train_state(model: PULPoModel, seed: int = 0) -> tuple[TrainState, Adam]:
    """Initialise the model's weights from `seed`, a fresh Adam state (no
    schedule, decay or clipping, as the reference) and the draw generator."""
    model.init(seed)
    tx = Adam(model.cfg.lr)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.module.named_parameters())),
                       rng=torch.Generator().manual_seed(int(seed)))
    return state, tx


def compute_losses(cfg: PULPoConfig, outs: tuple, x: torch.Tensor, y: torch.Tensor,
                   seg_x: torch.Tensor | None, seg_y: torch.Tensor | None):
    """beta*KL + recon + reg with per-level breakdowns; returns (total, metrics)."""
    (post_mus, post_sigmas, _samples, _vf, _ind, _comb, final_dfs, y_hat) = outs
    prior_mus, prior_sigmas = prior_like(post_mus, post_sigmas)
    y_hat_seg = (transform_segmentation(cfg, final_dfs, seg_x)
                 if "dice" in cfg.recon_loss else None)

    kl_loss, kl_levels = L.hierarchical_kl_loss(
        prior_mus, prior_sigmas, post_mus, post_sigmas, cfg.kl_weight_dict,
        nondiagonal=cfg.nondiagonal, prior_lambda=cfg.prior_lambda)
    kl_loss = kl_loss * cfg.beta
    kl_levels = {l: cfg.beta * v for l, v in kl_levels.items()}
    recon_loss, recon_levels = L.hierarchical_reconstruction_loss(
        y_hat, y, cfg.recon_weight_dict, cfg.recon_loss, cfg.window_size,
        gamma=cfg.gamma, dice_factor=cfg.dice_factor, y_hat_seg=y_hat_seg, seg_y=seg_y)
    reg_loss, reg_levels = L.hierarchical_regularization(
        final_dfs, cfg.regularization_weight_dict, regularizer=cfg.regularizer,
        lamb=cfg.lamb)
    total = kl_loss + recon_loss + reg_loss

    d = lambda t: t.detach()
    # under spatial sharding a rank's share, summed over the column (parallel/spatial.py)
    mean = spatial.partial_mean if spatial.active() else torch.mean
    metrics = {
        "kl_loss": d(kl_loss),
        "reconstruction_loss": d(recon_loss),
        "regularization_loss": d(reg_loss),
        "total_loss": d(total),
        "levels/kl": {l: d(v) for l, v in kl_levels.items()},
        "levels/recon": {l: d(v) for l, v in recon_levels.items()},
        "levels/reg": {l: d(v) for l, v in reg_levels.items()},
        "levels/mean_posterior_mu": {l: d(mean(v)) for l, v in post_mus.items()},
        "levels/mean_posterior_sigma": {l: d(mean(v)) for l, v in post_sigmas.items()},
        # NaN guard (reference models.py:188-194): NaN in any level's reg loss
        "nan_flag": sum(torch.isnan(d(v)).sum() for v in reg_levels.values()) > 0,
    }
    return total, metrics


def _batch_tensors(model: PULPoModel, batch: dict):
    dev = model.device
    get = lambda k: None if batch.get(k) is None else _as_tensor(batch[k], dev)
    return get("x"), get("y"), get("seg_x"), get("seg_y")


def compute_grads(model: PULPoModel, batch: dict, seed: int = 0,
                  noise: LevelDict | None = None):
    """One train forward and backward at the model's current weights.
    Returns (gradients by parameter name, the new BatchNorm statistics
    (uncommitted), metrics). A parameter the loss does not reach gets a
    zero gradient, as jax.grad gives. Under the output-channel split
    (parallel/tp.py) a split parameter's gradient is this rank's slice,
    and a replicated one's the whole, the same bits on every rank."""
    cfg = model.cfg
    x, y, seg_x, seg_y = _batch_tensors(model, batch)
    outs, new_stats = model.apply_train(x, y, seed=seed, noise=noise)
    total, metrics = compute_losses(cfg, outs, x, y, seg_x, seg_y)
    named = dict(model.module.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    return grads, new_stats, metrics


def _flat_metrics(metrics: dict) -> list[tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every metric, nested level dicts included, in a
    fixed order (the same on every rank)."""
    out = []
    for k in sorted(metrics):
        v = metrics[k]
        if isinstance(v, dict):
            out += [((k, l), v[l]) for l in sorted(v)]
        else:
            out.append(((k,), v))
    return out


def mean_metrics(metrics: dict, mesh: Mesh) -> dict:
    """The metrics averaged over the ranks (JAX's `pmean` of the floating
    ones), the NaN flag as a float: any rank's NaN makes it positive on
    every rank."""
    flat = _flat_metrics(metrics)
    means = bucket_mean([v.float() for _, v in flat], mesh)
    out: dict = {}
    for (path, _), v in zip(flat, means):
        if len(path) == 1:
            out[path[0]] = v
        else:
            out.setdefault(path[0], {})[path[1]] = v
    return out


def dp_compute_grads(model: PULPoModel, batch: dict, mesh: Mesh, seed: int = 0,
                     noise: LevelDict | None = None):
    """`compute_grads` on this rank's rows with BatchNorm statistics over
    the mesh, then the gradients and metrics averaged over the ranks: the
    gradient of the mean of the ranks' losses, as the JAX data-parallel
    step takes it. `seed` and `noise` are this rank's."""
    with BatchNorm.synced(mesh):
        grads, new_stats, metrics = compute_grads(model, batch, seed, noise)
    names = list(grads)
    grads = dict(zip(names, bucket_mean([grads[n] for n in names], mesh)))
    return grads, new_stats, mean_metrics(metrics, mesh)


def make_train_step(model: PULPoModel, tx: Adam, mesh: Mesh | None = None):
    """The training step: ``train_step(state, batch, noise=None) ->
    (state, metrics)``, updating `state` (and the model's weights) in
    place. `batch` holds "x", "y" (B, *input_size, 1) and, with a dice
    loss, "seg_x", "seg_y".

    With a `mesh` (parallel/dp.py:make_dp_train_step) `batch` and `noise`
    are this rank's rows, and the step is the data-parallel one (module
    doc)."""
    if mesh is None:
        return make_step(model, tx, lambda batch, seed, noise: compute_grads(
            model, batch, seed, noise))
    # decorrelate the ranks' posterior draws (the JAX step's fold_in of
    # axis_index)
    return make_step(model, tx, lambda batch, seed, noise: dp_compute_grads(
        model, batch, mesh, fold_in(seed, mesh.rank), noise))


def make_step(model: PULPoModel, tx: Adam, compute):
    """The step around ``compute(batch, seed, noise) -> (grads,
    new_stats, metrics)`` (the gradients and metrics as the update takes
    them): the seed from the state's generator, the NaN latch, the update
    and the BatchNorm statistics' commit."""

    def train_step(state: TrainState, batch: dict, noise: LevelDict | None = None):
        seed = int(torch.randint(0, 2**62, (1,), generator=state.rng))
        grads, new_stats, metrics = compute(batch, seed, noise)
        # The NaN guard is a sticky latch, as in the JAX step: once a step
        # has seen a NaN, params, Adam state and BatchNorm statistics stay
        # frozen while `step` and the generator still advance. The flag is
        # read on the host here, once per step (one device sync).
        flag = state.nan_flag or bool(metrics["nan_flag"])
        metrics["nan_flag"] = torch.tensor(flag)
        if not flag:
            tx.update(grads, state.opt_state, state.params)
            model.commit_batch_stats(new_stats)
        state.step += 1
        state.nan_flag = flag
        return state, metrics

    return train_step


def make_eval_step(model: PULPoModel):
    """Validation: the same losses with eval BatchNorm and still
    stochastic sampling (the reference's validation_step samples too).
    ``eval_step(batch, seed=0, noise=None) -> (metrics, images)``."""
    cfg = model.cfg

    @torch.inference_mode()
    def eval_step(batch: dict, seed: int = 0, noise: LevelDict | None = None):
        x, y, seg_x, seg_y = _batch_tensors(model, batch)
        outs = model.apply_eval(x, y, seed=seed, noise=noise)
        _, metrics = compute_losses(cfg, outs, x, y, seg_x, seg_y)
        images = {
            "y_pred": outs[7][0],
            "final_df": outs[6][0],
            "levels/y_hat": outs[7],
            "levels/individual_dfs": outs[4],
            "levels/final_dfs": outs[6],
        }
        return metrics, images

    return eval_step
