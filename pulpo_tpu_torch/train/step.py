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

Data parallelism (`axis_name` in the JAX package) is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.models.api import PULPoModel, _as_tensor, transform_segmentation
from pulpo_tpu_torch.models.pulpo import prior_like
from pulpo_tpu_torch.ops import losses as L

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
    metrics = {
        "kl_loss": d(kl_loss),
        "reconstruction_loss": d(recon_loss),
        "regularization_loss": d(reg_loss),
        "total_loss": d(total),
        "levels/kl": {l: d(v) for l, v in kl_levels.items()},
        "levels/recon": {l: d(v) for l, v in recon_levels.items()},
        "levels/reg": {l: d(v) for l, v in reg_levels.items()},
        "levels/mean_posterior_mu": {l: d(v.mean()) for l, v in post_mus.items()},
        "levels/mean_posterior_sigma": {l: d(v.mean()) for l, v in post_sigmas.items()},
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
    zero gradient, as jax.grad gives."""
    cfg = model.cfg
    x, y, seg_x, seg_y = _batch_tensors(model, batch)
    outs, new_stats = model.apply_train(x, y, seed=seed, noise=noise)
    total, metrics = compute_losses(cfg, outs, x, y, seg_x, seg_y)
    named = dict(model.module.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    return grads, new_stats, metrics


def make_train_step(model: PULPoModel, tx: Adam):
    """The training step: ``train_step(state, batch, noise=None) ->
    (state, metrics)``, updating `state` (and the model's weights) in
    place. `batch` holds "x", "y" (B, *input_size, 1) and, with a dice
    loss, "seg_x", "seg_y"."""

    def train_step(state: TrainState, batch: dict, noise: LevelDict | None = None):
        seed = int(torch.randint(0, 2**62, (1,), generator=state.rng))
        grads, new_stats, metrics = compute_grads(model, batch, seed, noise)
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
