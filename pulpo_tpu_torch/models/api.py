"""High-level model API: construction, init, forward, prediction, df
composition.

Port of pulpo_tpu/models/api.py:34-76, 127-267. The model holds its
weights (a `PULPoModule`); `state_dict()` uses the reference
checkpoint's names. Everything runs on `cuda` unless the caller passes
`device="cpu"`; without a card and without that, construction raises.
The prediction entry points run under `torch.inference_mode`;
`apply_train` builds the autograd graph (train/step.py drives it).
"""

from __future__ import annotations

import torch

from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.models.blocks import BatchNorm
from pulpo_tpu_torch.models.pulpo import PULPoModule
from pulpo_tpu_torch.ops.resize import avg_pool_ceil
from pulpo_tpu_torch.ops.warp import (
    batched_level_warp,
    integrate_svf,
    integrate_svf_cf,
    resize_vecfield,
    resize_vecfield_cf,
    warp_image,
)
from pulpo_tpu_torch.parallel import tp

LevelDict = dict[int, torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; raises for `cuda` without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the port's plain PyTorch path on the CPU")
    return dev


def _warp_levels(moving: torch.Tensor, dfs: LevelDict) -> LevelDict:
    """Per-level warps of one moving image, batched into one call when
    every level's df has the same shape (full_res)."""
    if len({tuple(dfs[l].shape) for l in dfs}) == 1:
        return batched_level_warp(moving, dfs)
    return {l: warp_image(moving.float(), dfs[l]) for l in dfs}


def _accumulate(cfg: PULPoConfig, individual_dfs: LevelDict) -> LevelDict:
    """Coarse-to-fine: each level's df plus its parent's combined df,
    resized to the level."""
    combined: LevelDict = {}
    K = cfg.latent_levels
    for l in reversed(range(K)):
        if l + 1 in combined:
            in_sz = individual_dfs[l].shape[1:-1]
            parent_sz = individual_dfs[l + 1].shape[1:-1]
            vel_resize = 1.0 / (in_sz[0] / parent_sz[0])
            combined[l] = individual_dfs[l] + resize_vecfield(
                combined[l + 1], vel_resize, out_size=tuple(in_sz))
        else:
            combined[l] = individual_dfs[l]
    return combined


def combine_dfs(cfg: PULPoConfig, individual_dfs: LevelDict) -> tuple[LevelDict, LevelDict]:
    """Coarse-to-fine accumulate, then integrate each level. The mean SVF
    is integrated, not the mean of integrated fields: callers average the
    individual dfs first."""
    combined = _accumulate(cfg, individual_dfs)
    final: LevelDict = {}
    for l in reversed(range(cfg.latent_levels)):
        integ = integrate_svf(combined[l].float(), nsteps=cfg.nsteps)
        cur_sz = integ.shape[1:-1]
        target = (cfg.input_size if (l == 0 or cfg.df_resolution == "full_res")
                  else tuple(cur_sz))
        vel_resize = 1.0 / (target[0] / cur_sz[0])
        final[l] = resize_vecfield(integ, vel_resize, out_size=target)
    return combined, final


def combine_dfs_cf(cfg: PULPoConfig, individual_dfs: LevelDict) -> tuple[LevelDict, LevelDict]:
    """`combine_dfs` with every level integrated and resized on
    channels-first memory (pulpo_tpu/models/api.py:79-124; full_res
    only): the finals are (B, 3, *input_size), ready for
    `batched_level_warp_cf`. Equal bit for bit to `combine_dfs`'s."""
    assert cfg.df_resolution == "full_res", "CF finals need full_res dfs"
    combined = _accumulate(cfg, individual_dfs)
    final: LevelDict = {}
    for l in reversed(range(cfg.latent_levels)):
        cur_sz = combined[l].shape[1:-1]
        integ = integrate_svf_cf(combined[l].float().permute(0, 4, 1, 2, 3), nsteps=cfg.nsteps)
        final[l] = resize_vecfield_cf(integ, 1.0 / (cfg.input_size[0] / cur_sz[0]),
                                      cfg.input_size)
    return combined, final


def transform_segmentation(cfg: PULPoConfig, dfs: LevelDict, seg: torch.Tensor) -> LevelDict:
    """Warp a segmentation pyramid by the per-level final dfs
    (pulpo_tpu/models/api.py:127-144): level 0 at the input resolution,
    level l > 0 the ceil-mode average-pooled pyramid under level_res.

    Under spatial sharding (parallel/spatial.py) the pyramid pools this
    rank's slab (locally between split levels) and each level's warp
    all-gathers that level's map for its slab launch. Gathering the
    level-0 map once and pooling the whole pyramid from it would move 2 %
    fewer bytes (the pooled levels are 1/64 and less of it) but pool the
    whole map on every rank, so each level gathers its own."""
    if cfg.df_resolution == "full_res":
        return _warp_levels(seg, dfs)
    level_seg: LevelDict = {}
    h = seg
    for _ in range(cfg.lk_offset):
        h = avg_pool_ceil(h)
    prev = h
    for l in range(1, cfg.latent_levels):
        prev = avg_pool_ceil(prev)
        level_seg[l] = prev
    level_seg[0] = seg
    return {l: warp_image(level_seg[l].float(), dfs[l]) for l in dfs}


def _as_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.float32)


class PULPoModel:
    """The model: config, weights, the train forward and the prediction
    entry points.

    `dtype` defaults to the config's compute_dtype. Inputs are
    channels-last (B, *input_size, 1), numpy arrays or tensors."""

    def __init__(self, cfg: PULPoConfig, dtype: torch.dtype | None = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if dtype is None:
            dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.dtype = dtype
        self.module = PULPoModule(cfg, self.dtype).to(self.device).eval()
        # measured decode bytes per posterior sample, by (input shape,
        # batch) — filled by uq.predict's chunk choice on the card
        self.decode_bytes: dict[tuple, int] = {}

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """Re-initialise the weights from `seed`, as PyTorch initialises
        convs (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel and bias) and
        BatchNorm (scale 1, bias 0, mean 0, var 1). On weights split by
        `parallel.tp.shard_params` each rank keeps its slice of the
        unsplit draw. Returns the state_dict."""
        g = torch.Generator().manual_seed(int(seed))
        mesh = getattr(self.module, "tp_mesh", None)
        with torch.no_grad():
            for name, m in self.module.named_modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
                    bound = 1.0 / float(m.weight[0].numel()) ** 0.5
                    for p in (m.weight, m.bias):
                        whole = torch.empty(m.out_channels, *p.shape[1:])
                        p.copy_(tp.own_slice(whole.uniform_(-bound, bound, generator=g), p,
                                             mesh))
                elif hasattr(m, "running_var"):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        self.decode_bytes.clear()
        return self.state_dict()

    def state_dict(self) -> dict:
        return self.module.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.module.load_state_dict(state_dict, strict=True)
        self.decode_bytes.clear()

    # ------------------------------------------------------------------
    def batch_norms(self) -> dict[str, BatchNorm]:
        """Every BatchNorm of the network, by its state_dict prefix."""
        return {name: m for name, m in self.module.named_modules()
                if isinstance(m, BatchNorm)}

    def apply_train(self, x, y, seed: int = 0, noise: LevelDict | None = None):
        """The stochastic train forward (batch statistics), with autograd.

        Returns (the 8 per-level output dicts, the new BatchNorm running
        statistics keyed by state_dict name). The buffers are left as they
        were: `commit_batch_stats` applies the new statistics, which the
        training step does only when its NaN guard has not fired."""
        x, y = _as_tensor(x, self.device), _as_tensor(y, self.device)
        bns = self.batch_norms()
        for bn in bns.values():
            bn.pending = None
        try:
            outs = self.module(x, y, deterministic=False, seed=seed, noise=noise,
                               train=True)
            stats = {}
            for name, bn in bns.items():
                stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = bn.pending
        finally:
            for bn in bns.values():
                bn.pending = None
        return outs, stats

    @torch.no_grad()
    def commit_batch_stats(self, stats: dict[str, torch.Tensor]) -> None:
        """Copy new running statistics (from `apply_train`) into the buffers."""
        buffers = dict(self.module.named_buffers())
        for name, value in stats.items():
            buffers[name].copy_(value)

    @torch.inference_mode()
    def apply_eval(self, x, y, deterministic: bool = False, seed: int = 0,
                   noise: LevelDict | None = None):
        """The eval forward; returns the 8 per-level output dicts."""
        x, y = _as_tensor(x, self.device), _as_tensor(y, self.device)
        return self.module(x, y, deterministic=deterministic, seed=seed, noise=noise)

    def transform_segmentation(self, dfs: LevelDict, seg) -> LevelDict:
        return transform_segmentation(self.cfg, dfs, _as_tensor(seg, self.device))

    def predict_deterministic(self, x, y):
        """Decode the posterior means; returns (transformed, individual_dfs)."""
        outs = self.apply_eval(x, y, deterministic=True)
        return outs[7], outs[4]

    @torch.inference_mode()
    def predict_output_samples(self, x, y, N: int, seed: int = 0,
                               noise: LevelDict | None = None):
        """N posterior draws folded into the batch axis; returns
        (outputs, individual_dfs) with leading (B, N, ...) axes."""
        x, y = _as_tensor(x, self.device), _as_tensor(y, self.device)
        acts = self.module.encode(x, y)
        outs = self.module.decode(x, acts, n_samples=N, seed=seed, noise=noise)
        b = x.shape[0]
        swap = lambda d: {k: v.reshape(N, b, *v.shape[1:]).transpose(0, 1)
                          for k, v in d.items()}
        return swap(outs[7]), swap(outs[4])

    @torch.inference_mode()
    def predict(self, x, y, N: int, seed: int = 0, noise: LevelDict | None = None):
        """Mean-SVF prediction: average the N individual dfs, combine and
        integrate once, warp once per level."""
        _, individual_dfs = self.predict_output_samples(x, y, N, seed, noise)
        avg_dfs = {k: v.mean(dim=1) for k, v in individual_dfs.items()}
        _, avg_final = combine_dfs(self.cfg, avg_dfs)
        x = _as_tensor(x, self.device)
        return _warp_levels(x, avg_final), avg_dfs

    @property
    def param_count(self) -> int:
        return sum(p.numel() for p in self.module.parameters())
