"""The PULPo hierarchical probabilistic registration network.

Port of pulpo_tpu/models/pulpo.py:45-502:

- DownPath: a shared conv encoder over concat(moving, fixed); per global
  level k a ConvSequence(depth 3), then ceil-mode average pooling.
- Autoencoder: the hierarchical VAE decoded coarse to fine. At each
  latent level a posterior head gives (mu, sigma), a sample is drawn, and
  an SVF decoder turns it into a velocity field that is added to the
  upscaled parent field, integrated (float32 whatever the compute dtype)
  and used to warp the moving-image pyramid.

S posterior samples are folded into the batch axis, sample-major
((S, B) flattened to S*B). The per-pair tensors (pyramid, down
activations, the coarsest posterior, the activation half of each merge
conv) are computed once per pair and broadcast.

Noise: each sample's draw at each level comes from its own generator,
seeded from (seed, sample index, level) only, so a result does not
depend on how a caller chunks its samples. `noise` overrides the draws
(a test hook: the tests feed the JAX package's draws).

`train` selects BatchNorm's batch statistics (and their pending
running update) over the running ones, and the plain velocity head over
the fused kernel, as in the JAX package. `cfg.remat` / `cfg.remat_down`
(recompute activations in the backward) are not ported yet: a train
forward with either set raises.

Outputs are dicts keyed by latent level, channels-last.
"""

from __future__ import annotations

import torch
from torch import nn

from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.models.blocks import ConvSequence, MuSigmaBlock, VelocityField, tile_rows
from pulpo_tpu_torch.ops.resize import avg_pool_ceil, resize_linear
from pulpo_tpu_torch.ops.warp import (
    batched_level_warp,
    integrate_svf,
    resize_vecfield,
    warp_image,
)

LevelDict = dict[int, torch.Tensor]

_IMAGE_CHANNELS = 1  # moving and fixed are single-channel volumes


def feedback_channels(cfg: PULPoConfig) -> int:
    """Channels of the concatenated feedback tensors (up_block input)."""
    per = {"samples": cfg.zdim, "transformed": _IMAGE_CHANNELS}
    return sum(per.get(item, cfg.ndims) for item in cfg.feedback)


def sample_seed(seed: int, sample: int, level: int) -> int:
    """Generator seed of one (sample, level) draw."""
    return ((int(seed) * 1_000_003 + int(sample)) * 1_009 + int(level)) % (2**63)


def draw_normal(seed: int, samples, level: int, per_shape, device) -> torch.Tensor:
    """Standard normal float32 draws (len(samples), *per_shape), one
    generator per (sample, level)."""
    out = []
    for s in samples:
        g = torch.Generator(device=device)
        g.manual_seed(sample_seed(seed, s, level))
        out.append(torch.randn(tuple(per_shape), generator=g, device=device,
                               dtype=torch.float32))
    return torch.stack(out)


def _cat(ts: list[torch.Tensor]) -> torch.Tensor:
    """Channel concat with dtype promotion (as jnp.concatenate)."""
    if len(ts) == 1:
        return ts[0]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in ts], dim=-1)


class DownPath(nn.Module):
    """Shared conv encoder over concat(moving, fixed)."""

    def __init__(self, cfg: PULPoConfig, dtype: torch.dtype):
        super().__init__()
        ch = cfg.num_channels
        cin = [2 * _IMAGE_CHANNELS] + [ch[k] for k in range(cfg.total_levels - 1)]
        self.down_blocks = nn.ModuleList(
            [ConvSequence(cin[k], ch[k], 3, dtype) for k in range(cfg.total_levels)])

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False) -> LevelDict:
        h = torch.cat([x, y], dim=-1)
        acts: LevelDict = {}
        for k, block in enumerate(self.down_blocks):
            if k > 0:
                h = avg_pool_ceil(h)
            h = block(h, train=train)
            acts[k] = h
        return acts


class PULPoEncoder(nn.Module):
    """Posterior head of one latent level: the merge block (all but the
    coarsest level) and the mu/sigma heads."""

    def __init__(self, cfg: PULPoConfig, level: int, dtype: torch.dtype):
        super().__init__()
        c = cfg.num_channels[cfg.lk_offset + level]
        if level < cfg.latent_levels - 1:
            self.sample_merge_block = ConvSequence(cfg.n0 * cfg.zdim + c, c, 2, dtype)
        self.mu_sigma = MuSigmaBlock(c, cfg.zdim, dtype)

    def forward(self, down_activation: torch.Tensor, feedback: torch.Tensor | None = None,
                train: bool = False):
        h = down_activation
        if feedback is not None:
            # == ConvSequence(concat([feedback, activation])), the
            # activation half convolved once per pair
            h = self.sample_merge_block(feedback, x2=down_activation, train=train)
        return self.mu_sigma(h)


class SVFDecoder(nn.Module):
    """SVF decoder of one latent level."""

    def __init__(self, cfg: PULPoConfig, level: int, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.level = level
        self.velocity_field = VelocityField(cfg.zdim, cfg.ndims, cfg.n0, cfg.cp_depth, dtype)

    def forward(self, z, input_image, combined_df=None, do_warp: bool = True,
                train: bool = False):
        """Returns (velocity_field, individual_df, combined_df, final_df,
        transformed); `do_warp=False` leaves the image warp to the caller
        (None in its slot)."""
        cfg = self.cfg
        insize = cfg.level_sizes[self.level]
        outsize = cfg.df_size(self.level)
        individual_df = self.velocity_field(z, train)
        if combined_df is None:
            combined = individual_df
        else:
            parent = resize_vecfield(combined_df, vel_resize=0.5, out_size=insize)
            combined = parent + individual_df
        # float32 integration whatever the compute dtype: the 7-step
        # self-warp compounds rounding error
        integrated = integrate_svf(combined.float(), nsteps=cfg.nsteps)
        vel_resize_output = 1.0 / (outsize[0] / insize[0])
        final_df = resize_vecfield(integrated, vel_resize_output, out_size=outsize)
        if not do_warp:
            return individual_df, individual_df, combined, final_df, None
        transformed = warp_image(input_image.float(), final_df)
        return individual_df, individual_df, combined, final_df, transformed


class Autoencoder(nn.Module):
    """Hierarchical VAE body."""

    def __init__(self, cfg: PULPoConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        K = cfg.latent_levels
        self.encoders = nn.ModuleList([PULPoEncoder(cfg, l, dtype) for l in range(K)])
        self.decoders = nn.ModuleList([SVFDecoder(cfg, l, dtype) for l in range(K)])
        # feedback up-blocks of global levels lk_offset .. total_levels-2
        self.up_blocks = nn.ModuleDict({
            str(l + cfg.lk_offset): ConvSequence(
                feedback_channels(cfg), cfg.n0 * cfg.zdim, 2, dtype)
            for l in range(K - 1)
        })

    def _level_x_pyramid(self, x: torch.Tensor) -> LevelDict:
        """Moving-image pyramid; level 0 stays at the input resolution."""
        cfg = self.cfg
        if cfg.df_resolution == "full_res":
            return {l: x for l in range(cfg.latent_levels)}
        level_x: LevelDict = {}
        h = x
        for _ in range(cfg.lk_offset):
            h = avg_pool_ceil(h)
        prev = h
        for l in range(1, cfg.latent_levels):
            prev = avg_pool_ceil(prev)
            level_x[l] = prev
        level_x[0] = x
        return level_x

    def forward(self, x: torch.Tensor, down_activations: LevelDict,
                deterministic: bool = False, n_samples: int = 1,
                seed: int = 0, sample_ids=None,
                noise: LevelDict | None = None,
                train: bool = False) -> tuple[LevelDict, ...]:
        """Decode S = n_samples posterior draws folded into the batch axis.

        `sample_ids`: the global index of each of the S samples (default
        0..S-1) — with `seed`, what a draw depends on. `noise`: per-level
        float32 draws of shape (S*B, *level_size, zdim), sample-major,
        used instead of the generators."""
        cfg = self.cfg
        S = n_samples
        B = x.shape[0]
        if sample_ids is None:
            sample_ids = range(S)
        assert len(sample_ids) == S, (len(sample_ids), S)
        level_x = self._level_x_pyramid(x)
        batch_warp = (cfg.df_resolution == "full_res"
                      and "transformed" not in cfg.feedback)

        def draw_eps(l: int, shape, dtype) -> torch.Tensor:
            if noise is not None:
                eps = noise[l].to(device=x.device, dtype=torch.float32)
                assert tuple(eps.shape) == tuple(shape), (eps.shape, shape)
            else:
                eps = draw_normal(seed, sample_ids, l, (B, *shape[1:]), x.device)
            return eps.reshape(shape).to(dtype)

        mus: LevelDict = {}
        sigmas: LevelDict = {}
        samples: LevelDict = {}
        velocity_fields: LevelDict = {}
        individual_dfs: LevelDict = {}
        combined_dfs: LevelDict = {}
        final_dfs: LevelDict = {}
        transformed: LevelDict = {}
        tensors = {
            "samples": samples,
            "velocity_fields": velocity_fields,
            "individual_dfs": individual_dfs,
            "combined_dfs": combined_dfs,
            "final_dfs": final_dfs,
            "transformed": transformed,
        }

        for l in reversed(range(cfg.latent_levels)):
            k = l + cfg.lk_offset
            if l == cfg.latent_levels - 1:
                mu_pp, sigma_pp = self.encoders[l](down_activations[k], None, train)
                mus[l], sigmas[l] = tile_rows(mu_pp, S * B), tile_rows(sigma_pp, S * B)
                parent_combined = None
            else:
                down_size = down_activations[k].shape[1:-1]
                # concat consecutive same-size feedback tensors before
                # resizing; run-length grouping keeps the channel order
                runs: list[list[torch.Tensor]] = []
                for item in cfg.feedback:
                    t = tensors[item][l + 1]
                    if runs and runs[-1][0].shape[1:-1] == t.shape[1:-1]:
                        runs[-1].append(t)
                    else:
                        runs.append([t])
                fb = _cat([resize_linear(_cat(ts), down_size) for ts in runs])
                fb = self.up_blocks[str(k)](fb, train=train)
                mus[l], sigmas[l] = self.encoders[l](down_activations[k], fb, train)
                parent_combined = combined_dfs[l + 1]

            if deterministic:
                samples[l] = mus[l]
            else:
                eps = draw_eps(l, mus[l].shape, mus[l].dtype)
                samples[l] = mus[l] + sigmas[l] * eps

            (velocity_fields[l], individual_dfs[l], combined_dfs[l],
             final_dfs[l], transformed[l]) = self.decoders[l](
                samples[l], level_x[l], parent_combined, not batch_warp, train)

        if batch_warp:
            transformed.update(batched_level_warp(x, final_dfs))

        return (mus, sigmas, samples, velocity_fields,
                individual_dfs, combined_dfs, final_dfs, transformed)


def prior_like(posterior_mus: LevelDict, posterior_sigmas: LevelDict):
    """Standard-normal prior moments shaped like the posterior."""
    return ({l: torch.zeros_like(m) for l, m in posterior_mus.items()},
            {l: torch.ones_like(s) for l, s in posterior_sigmas.items()})


class PULPoModule(nn.Module):
    """Full network: DownPath + Autoencoder."""

    def __init__(self, cfg: PULPoConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.downpath = DownPath(cfg, dtype)
        self.autoencoder = Autoencoder(cfg, dtype)

    def forward(self, x, y, deterministic: bool = False, seed: int = 0,
                noise: LevelDict | None = None, train: bool = False):
        cfg = self.cfg
        if train and (cfg.remat or cfg.remat_down):
            raise NotImplementedError(
                "cfg.remat / cfg.remat_down (recomputing activations in the "
                "backward) are not ported yet; see ROADMAP.md Queue 1")
        acts = self.downpath(x, y, train=train)
        return self.autoencoder(x, acts, deterministic=deterministic,
                                seed=seed, noise=noise, train=train)

    def encode(self, x, y) -> LevelDict:
        return self.downpath(x, y)

    def decode(self, x, down_activations, deterministic: bool = False,
               n_samples: int = 1, seed: int = 0, sample_ids=None,
               noise: LevelDict | None = None):
        """Decode S posterior samples folded into the batch axis. Output
        leaves are (S*B, ...), sample-major."""
        return self.autoencoder(x, down_activations, deterministic,
                                n_samples=n_samples, seed=seed,
                                sample_ids=sample_ids, noise=noise)

