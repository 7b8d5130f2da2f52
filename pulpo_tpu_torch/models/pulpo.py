"""The PULPo hierarchical probabilistic registration network.

Port of pulpo_tpu/models/pulpo.py:45-502:

- DownPath: a shared conv encoder over concat(moving, fixed); per global
  level k a ConvSequence(depth 3), then ceil-mode average pooling.
- Autoencoder: the hierarchical VAE decoded coarse to fine. At each
  latent level a posterior head gives (mu, sigma), a sample is drawn, and
  an SVF decoder turns it into a velocity field that is added to the
  upscaled parent field, integrated (float32 whatever the compute dtype)
  and used to warp the moving-image pyramid.

Dimension-generic as the JAX module is: `cfg.ndims` 3 (volumes) or 2
(slices). The fused eval kernels take only 3D, as the JAX package's do
(pulpo_tpu/kernels/vel_head.py:327, pos_head.py:449,
attic/conv_chain.py:328), so a 2D network runs the library convs; its
integration and warps run the 2D squaring and warp kernels.

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
the fused kernel, as in the JAX package. In eval, each non-coarsest
level's up_block, merge block and mu/sigma heads run as one
`kernels/pos_head.posterior_head` call where its kernel takes the
widths (pulpo_tpu/models/pulpo.py:368-392).

Remat (recomputing activations in the backward instead of keeping
them; pulpo_tpu/models/pulpo.py:56-66, 214-215): in a train forward,
`cfg.remat_down` checkpoints the listed DownPath blocks, and
`cfg.remat` every DownPath block and each level's encoder and decoder
(`remat`). The noise is drawn outside the decoders, and the
recomputation records no BatchNorm update, so a remat step equals the
plain one. A kernel inside a checkpointed region launches again in the
backward.

At `df_resolution="full_res"` without `"transformed"` feedback, the
eval decode runs its fields channels-first (`cf_fields`; JAX
pulpo.py:158-181, 292-298, 414-421): every level integrates on
(B, 3, *S) memory, the resize repeats the channels-last one on a view,
and one CF warp moves the image by all levels' final dfs at once (their
stack is the one copy into (B, 3, *S) memory). Train and `level_res`
keep channels-last.

Outputs are dicts keyed by latent level, channels-last: a CF final df
leaves as a view (a permute, no copy) of the resize's output.

Under spatial sharding (parallel/spatial.py) the same code runs on this
rank's block of every volume: the ops it calls exchange what they need,
a level's draws are the rank's block of the whole draw, and the
posterior head runs on a 4-plane halo. At full_res the channels-first
eval decode integrates each level's slab by slab launches of #3 and
warps the full-res image by one slab launch of #8 over all levels' dfs;
the train step stays channels-last, its batched warp a slab launch of
#4 with L df rows a moving row (#6 in its backward). A 2D network is
sharded along H the same way: its library convs on a 1-line halo, its
integration and warps by slab launches of the 2D kernels (whose
gradients are the plain versions'); it launches no fused eval kernel.

Remat under sharding equals the plain sharded step, as on one device:
a checkpointed region's recomputation is a function of the region's
saved inputs, the module's weights and the sharding flags alone. The
inputs are the ones its forward took; the flags are restored to its
forward's (`spatial.replay`); its exchanges (halos, gathers, the
resizes' sums, the integration's per-step gathers, BatchNorm.synced's
all-reduce of the moments) are collectives of the same sizes in the same
order on every rank, since every rank's autograd replays the same
graph, so each returns what it returned in the forward; no noise is
drawn inside a region, and its BatchNorms record no update. Hence every
activation it rebuilds equals the forward's, and so does every
gradient.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from pulpo_tpu_torch.config import PULPoConfig
from pulpo_tpu_torch.kernels import pos_head
from pulpo_tpu_torch.models.blocks import (
    BatchNorm,
    ConvSequence,
    MuSigmaBlock,
    VelocityField,
    conv_cl,
    tile_rows,
)
from pulpo_tpu_torch.ops.resize import avg_pool_ceil, resize_linear
from pulpo_tpu_torch.ops.warp import (
    batched_level_warp,
    batched_level_warp_cf,
    integrate_svf,
    integrate_svf_cf,
    resize_vecfield,
    resize_vecfield_cf,
    warp_image,
)
from pulpo_tpu_torch.parallel import spatial, tp

LevelDict = dict[int, torch.Tensor]

_IMAGE_CHANNELS = 1  # moving and fixed are single-channel volumes


def feedback_channels(cfg: PULPoConfig) -> int:
    """Channels of the concatenated feedback tensors (up_block input)."""
    per = {"samples": cfg.zdim, "transformed": _IMAGE_CHANNELS}
    return sum(per.get(item, cfg.ndims) for item in cfg.feedback)


def batch_warp(cfg: PULPoConfig) -> bool:
    """Every level warps the same full-res image after the level loop:
    full_res dfs, and no level feeds its warped image to the next."""
    return cfg.df_resolution == "full_res" and "transformed" not in cfg.feedback


def cf_fields(cfg: PULPoConfig) -> bool:
    """The eval decode (and the UQ tail) keeps its fields channels-first:
    fixed by the configuration, as the batched warp is."""
    return batch_warp(cfg) and cfg.ndims == 3


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


def remat(fn, *args):
    """fn(*args) with its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant), as `nn.remat` in the JAX
    package. The recomputation runs its BatchNorms `replaying`, and runs
    the whole region (no early stop), so that each kernel in it launches
    once more in the backward. Under spatial sharding it runs under the
    sharding flags its forward saw (`spatial.replay`), so it issues the
    forward's exchanges again, in the same order on every rank."""
    first = True
    flags = spatial.snapshot()

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a)
        with BatchNorm.replaying(), spatial.replay(flags):
            return fn(*a)

    with set_checkpoint_early_stop(False):
        return checkpoint(run, *args, use_reentrant=False)


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
            [ConvSequence(cin[k], ch[k], 3, dtype, cfg.ndims) for k in range(cfg.total_levels)])
        self.rematted = {k for k in range(cfg.total_levels) if cfg.remat or k in cfg.remat_down}

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False) -> LevelDict:
        h = torch.cat([x, y], dim=-1)
        acts: LevelDict = {}
        for k, block in enumerate(self.down_blocks):
            if k > 0:
                h = avg_pool_ceil(h)
            if train and k in self.rematted:
                h = remat(lambda t, block=block: block(t, train=True), h)
            else:
                h = block(h, train=train)
            acts[k] = h
        return acts


class PULPoEncoder(nn.Module):
    """Posterior head of one latent level: the merge block (all but the
    coarsest level) and the mu/sigma heads."""

    def __init__(self, cfg: PULPoConfig, level: int, dtype: torch.dtype):
        super().__init__()
        c = cfg.num_channels[cfg.lk_offset + level]
        self.dtype = dtype
        self.n_feedback = cfg.n0 * cfg.zdim
        if level < cfg.latent_levels - 1:
            self.sample_merge_block = ConvSequence(self.n_feedback + c, c, 2, dtype,
                                                   cfg.ndims)
        self.mu_sigma = MuSigmaBlock(c, cfg.zdim, dtype, cfg.ndims)

    def merge_half(self, down_activation: torch.Tensor) -> torch.Tensor:
        """The merge conv's activation half, once per pair, without bias."""
        w = self.sample_merge_block._op[0]._op[0].weight[:, self.n_feedback:]
        return conv_cl(down_activation.to(self.dtype), w, 1)

    def head_params(self, up_block: ConvSequence) -> dict:
        """This level's posterior head (`up_block`, the merge block, the
        heads), keyed as kernels/pos_head.py takes them; mk1 is the
        feedback half of the split merge kernel."""
        p = {}
        for pre, seq in (("u", up_block), ("m", self.sample_merge_block)):
            for n, st in enumerate(seq.stages(), 1):
                p.update({f"{pre}{k}{n}": v for k, v in st.items()})
        p["mk1"] = p["mk1"][:, :self.n_feedback]
        ms = self.mu_sigma
        p["hkmu"], p["hbmu"] = ms._conv_mu.weight, ms._conv_mu.bias
        p["hksig"], p["hbsig"] = ms._conv_sigma[0].weight, ms._conv_sigma[0].bias
        return p

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
                train: bool = False, cf: bool = False):
        """Returns (velocity_field, individual_df, combined_df, final_df,
        transformed); `do_warp=False` leaves the image warp to the caller
        (None in its slot). `cf` (with do_warp=False): integrate
        channels-first; final_df is then a channels-last view of the
        CF resize's output."""
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
        vel_resize_output = 1.0 / (outsize[0] / insize[0])
        if cf:
            assert not do_warp, "the CF decode leaves the image warp to the caller"
            integ = integrate_svf_cf(combined.float().permute(0, 4, 1, 2, 3), nsteps=cfg.nsteps)
            final_cf = resize_vecfield_cf(integ, vel_resize_output, out_size=outsize)
            return (individual_df, individual_df, combined, final_cf.permute(0, 2, 3, 4, 1),
                    None)
        integrated = integrate_svf(combined.float(), nsteps=cfg.nsteps)
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
        self.dtype = dtype
        K = cfg.latent_levels
        self.encoders = nn.ModuleList([PULPoEncoder(cfg, l, dtype) for l in range(K)])
        self.decoders = nn.ModuleList([SVFDecoder(cfg, l, dtype) for l in range(K)])
        # feedback up-blocks of global levels lk_offset .. total_levels-2
        self.up_blocks = nn.ModuleDict({
            str(l + cfg.lk_offset): ConvSequence(
                feedback_channels(cfg), cfg.n0 * cfg.zdim, 2, dtype, cfg.ndims)
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
        batched = batch_warp(cfg)
        cf = cf_fields(cfg) and not train

        checkpointed = train and cfg.remat

        def encode(enc, act, fb):
            if checkpointed:
                return remat(lambda a, f: enc(a, f, True), act, fb)
            return enc(act, fb, train)

        def decode(dec, z, img, parent):
            if checkpointed:
                return remat(lambda *a: dec(*a, not batched, True, cf), z, img, parent)
            return dec(z, img, parent, not batched, train, cf)

        def draw_eps(l: int, shape, dtype) -> torch.Tensor:
            if spatial.active():  # the whole draw's block
                per = spatial.whole_draw_shape(shape, S)
                eps = (noise[l].to(device=x.device, dtype=torch.float32) if noise is not None
                       else draw_normal(seed, sample_ids, l, per, x.device))
                eps = spatial.block(eps.reshape(S * per[0], *per[1:]), S)
            elif noise is not None:
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
                mu_pp, sigma_pp = encode(self.encoders[l], down_activations[k], None)
                mus[l], sigmas[l] = tile_rows(mu_pp, S * B), tile_rows(sigma_pp, S * B)
                parent_combined = None
            else:
                down_size = cfg.global_level_sizes[k]
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
                enc, up = self.encoders[l], self.up_blocks[str(k)]
                p = None if train else enc.head_params(up)
                fbt = fb.to(self.dtype)
                if p is not None and not tp.active() and pos_head.takes(fbt, p):
                    head = lambda f, a, enc=enc, p=p: pos_head.posterior_head(
                        f, enc.merge_half(a), p)
                    if spatial.active():  # 2 + 2 units: a 4-plane halo
                        mus[l], sigmas[l] = spatial.on_halo(head, fbt, down_activations[k],
                                                            depth=4)
                    else:
                        mus[l], sigmas[l] = head(fbt, down_activations[k])
                else:
                    fb = up(fb, train=train)
                    mus[l], sigmas[l] = encode(enc, down_activations[k], fb)
                parent_combined = combined_dfs[l + 1]

            if deterministic:
                samples[l] = mus[l]
            else:
                eps = draw_eps(l, mus[l].shape, mus[l].dtype)
                samples[l] = mus[l] + sigmas[l] * eps

            (velocity_fields[l], individual_dfs[l], combined_dfs[l],
             final_dfs[l], transformed[l]) = decode(
                self.decoders[l], samples[l], level_x[l], parent_combined)

        if cf:
            transformed.update(batched_level_warp_cf(
                x, {l: d.permute(0, 4, 1, 2, 3) for l, d in final_dfs.items()}))
        elif batched:
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

