"""N-sample uncertainty prediction.

Port of pulpo_tpu/uq/predict.py:59-74, 160-422 (`_uq_impl` and
`predict_with_uncertainty`). The down path runs once; the N posterior
samples stream through the decode in chunks, folded into the batch
axis; per-voxel statistics are merged across chunks with Chan's
parallel moments, so no (N, full-res) buffer exists unless
`keep_samples` asks for it. Semantics as in the JAX package:

- mean prediction = integrate the mean SVF (the average of the N
  individual dfs), then re-warp the moving image;
- per-level std maps over the N samples (Bessel), channel-averaged;
- `final_df_std` from per-sample integration; with a mask, multiplied by
  the mask warped by the mean final df;
- `output_mse` (level 0) and `output_entropy` from the same moments;
- `lm` warps landmarks by every draw's level-0 final df.

Draws depend only on (seed, sample index, level), so the result does
not depend on `chunk`. On the card, `chunk=None` picks the largest
divisor of N whose decode fits the free device memory, using the peak
memory of a one-sample decode measured once per input shape.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pulpo_tpu_torch.models.api import PULPoModel, _as_tensor, _warp_levels, combine_dfs
from pulpo_tpu_torch.ops.warp import warp_landmarks

LevelDict = dict[int, torch.Tensor]

# share of the free device memory a decode chunk may take: the rest is
# headroom for the allocator's fragmentation and the statistics
MEMORY_SHARE = 0.8


class UQResult(NamedTuple):
    mean_outputs: LevelDict       # mean-SVF re-warped prediction (B, *, C)
    avg_dfs: LevelDict            # mean individual df per level
    final_dfs: LevelDict          # final df of the mean SVF per level
    outputs: LevelDict            # sample outputs, first chunk only (B, n, *, C)
    output_std: LevelDict         # (B, *spatial) channel-averaged
    individual_df_std: LevelDict  # (B, *spatial)
    final_df_std: LevelDict       # (B, *spatial)
    output_mse: LevelDict         # (B, *spatial) mean_N (moved - y)^2
    output_entropy: LevelDict     # (B, *spatial) 0.5*ln(2*pi*e*var)
    sample_individual_dfs: LevelDict | None  # (N, B, *level, nd)
    sample_combined_dfs: LevelDict | None    # (N, B, *level, nd)
    sample_final_dfs: LevelDict | None       # (N, B, *out, nd)
    sample_outputs: LevelDict | None         # (N, B, *out, C)
    sample_landmarks: torch.Tensor | None    # (N, B, n_lm, nd)


def retention_bytes(cfg, N: int, batch: int = 1, dtype_bytes: int = 2) -> int:
    """Device bytes of `keep_samples=True`: per-sample individual and
    combined dfs (level res, compute dtype), final dfs and warped
    outputs (output res, float32)."""
    per_sample = 0
    for l in range(cfg.latent_levels):
        lv = math.prod(cfg.level_sizes[l])
        ov = math.prod(cfg.df_size(l))
        per_sample += 2 * lv * cfg.ndims * dtype_bytes
        per_sample += ov * cfg.ndims * 4
        per_sample += ov * 1 * 4
    return N * batch * per_sample


def auto_chunk(N: int, per_sample_bytes: int, budget_bytes: float,
               retained_bytes: int = 0) -> int:
    """The largest divisor of N whose decode working set fits the budget
    left after `retained_bytes` (at least 1)."""
    budget = max(budget_bytes - retained_bytes, 0.0)
    cap = max(1, int(budget // max(per_sample_bytes, 1)))
    for c in range(min(N, cap), 0, -1):
        if N % c == 0:
            return c
    return 1


def device_budget(device: torch.device) -> float:
    """Bytes a decode chunk may take: a share of the memory the card has
    free, counting what PyTorch's allocator holds but does not use."""
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return MEMORY_SHARE * float(free + cached)


def measure_decode_bytes(model: PULPoModel, x: torch.Tensor, acts: LevelDict) -> int:
    """Peak device bytes of a one-sample decode above what is allocated
    before it, measured once per (input shape, batch) and kept on the model."""
    key = (tuple(x.shape), str(model.device))
    if key not in model.decode_bytes:
        dev = model.device
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        outs = model.module.decode(x, acts, deterministic=True)
        del outs
        torch.cuda.synchronize(dev)
        model.decode_bytes[key] = int(torch.cuda.max_memory_allocated(dev) - base)
    return model.decode_bytes[key]


def _chunk_moments(v: torch.Tensor):
    """(chunk, B, *spatial, C) -> per-voxel (mean, M2) over the chunk."""
    v = v.float()
    mean = v.mean(0)
    m2 = ((v - mean[None]) ** 2).sum(0)
    return mean, m2


def _combine_moments(a, b, n_a: int, n_b: int):
    """Chan et al. parallel variance combination."""
    mean_a, m2_a = a
    mean_b, m2_b = b
    n = n_a + n_b
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / n)
    m2 = m2_a + m2_b + delta * delta * (n_a * n_b / n)
    return mean, m2


def _finalize_std(moments, n: int) -> torch.Tensor:
    """Bessel std from streamed (mean, M2), then the channel mean."""
    _, m2 = moments
    return torch.sqrt(torch.clamp_min(m2 / (n - 1), 0.0)).mean(dim=-1)


def _finalize_entropy(moments, n: int) -> torch.Tensor:
    """Gaussian differential entropy from the channel-averaged variance."""
    _, m2 = moments
    var = torch.clamp_min(m2 / (n - 1), 0.0).mean(dim=-1)
    return 0.5 * torch.log(2.0 * math.pi * math.e * var + 1e-12)


@torch.inference_mode()
def predict_with_uncertainty(
    model: PULPoModel, x, y, N: int, seed: int = 0, mask=None,
    chunk: int | None = None, keep_samples: bool = False, lm=None,
    noise: LevelDict | None = None,
) -> UQResult:
    """N-sample uncertainty prediction for the pairs (x, y), each
    (B, *input_size, 1).

    `chunk` bounds peak memory (samples decoded at once; a divisor of N).
    `chunk=None`: on the card, the memory-fitted chunk (module doc); on
    the CPU, N. `keep_samples` retains the per-sample dfs and outputs;
    `lm` (B, n_lm, nd) retains per-sample warped landmarks. `noise`:
    float32 draws {level: (N, B, *level_size, zdim)} used instead of the
    generators (a test hook)."""
    cfg = model.cfg
    dev = model.device
    x, y = _as_tensor(x, dev), _as_tensor(y, dev)
    batch = x.shape[0]
    acts = model.module.encode(x, y)

    if chunk is None:
        if dev.type == "cuda":
            dtype_bytes = 2 if model.dtype == torch.bfloat16 else 4
            retained = retention_bytes(cfg, N, batch, dtype_bytes) if keep_samples else 0
            per_sample = measure_decode_bytes(model, x, acts)
            chunk = auto_chunk(N, per_sample, device_budget(dev), retained)
        else:
            chunk = N
    chunk = min(chunk, N)
    if N % chunk:
        raise ValueError(f"N={N} not divisible by chunk={chunk}")

    lm_t = None if lm is None else torch.as_tensor(lm).to(device=dev, dtype=torch.float32)
    stats = None
    first_outputs = None
    retained: dict[str, list] = {}
    for start in range(0, N, chunk):
        ids = range(start, start + chunk)
        eps = None
        if noise is not None:
            eps = {l: v[start:start + chunk].reshape(chunk * batch, *v.shape[2:])
                   for l, v in noise.items()}
        outs = model.module.decode(x, acts, n_samples=chunk, seed=seed,
                                   sample_ids=ids, noise=eps)
        unfold = lambda d: {l: v.reshape(chunk, batch, *v.shape[1:]) for l, v in d.items()}
        ind, comb, fin, out = unfold(outs[4]), unfold(outs[5]), unfold(outs[6]), unfold(outs[7])
        del outs
        s = {name: {l: _chunk_moments(v) for l, v in d.items()}
             for name, d in (("ind", ind), ("fin", fin), ("out", out))}
        s["mse"] = {0: ((out[0].float() - y[None]) ** 2).sum(0)[..., 0]}
        if stats is None:
            stats, first_outputs = s, out
        else:
            n_c = start
            for name in ("ind", "fin", "out"):
                stats[name] = {l: _combine_moments(stats[name][l], s[name][l], n_c, chunk)
                               for l in stats[name]}
            stats["mse"] = {l: stats["mse"][l] + s["mse"][l] for l in stats["mse"]}
        if keep_samples:
            for name, d in (("ind", ind), ("comb", comb), ("fin", fin), ("out", out)):
                retained.setdefault(name, []).append(d)
        if lm_t is not None:
            retained.setdefault("lm", []).append(
                torch.stack([warp_landmarks(lm_t, d) for d in fin[0]]))

    def gather(name):
        parts = retained.get(name)
        if parts is None:
            return None
        if name == "lm":
            return torch.cat(parts, dim=0)
        return {l: torch.cat([p[l] for p in parts], dim=0) for l in parts[0]}

    # mean-SVF combine + integrate + re-warp
    avg_dfs = {l: m[0] for l, m in stats["ind"].items()}
    _, mean_final = combine_dfs(cfg, avg_dfs)
    mean_outputs = _warp_levels(x, mean_final)

    output_std = {l: _finalize_std(m, N) for l, m in stats["out"].items()}
    output_entropy = {l: _finalize_entropy(m, N) for l, m in stats["out"].items()}
    individual_df_std = {l: _finalize_std(m, N) for l, m in stats["ind"].items()}
    final_df_std = {l: _finalize_std(m, N) for l, m in stats["fin"].items()}
    if mask is not None:
        wms = _warp_levels(_as_tensor(mask, dev), mean_final)
        for l in final_df_std:
            final_df_std[l] = final_df_std[l] * torch.abs(wms[l][..., 0])
    output_mse = {l: stats["mse"][l] / N for l in stats["mse"]}

    return UQResult(
        mean_outputs=mean_outputs,
        avg_dfs=avg_dfs,
        final_dfs=mean_final,
        outputs={l: v.transpose(0, 1) for l, v in first_outputs.items()},
        output_std=output_std,
        individual_df_std=individual_df_std,
        final_df_std=final_df_std,
        output_mse=output_mse,
        output_entropy=output_entropy,
        sample_individual_dfs=gather("ind"),
        sample_combined_dfs=gather("comb"),
        sample_final_dfs=gather("fin"),
        sample_outputs=gather("out"),
        sample_landmarks=gather("lm"),
    )
