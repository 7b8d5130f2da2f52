#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PULPo on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi); no CUDA device -> fail;
2. build the seven CUDA kernels from pulpo_tpu_torch/csrc (one nvcc per
   source, all started together);
3. hold each kernel against its plain PyTorch version (TF32 off) at the
   main paths' shapes, within a stated tolerance;
4. a small-input reference: a UQ request on the card against the same
   weights and draws on the CPU (plain versions), leaf by leaf;
4b. a small training step on the card against the same weights, batch
   and draws on the CPU: losses, gradients and BatchNorm statistics;
5. the serving path: the flagship config (160x192x224, 5/4 levels,
   n0=32, bf16, level_res) with seeded random weights answers 3
   requests, each `predict_with_uncertainty` with N=32 on one synthetic
   pair. Every leaf must be finite and each kernel's launch count must
   equal the count the shapes give;
5b. the training path: the same flagship config (NCC + KL + L2, Adam lr
   1e-4, B = 1) takes 1 warm-up and 5 timed `make_train_step` steps on a
   synthetic pair: finite losses, no NaN flag, changed weights, and the
   launch counts the shapes give;
6. per-kernel times (CUDA events) beside their bounds, the plain
   versions' times and one library call's time.

Each path's launch counts are set to 0 just before it runs and read
just after.

It prints one JSON line of kernel records, the card line, and as its
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

N_SAMPLES = 32
N_REQUESTS = 3
TRAIN_STEPS = 5                # timed, after one warm-up step
FLAGSHIP = dict(input_size=(160, 192, 224), total_levels=5, latent_levels=4,
                n0=32, compute_dtype="bfloat16", df_resolution="level_res",
                dataset="synthetic")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOP_PER_S = 989e12       # dense tensor-core peak, published

KERNELS = ("warp", "squaring", "vel_head", "warp_dfgrad", "warp_mgrad",
           "squaring_bwd", "box_sum")
REPLACES = {
    "warp": "pulpo_tpu/kernels/warp_halo.py:322",
    "squaring": "pulpo_tpu/kernels/warp_local.py:142",
    "vel_head": "pulpo_tpu/kernels/vel_head.py:185",
    "warp_dfgrad": "pulpo_tpu/kernels/warp_halo.py:822",
    "warp_mgrad": "pulpo_tpu/kernels/warp_halo.py:1004",
    "squaring_bwd": "pulpo_tpu/kernels/warp_local.py:309",
    "box_sum": "pulpo_tpu/kernels/box_sum.py:61",
}
SOURCES = {
    "warp": "pulpo_tpu_torch/csrc/warp.cu",
    "squaring": "pulpo_tpu_torch/csrc/squaring.cu",
    "vel_head": "pulpo_tpu_torch/csrc/vel_head.cu",
    "warp_dfgrad": "pulpo_tpu_torch/csrc/warp_bwd.cu",
    "warp_mgrad": "pulpo_tpu_torch/csrc/warp_bwd.cu",
    "squaring_bwd": "pulpo_tpu_torch/csrc/squaring_bwd.cu",
    "box_sum": "pulpo_tpu_torch/csrc/box_sum.cu",
}


def reset_counts() -> None:
    from pulpo_tpu_torch.kernels import box_sum, squaring, vel_head, warp

    for mod in (warp, squaring, vel_head, box_sum):
        mod.reset_count()


def read_counts() -> dict[str, int]:
    from pulpo_tpu_torch.kernels import box_sum, squaring, vel_head, warp

    return {"warp": warp.launches, "squaring": squaring.launches,
            "vel_head": vel_head.launches, "warp_dfgrad": warp.dfgrad_launches,
            "warp_mgrad": warp.mgrad_launches, "squaring_bwd": squaring.bwd_launches,
            "box_sum": box_sum.launches}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------

def smooth_field(rows, size, magnitude, seed, device, channels=3):
    """A smooth random field (rows, *size, channels) with max |v| =
    magnitude: coarse normal noise, trilinearly upsampled."""
    import torch

    from pulpo_tpu_torch.ops.resize import resize_linear

    g = torch.Generator().manual_seed(seed)
    coarse = [max(2, s // 16) for s in size]
    v = torch.randn((rows, *coarse, channels), generator=g).to(device)
    v = resize_linear(v, tuple(size))
    return (v * (magnitude / v.abs().max())).contiguous()


def permuted(v):
    """The same values with channels-first memory (strides of a view)."""
    return v.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)


def head_params(zdim, n0, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    r = lambda shape, s=1.0: (torch.randn(shape, generator=g) * s).to(device)
    return {
        "k1": r((n0, zdim, 3, 3, 3), 0.3), "b1": r((n0,), 0.1),
        "mean1": r((n0,), 0.5), "var1": r((n0,)).abs() + 0.1,
        "scale1": r((n0,)) + 1.0, "bias1": r((n0,), 0.2),
        "k2": r((n0, n0, 3, 3, 3), 0.2 / math.sqrt(n0 / 8)), "b2": r((n0,), 0.1),
        "mean2": r((n0,), 0.5), "var2": r((n0,)).abs() + 0.1,
        "scale2": r((n0,)) + 1.0, "bias2": r((n0,), 0.2),
        "k3": r((3, n0, 1, 1, 1), 0.5), "b3": r((3,), 0.1),
    }


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

class Checks:
    """The kernel-versus-plain comparisons: the worst error per kernel and
    the cases that failed."""

    def __init__(self):
        self.worst = {k: 0.0 for k in KERNELS}
        self.failures = []

    def record(self, name, case, got, ref, tol):
        import torch

        err = float((got.float() - ref.float()).abs().max())
        self.worst[name] = max(self.worst[name], err)
        ok = err <= tol and bool(torch.isfinite(got).all())
        log(f"check {name:12s} {case:44s} max_abs_err {err:.3e}  tol {tol:.1e}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name} {case}")


def scaled(ref, rel):
    """A tolerance of `rel` times the reference's scale (at least 1)."""
    return rel * max(1.0, float(ref.float().abs().max()))


def check_kernels(dev, full, level0, checks, rows=4):
    """The serving path's kernels against their plain versions. `full`:
    input size; `level0`: latent level-0 size."""
    import torch

    from pulpo_tpu_torch.kernels import squaring, vel_head, warp

    record = checks.record
    g = torch.Generator().manual_seed(0)
    img = torch.rand((1, *full, 1), generator=g).to(dev)
    img3 = torch.rand((1, *level0, 3), generator=g).to(dev)
    # warp: image tolerance 1e-5 (values in [0, 1]; same operations in
    # the same order, so differences are summation-order noise)
    for mag in (0.3, 3.0, 15.0):
        df = smooth_field(rows, full, mag, seed=int(mag * 10), device=dev)
        record("warp", f"C=1 {rows} rows |d|<={mag}", warp.warp(img, df),
               warp.warp_plain(img, df), 1e-5)
    df = smooth_field(rows, full, 3.0, seed=7, device=dev)
    df[..., 0] += 60.0
    df[:, :, :8, :, 2] -= 80.0
    record("warp", "C=1 border clamp", warp.warp(img, df), warp.warp_plain(img, df), 1e-5)
    df = smooth_field(rows, level0, 3.0, seed=8, device=dev)
    record("warp", f"C=3 {rows} rows", warp.warp(img3, df), warp.warp_plain(img3, df), 1e-5)
    df = smooth_field(2, level0, 3.0, seed=9, device=dev)
    record("warp", "cross-res moving full, df level0", warp.warp(img, df),
           warp.warp_plain(img, df), 1e-5)

    # squaring: 7-step integration; early-step rounding noise doubles
    # per step, so the tolerance scales with the field (as the JAX
    # package's own integration test)
    for mag in (2.0, 40.0):
        v = smooth_field(rows, level0, mag, seed=int(mag), device=dev)
        ref = squaring.integrate_svf_plain(v, 7)
        got = squaring.integrate_svf(v, 7)
        record("squaring", f"7 steps {rows} rows |v|<={mag}", got, ref,
               1e-4 * float(ref.abs().max()) + 1e-4)
    # a permuted-memory input, as the decode's resized fields are
    v = permuted(smooth_field(rows, level0, 2.0, seed=5, device=dev))
    ref = squaring.integrate_svf_plain(v, 7)
    record("squaring", "7 steps permuted-memory input", squaring.integrate_svf(v, 7),
           ref, 1e-4 * float(ref.abs().max()) + 1e-4)
    df = permuted(smooth_field(rows, full, 3.0, seed=6, device=dev))
    record("warp", "C=1 permuted-memory df", warp.warp(img, df), warp.warp_plain(img, df), 1e-5)

    # velocity head at level 0, n0 = 32, zdim = 3. f32: summation order
    # only -> 1e-4 of the output scale; bf16: an intermediate that rounds
    # the other way moves an output by a few bf16 ulps (2**-8 of the
    # output scale each) -> 2% of the output scale
    p = head_params(3, 32, seed=3, device=dev)
    for dt, name, rel in ((torch.float32, "f32", 1e-4), (torch.bfloat16, "bf16", 0.02)):
        z = torch.randn((2, *level0, 3), generator=g).to(dev, dt)
        ref = vel_head.velocity_head_plain(z, p)
        got = vel_head.velocity_head(z, p)
        scale = max(1.0, float(ref.float().abs().max()))
        record("vel_head", f"{name} 2 rows n0=32", got, ref, rel * scale)


def check_backward_kernels(dev, cfg, checks):
    """The training path's kernels against their plain versions at its
    shapes (B = 1): tolerance 1e-5 of the output's scale. `warp_mgrad`
    and `squaring_bwd` scatter with float32 atomics, whose order is not
    fixed; `warp_dfgrad` and `box_sum` repeat the plain version's
    operations."""
    import torch

    from pulpo_tpu_torch.kernels import box_sum, squaring, warp

    record = checks.record
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    g = torch.Generator().manual_seed(1)
    img = torch.rand((1, *full, 1), generator=g).to(dev)

    # df-cotangent at level 0: full-res image, full-res df (level_res
    # resizes the level-0 df to the input size), C = 1
    for mag in (0.3, 3.0, 15.0):
        df = smooth_field(1, full, mag, seed=int(mag * 10) + 1, device=dev)
        cot = torch.randn((1, *full, 1), generator=g).to(dev)
        ref = warp.warp_dfgrad_plain(img, df, cot)
        record("warp_dfgrad", f"C=1 full res |d|<={mag}", warp.warp_dfgrad(img, df, cot),
               ref, scaled(ref, 1e-5))
    df[..., 0] += 60.0
    df[:, :, :8, :, 2] -= 80.0
    ref = warp.warp_dfgrad_plain(img, df, cot)
    record("warp_dfgrad", "C=1 full res border clamp", warp.warp_dfgrad(img, df, cot),
           ref, scaled(ref, 1e-5))
    df = permuted(smooth_field(2, full, 3.0, seed=21, device=dev))
    cot = torch.randn((2, *full, 1), generator=g).to(dev)
    ref = warp.warp_dfgrad_plain(img, df, cot)
    record("warp_dfgrad", "C=1 2 rows permuted-memory df", warp.warp_dfgrad(img, df, cot),
           ref, scaled(ref, 1e-5))
    del df, cot, ref

    # moving-cotangent: level 0 with C = 3 (its role in the squaring
    # backward), and full res with C = 1
    for size, c, rows in ((level0, 3, 1), (level0, 3, 2), (full, 1, 1)):
        df = smooth_field(rows, size, 3.0, seed=22 + rows, device=dev)
        cot = torch.randn((rows, *size, c), generator=g).to(dev)
        ref = warp.warp_mgrad_plain((1, *size, c), df, cot)
        record("warp_mgrad", f"C={c} {rows} rows {'x'.join(map(str, size))}",
               warp.warp_mgrad((1, *size, c), df, cot), ref, scaled(ref, 1e-5))
    ref = warp.warp_mgrad_plain((1, *size, c), permuted(df), cot)
    record("warp_mgrad", "C=1 full res permuted-memory df",
           warp.warp_mgrad((1, *size, c), permuted(df), cot), ref, scaled(ref, 1e-5))
    del df, cot, ref

    # squaring backward at level 0: the 7 step inputs of one integration
    # (up to 8 voxels, past the TPU stencil's sub-voxel bound), then the
    # whole backward through IntegrateSVF against the plain chain
    v = smooth_field(1, level0, 8.0, seed=24, device=dev)
    step_in = [v * (1.0 / 2**cfg.nsteps)]
    for _ in range(cfg.nsteps - 1):
        step_in.append(squaring.squaring_step_plain(step_in[-1]))
    cot = torch.randn((1, *level0, 3), generator=g).to(dev)
    for k, vk in enumerate(step_in):
        ref = squaring.squaring_step_bwd_plain(vk, cot)
        record("squaring_bwd", f"step {k} |v|<={float(vk.abs().max()):.2f}",
               squaring.squaring_step_bwd(vk, cot), ref, scaled(ref, 1e-5))
    ref = squaring.squaring_step_bwd_plain(step_in[-1], cot)
    record("squaring_bwd", "step 6 permuted-memory field",
           squaring.squaring_step_bwd(permuted(step_in[-1]), cot), ref, scaled(ref, 1e-5))
    ref = cot
    for vk in reversed(step_in):
        ref = squaring.squaring_step_bwd_plain(vk, ref)
    ref = ref * (1.0 / 2**cfg.nsteps)
    vg = v.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(squaring.integrate_svf(vg, cfg.nsteps), vg, cot)
    record("squaring_bwd", "IntegrateSVF backward, 7 steps", got, ref, scaled(ref, 1e-4))
    del v, vg, step_in, cot, ref, got

    # box sum: full res with window 9, then each level's recon size with
    # its own window, and a permuted-memory input
    for l in range(cfg.latent_levels):
        size, win = cfg.df_size(l), cfg.window_size[l]
        x = torch.rand((1, *size), generator=g).to(dev)
        ref = box_sum.box_sum_plain(x, win)
        record("box_sum", f"level {l} {'x'.join(map(str, size))} win {win}",
               box_sum.box_sum(x, win), ref, scaled(ref, 1e-5))
    x = torch.rand((1, *full), generator=g).to(dev)
    xp = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    ref = box_sum.box_sum_plain(x, 9)
    record("box_sum", "full res win 9 permuted-memory input", box_sum.box_sum(xp, 9), ref,
           scaled(ref, 1e-5))


# ----------------------------------------------------------------------
# phase 4: small input, card against CPU
# ----------------------------------------------------------------------

def check_small_reference(dev, size=(32, 40, 48), n=4):
    """UQ on the card (kernels) against the CPU (plain versions), same
    weights, same draws; every leaf within 1e-3 of its scale."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(input_size=size, total_levels=3, latent_levels=2, n0=8)
    ref_model = PULPoModel(cfg, device="cpu")
    ref_model.init(5)
    model = PULPoModel(cfg, device=dev)
    model.load_state_dict(ref_model.state_dict())
    pair = SyntheticDataset(shape=size, n=2, seed=1).get_pair(0, np.random.default_rng(0))
    x, y = pair["x"][None], pair["y"][None]
    rng = np.random.default_rng(2)
    noise = {l: torch.from_numpy(rng.standard_normal((n, 1, *cfg.level_sizes[l], 3),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    ref = predict_with_uncertainty(ref_model, x, y, n, chunk=2, noise=noise)
    got = predict_with_uncertainty(model, x, y, n, chunk=2, noise=noise)
    worst = 0.0
    for field, d in ref._asdict().items():
        if d is None:
            continue
        for l, r in d.items():
            gl = got._asdict()[field][l].cpu()
            err = float((gl - r).abs().max()) / max(1.0, float(r.abs().max()))
            worst = max(worst, err)
            if not err <= 1e-3:
                raise SystemExit(f"small reference: {field}[{l}] off by {err:.3e}")
    log(f"check small UQ card vs cpu {size} N={n}: worst scaled err {worst:.3e} (tol 1e-3) ok")


def check_small_train(dev, size=(32, 40, 48)):
    """One training step's forward and backward on the card (kernels)
    against the CPU (plain versions): same weights, batch (B = 2) and
    draws, float32. Losses within 1e-3 relative; each gradient within
    1e-3 of its leaf's scale (of 1 % of the largest gradient for the
    conv biases that feed a train BatchNorm: their gradient is 0 in
    exact arithmetic, so both sides hold rounding noise); the new
    BatchNorm statistics within 1e-5."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train.step import compute_grads

    cfg = PULPoConfig(input_size=size, total_levels=3, latent_levels=2, n0=8, batch_size=2)
    ref_model = PULPoModel(cfg, device="cpu")
    ref_model.init(6)
    model = PULPoModel(cfg, device=dev)
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(3)
    batch = {k: rng.random((2, *size, 1), dtype=np.float32) for k in ("x", "y")}
    noise = {l: torch.from_numpy(rng.standard_normal((2, *cfg.level_sizes[l], 3),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    ref_g, ref_s, ref_m = compute_grads(ref_model, batch, noise=noise)
    got_g, got_s, got_m = compute_grads(model, batch, noise=noise)
    worst_loss = 0.0
    for k in ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss"):
        r, gv = float(ref_m[k]), float(got_m[k])
        err = abs(gv - r) / max(abs(r), 1e-6)
        worst_loss = max(worst_loss, err)
        if not err <= 1e-3:
            raise SystemExit(f"small train step: {k} {gv} vs cpu {r}")
    top = max(float(v.abs().max()) for v in ref_g.values())
    worst = 0.0
    for n, r in ref_g.items():
        err = float((got_g[n].cpu() - r).abs().max()) / max(float(r.abs().max()), 1e-2 * top)
        worst = max(worst, err)
        if not err <= 1e-3:
            raise SystemExit(f"small train step: gradient {n} off by {err:.3e} of its scale")
    for n, r in ref_s.items():
        if not float((got_s[n].cpu() - r).abs().max()) <= 1e-5:
            raise SystemExit(f"small train step: BatchNorm statistic {n} differs")
    log(f"check small train step card vs cpu {size} B=2: losses rel err {worst_loss:.3e}, "
        f"gradients worst scaled err {worst:.3e} (tol 1e-3), statistics ok")


# ----------------------------------------------------------------------
# phase 5: the main path
# ----------------------------------------------------------------------

def run_main_path(dev, cfg_kw, n_samples, n_requests):
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(**cfg_kw)
    t0 = time.perf_counter()
    model = PULPoModel(cfg, device=dev)
    model.init(seed=0)
    ds = SyntheticDataset(shape=cfg.input_size, n=n_requests + 1, seed=0)
    pairs = [ds.get_pair(i, np.random.default_rng(i)) for i in range(n_requests)]
    log(f"serving path: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype} {cfg.df_resolution}, "
        f"{model.param_count} params, set-up {time.perf_counter() - t0:.1f} s")

    K = cfg.latent_levels
    decodes = 0
    chunks = []
    reset_counts()
    for i, pair in enumerate(pairs):
        x, y = pair["x"][None], pair["y"][None]
        calibrated = len(model.decode_bytes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = predict_with_uncertainty(model, x, y, n_samples, seed=i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        chunk = res.outputs[0].shape[1]
        chunks.append(chunk)
        decodes += n_samples // chunk + (len(model.decode_bytes) - calibrated)
        for field, d in res._asdict().items():
            if d is None:
                continue
            for l, v in d.items():
                if not bool(torch.isfinite(v).all()):
                    raise SystemExit(f"request {i}: {field}[{l}] not finite")
        log(f"request {i}: {dt:.3f} s  chunk {chunk}  "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
            f"decode bytes/sample {max(model.decode_bytes.values(), default=0) / 2**30:.2f} GiB  "
            "all leaves finite")
    counts = read_counts()
    expected = {
        # each decode: one image warp and one integration per level, and a
        # head per level; each request's mean-SVF tail: one integration
        # and one warp per level; no backward and no loss
        "warp": K * (decodes + n_requests),
        "squaring": cfg.nsteps * K * (decodes + n_requests),
        "vel_head": K * decodes,
        "warp_dfgrad": 0, "warp_mgrad": 0, "squaring_bwd": 0, "box_sum": 0,
    }
    log(f"serving path launches {counts} expected {expected} ({decodes} decodes)")
    for k in counts:
        if counts[k] != expected[k]:
            raise SystemExit(f"launch count of {k}: {counts[k]}, expected {expected[k]}")
    return counts, max(chunks)


# ----------------------------------------------------------------------
# phase 5b: the training path
# ----------------------------------------------------------------------

def run_train_path(dev, cfg_kw, steps):
    """The flagship training step: 1 warm-up and `steps` timed steps of
    `make_train_step` on one synthetic pair (B = 1)."""
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train import create_train_state, make_train_step

    cfg = PULPoConfig(**cfg_kw, batch_size=1)
    model = PULPoModel(cfg, device=dev)
    state, tx = create_train_state(model, seed=0)
    step = make_train_step(model, tx)
    pair = SyntheticDataset(shape=cfg.input_size, n=2, seed=1).get_pair(
        0, np.random.default_rng(1))
    batch = {k: torch.as_tensor(pair[k][None]).to(dev) for k in ("x", "y")}
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    log(f"training path: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype} {cfg.df_resolution} {cfg.recon_loss} "
        f"{cfg.regularizer} lr {cfg.lr} B 1")

    K = cfg.latent_levels
    times = []
    reset_counts()
    for i in range(1 + steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        losses = {k: float(metrics[k]) for k in
                  ("kl_loss", "reconstruction_loss", "regularization_loss", "total_loss")}
        if not all(math.isfinite(v) for v in losses.values()) or state.nan_flag:
            raise SystemExit(f"train step {i}: losses {losses}, nan_flag {state.nan_flag}")
        if i:
            times.append(dt)
        log(f"train step {i}{' (warm-up)' if i == 0 else ''}: {dt:.3f} s  "
            + "  ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    counts = read_counts()
    n = 1 + steps
    expected = {
        # per step and level: one integration forward (nsteps launches)
        # and backward (nsteps), one image warp and its df-cotangent (the
        # moving image needs no gradient, so no moving-cotangent), the
        # NCC's 5 box sums forward and 3 backward (of j, j^2 and ij; the
        # target's sums need none); the velocity head runs its plain
        # chain in train mode
        "warp": K * n, "squaring": cfg.nsteps * K * n, "vel_head": 0,
        "warp_dfgrad": K * n, "warp_mgrad": 0, "squaring_bwd": cfg.nsteps * K * n,
        "box_sum": (5 + 3) * K * n,
    }
    log(f"training path launches {counts} expected {expected} ({n} steps)")
    for k in counts:
        if counts[k] != expected[k]:
            raise SystemExit(f"launch count of {k}: {counts[k]}, expected {expected[k]}")
    changed = sum(not torch.equal(p.detach(), before[n])
                  for n, p in model.module.named_parameters())
    if changed == 0:
        raise SystemExit("training path: no parameter changed")
    peak = torch.cuda.max_memory_allocated()
    mean = sum(times) / len(times)
    log(f"training path: step {mean:.3f} s mean of {steps} ({' '.join(f'{t:.3f}' for t in times)}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, {changed} of {len(before)} "
        f"parameter tensors changed, {model.param_count} params")
    return counts, {"step_s": mean, "peak_gib": peak / 2**30}


# ----------------------------------------------------------------------
# phase 6: times
# ----------------------------------------------------------------------

def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def grid_for(df):
    """grid_sample's normalized (x, y, z) grid for a df: the reference
    SpatialTransformer's 2 * (loc / (size - 1) - 0.5)."""
    import torch

    size = df.shape[1:4]
    axes = [torch.arange(s, device=df.device, dtype=torch.float32) for s in size]
    mesh = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    loc = mesh[None] + df
    norm = torch.stack([2 * (loc[..., i] / (size[i] - 1) - 0.5) for i in range(3)], -1)
    return norm.flip(-1).contiguous()


def time_kernels(dev, full, level0, rows, zdim, n0):
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import squaring, vel_head, warp

    res = {}
    # warp at level 0: one moving image, `rows` sample dfs at full res
    img = torch.rand((1, *full, 1), device=dev)
    df = smooth_field(rows, full, 3.0, seed=11, device=dev)
    n = math.prod(full)
    bytes_ = 4 * (rows * n * 3 + rows * n * 1 + n)
    ms = time_ms(lambda: warp.warp(img, df), 10)
    plain = time_ms(lambda: warp.warp_plain(img, df), 2, warmup=1)
    grid = grid_for(df)
    mov = img.permute(0, 4, 1, 2, 3).expand(rows, -1, -1, -1, -1)
    lib = time_ms(lambda: F.grid_sample(mov, grid, mode="bilinear", padding_mode="border",
                                        align_corners=False), 10)
    gs = F.grid_sample(mov, grid, mode="bilinear", padding_mode="border", align_corners=False)
    log(f"grid_sample vs warp kernel max abs diff {float((gs.permute(0, 2, 3, 4, 1) - warp.warp(img, df)).abs().max()):.3e}")
    res["warp"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                       shape=f"moving (1,{','.join(map(str, full))},1) df ({rows},{','.join(map(str, full))},3) f32")
    del df, grid, mov, gs
    torch.cuda.empty_cache()

    # squaring: one step at level 0 on `rows` fields
    v = smooth_field(rows, level0, 3.0, seed=12, device=dev)
    out = torch.empty_like(v)
    nl = math.prod(level0)
    ms = time_ms(lambda: squaring.squaring_step(v, out), 20)
    plain = time_ms(lambda: squaring.squaring_step_plain(v), 3, warmup=1)
    res["squaring"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=2 * rows * nl * 3 * 4 / HBM_BYTES_PER_S * 1e3,
                           bound_by="bytes",
                           shape=f"({rows},{','.join(map(str, level0))},3) f32, one step")
    del v, out
    torch.cuda.empty_cache()

    # velocity head at level 0 in bf16
    p = head_params(zdim, n0, seed=13, device=dev)
    z = torch.randn((rows, *level0, zdim), device=dev, dtype=torch.bfloat16)
    flops = rows * nl * (2 * 27 * zdim * n0 + 2 * 27 * n0 * n0 + 2 * n0 * 3)
    bytes_ = rows * nl * (zdim + 3) * 2
    ms = time_ms(lambda: vel_head.velocity_head(z, p), 5)
    plain = time_ms(lambda: vel_head.velocity_head_plain(z, p), 2, warmup=1)
    bf = {k: t.to(torch.bfloat16) for k, t in p.items() if k.startswith(("k", "b"))}
    aff = [vel_head.head_bn(p, i) for i in (1, 2)]

    def cudnn_chain():
        x = z.permute(0, 4, 1, 2, 3)
        for i in (1, 2):
            x = F.conv3d(x, bf[f"k{i}"], bf[f"b{i}"], padding=1)
            m, mul, add = (t.view(1, -1, 1, 1, 1) for t in aff[i - 1])
            x = F.leaky_relu(((x.float() - m) * mul + add).to(torch.bfloat16), 0.2)
        return F.conv3d(x, bf["k3"], bf["b3"])

    lib = time_ms(cudnn_chain, 5)
    res["vel_head"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=max(flops / BF16_FLOP_PER_S, bytes_ / HBM_BYTES_PER_S) * 1e3,
                           bound_by="operations" if flops / BF16_FLOP_PER_S > bytes_ / HBM_BYTES_PER_S else "bytes",
                           shape=f"z ({rows},{','.join(map(str, level0))},{zdim}) bf16, n0 {n0}")
    return res


def time_backward_kernels(dev, cfg):
    """The training path's kernels at its shapes (B = 1). Bounds count
    each input read once and each output written once; every one of
    these kernels does far fewer float32 operations per byte than the
    card's 67 TFLOP/s against 3.35 TB/s, so bytes bound them."""
    import torch
    import torch.nn.functional as F

    from pulpo_tpu_torch.kernels import box_sum, squaring, warp

    res = {}
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    n, nl = math.prod(full), math.prod(level0)
    fmt = lambda size: ",".join(map(str, size))

    # df-cotangent at level 0: moving, df, g at full res, C = 1
    img = torch.rand((1, *full, 1), device=dev)
    df = smooth_field(1, full, 3.0, seed=31, device=dev)
    cot = torch.randn((1, *full, 1), device=dev)
    ms = time_ms(lambda: warp.warp_dfgrad(img, df, cot), 10)
    plain = time_ms(lambda: warp.warp_dfgrad_plain(img, df, cot), 2, warmup=1)
    grid = grid_for(df).requires_grad_(True)
    out = F.grid_sample(img.permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                        padding_mode="border", align_corners=False)
    gcf = cot.permute(0, 4, 1, 2, 3)
    lib = time_ms(lambda: torch.autograd.grad(out, grid, gcf, retain_graph=True), 10)
    res["warp_dfgrad"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=n * (4 + 12 + 4 + 12) / HBM_BYTES_PER_S * 1e3,
                              bound_by="bytes",
                              shape=f"moving (1,{fmt(full)},1) df/g (1,{fmt(full)},3/1) f32")
    del img, df, cot, grid, out, gcf
    torch.cuda.empty_cache()

    # moving-cotangent at level 0, C = 3 (its role in the squaring backward)
    df = smooth_field(1, level0, 3.0, seed=32, device=dev)
    cot = torch.randn((1, *level0, 3), device=dev)
    shape = (1, *level0, 3)
    ms = time_ms(lambda: warp.warp_mgrad(shape, df, cot), 20)
    plain = time_ms(lambda: warp.warp_mgrad_plain(shape, df, cot), 2, warmup=1)
    mov = torch.rand((1, 3, *level0), device=dev, requires_grad=True)
    out = F.grid_sample(mov, grid_for(df), mode="bilinear", padding_mode="border",
                        align_corners=False)
    gcf = cot.permute(0, 4, 1, 2, 3)
    lib = time_ms(lambda: torch.autograd.grad(out, mov, gcf, retain_graph=True), 20)
    res["warp_mgrad"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=nl * (12 + 12 + 12) / HBM_BYTES_PER_S * 1e3,
                             bound_by="bytes", shape=f"df/g/out (1,{fmt(level0)},3) f32")
    del df, cot, mov, out, gcf

    # squaring backward: one step at level 0
    v = smooth_field(1, level0, 3.0, seed=33, device=dev)
    cot = torch.randn((1, *level0, 3), device=dev)
    ms = time_ms(lambda: squaring.squaring_step_bwd(v, cot), 20)
    plain = time_ms(lambda: squaring.squaring_step_bwd_plain(v, cot), 2, warmup=1)
    res["squaring_bwd"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                               bound_ms=nl * (12 + 12 + 12) / HBM_BYTES_PER_S * 1e3,
                               bound_by="bytes", shape=f"v/g (1,{fmt(level0)},3) f32, one step")
    del v, cot

    # box sum at level 0's recon size (full res), window 9
    x = torch.rand((1, *full), device=dev)
    ms = time_ms(lambda: box_sum.box_sum(x, 9), 20)
    plain = time_ms(lambda: box_sum.box_sum_plain(x, 9), 2, warmup=1)
    x5 = x[:, None]
    lib = time_ms(lambda: F.avg_pool3d(x5, 9, stride=1, padding=4,
                                       count_include_pad=True) * 729.0, 10)
    res["box_sum"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=n * (4 + 4) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                          shape=f"(1,{fmt(full)}) f32, window 9")
    del x, x5
    torch.cuda.empty_cache()
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs)} in {time.perf_counter() - t:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    cfg = PULPoConfig(**FLAGSHIP)
    full, level0 = cfg.input_size, cfg.level_sizes[0]
    t = time.perf_counter()
    checks = Checks()
    check_kernels(dev, full, level0, checks)
    torch.cuda.empty_cache()
    check_backward_kernels(dev, cfg, checks)
    torch.cuda.empty_cache()
    if checks.failures:
        raise SystemExit(f"kernel checks failed: {checks.failures}")
    log(f"kernel checks passed in {time.perf_counter() - t:.1f} s")
    check_small_reference(dev)
    check_small_train(dev)

    uq_counts, chunk = run_main_path(dev, FLAGSHIP, N_SAMPLES, N_REQUESTS)
    torch.cuda.empty_cache()
    train_counts, train = run_train_path(dev, FLAGSHIP, TRAIN_STEPS)
    torch.cuda.empty_cache()

    times = time_kernels(dev, full, level0, chunk, cfg.zdim, cfg.n0)
    times.update(time_backward_kernels(dev, cfg))
    for k, r in times.items():
        log(f"time {k:12s} {r['shape']}: kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
            f"library {'-' if r['library_ms'] is None else format(r['library_ms'], '.3f')} ms  "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    kernels = []
    for name in KERNELS:
        r = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": uq_counts[name] + train_counts[name],
            "launches_by_path": {"serving": uq_counts[name], "training": train_counts[name]},
            "max_abs_err": checks.worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    log(f"training step {train['step_s']:.3f} s, peak {train['peak_gib']:.2f} GiB")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
