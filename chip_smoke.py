#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PULPo on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi); no CUDA device -> fail;
2. build the three CUDA kernels from pulpo_tpu_torch/csrc (one nvcc per
   source, all started together);
3. hold each kernel against its plain PyTorch version (TF32 off) at the
   main path's shapes, within a stated tolerance;
4. a small-input reference: a UQ request on the card against the same
   weights and draws on the CPU (plain versions), leaf by leaf;
5. the main path: the flagship config (160x192x224, 5/4 levels, n0=32,
   bf16, level_res) with seeded random weights answers 3 requests, each
   `predict_with_uncertainty` with N=32 on one synthetic pair. Every
   leaf must be finite and each kernel's launch count must equal the
   count the shapes give;
6. per-kernel times (CUDA events) beside their bounds, the plain
   versions' times and one library call's time.

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
FLAGSHIP = dict(input_size=(160, 192, 224), total_levels=5, latent_levels=4,
                n0=32, compute_dtype="bfloat16", df_resolution="level_res",
                dataset="synthetic")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOP_PER_S = 989e12       # dense tensor-core peak, published

REPLACES = {
    "warp": "pulpo_tpu/kernels/warp_halo.py:322",
    "squaring": "pulpo_tpu/kernels/warp_local.py:142",
    "vel_head": "pulpo_tpu/kernels/vel_head.py:185",
}
SOURCES = {
    "warp": "pulpo_tpu_torch/csrc/warp.cu",
    "squaring": "pulpo_tpu_torch/csrc/squaring.cu",
    "vel_head": "pulpo_tpu_torch/csrc/vel_head.cu",
}


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

def check_kernels(dev, full, level0, rows=4):
    """Each kernel against its plain version; returns the max abs error
    per kernel. `full`: input size; `level0`: latent level-0 size."""
    import torch

    from pulpo_tpu_torch.kernels import squaring, vel_head, warp

    worst = {"warp": 0.0, "squaring": 0.0, "vel_head": 0.0}
    failures = []

    def record(name, case, got, ref, tol):
        err = float((got.float() - ref.float()).abs().max())
        worst[name] = max(worst[name], err)
        ok = err <= tol and bool(torch.isfinite(got).all())
        log(f"check {name:9s} {case:44s} max_abs_err {err:.3e}  tol {tol:.1e}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {case}")

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
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    return worst


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


# ----------------------------------------------------------------------
# phase 5: the main path
# ----------------------------------------------------------------------

def run_main_path(dev, cfg_kw, n_samples, n_requests):
    import numpy as np
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.kernels import squaring, vel_head, warp
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    cfg = PULPoConfig(**cfg_kw)
    t0 = time.perf_counter()
    model = PULPoModel(cfg, device=dev)
    model.init(seed=0)
    ds = SyntheticDataset(shape=cfg.input_size, n=n_requests + 1, seed=0)
    pairs = [ds.get_pair(i, np.random.default_rng(i)) for i in range(n_requests)]
    log(f"main path: {cfg.input_size} levels {cfg.total_levels}/{cfg.latent_levels} "
        f"n0 {cfg.n0} {cfg.compute_dtype} {cfg.df_resolution}, "
        f"{model.param_count} params, set-up {time.perf_counter() - t0:.1f} s")

    K = cfg.latent_levels
    decodes = 0
    chunks = []
    for mod in (warp, squaring, vel_head):
        mod.reset_count()
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
    counts = {"warp": warp.launches, "squaring": squaring.launches,
              "vel_head": vel_head.launches}
    expected = {
        # each decode: one image warp and one integration per level, and a
        # head per level; each request's mean-SVF tail: one integration
        # and one warp per level
        "warp": K * (decodes + n_requests),
        "squaring": cfg.nsteps * K * (decodes + n_requests),
        "vel_head": K * decodes,
    }
    log(f"launches {counts} expected {expected} ({decodes} decodes)")
    for k in counts:
        if counts[k] != expected[k] or counts[k] == 0:
            raise SystemExit(f"launch count of {k}: {counts[k]}, expected {expected[k]}")
    return counts, max(chunks)


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
    for k, r in res.items():
        log(f"time {k:9s} {r['shape']}: kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
            f"library {'-' if r['library_ms'] is None else format(r['library_ms'], '.3f')} ms  "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
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
    errs = check_kernels(dev, full, level0)
    log(f"kernel checks passed in {time.perf_counter() - t:.1f} s")
    check_small_reference(dev)

    counts, chunk = run_main_path(dev, FLAGSHIP, N_SAMPLES, N_REQUESTS)
    torch.cuda.empty_cache()

    times = time_kernels(dev, full, level0, chunk, cfg.zdim, cfg.n0)
    kernels = []
    for name in ("warp", "squaring", "vel_head"):
        r = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
