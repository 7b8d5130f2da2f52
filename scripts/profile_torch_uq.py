#!/usr/bin/env python3
"""Where a UQ-32 request's time goes on the card (PyTorch/CUDA port).

    python3 scripts/profile_torch_uq.py [--requests 2] [--top 25]

Builds the flagship model (160x192x224, 5/4 levels, n0=32, bf16,
level_res) with seeded random weights, answers one warm-up request,
then profiles `--requests` more with torch.profiler. Prints the card,
each request's host-clock time, the device's busy time (the union of
kernel intervals on the card) and idle share, and the kernels by device
time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def busy_ms(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_uq: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.kernels import _build
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    _build.build_all()
    cfg = PULPoConfig(input_size=(160, 192, 224), total_levels=5, latent_levels=4,
                      n0=32, compute_dtype="bfloat16", dataset="synthetic")
    model = PULPoModel(cfg)
    model.init(0)
    pair = SyntheticDataset(shape=cfg.input_size, n=2, seed=0).get_pair(
        0, np.random.default_rng(0))
    x = torch.as_tensor(pair["x"][None]).cuda()
    y = torch.as_tensor(pair["y"][None]).cuda()
    predict_with_uncertainty(model, x, y, 32, seed=0)  # warm-up (+ chunk calibration)
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.requests):
            t = time.perf_counter()
            predict_with_uncertainty(model, x, y, 32, seed=i + 1)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kernels)
    wall = sum(walls)
    print(f"requests (ms, host clock, profiled): {' '.join(f'{w:.1f}' for w in walls)}")
    print(f"device busy {busy:.1f} ms of {wall:.1f} ms -> idle share {1 - busy / wall:.3f}")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e3)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    total = sum(sum(v) for _, v in rows)
    print(f"{'device ms/request':>18s} {'share':>6s} {'calls/req':>9s}  kernel")
    for name, ts in rows[:args.top]:
        print(f"{sum(ts) / args.requests:18.2f} {sum(ts) / total:6.3f} "
              f"{len(ts) / args.requests:9.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
