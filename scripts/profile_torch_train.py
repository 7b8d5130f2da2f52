#!/usr/bin/env python3
"""Where a training step's time goes on the card (PyTorch/CUDA port).

    python3 scripts/profile_torch_train.py [--steps 3] [--top 30]

Builds the flagship model (160x192x224, 5/4 levels, n0=32, bf16,
level_res, NCC + KL + L2, Adam lr 1e-4, B = 1) with seeded random
weights, takes one warm-up step on a synthetic pair, then profiles
`--steps` more with torch.profiler. Prints the card, each step's
host-clock time, the peak device memory, the device's busy time (the
union of kernel intervals on the card) and idle share, the device time
of the port's own kernels against everything else, and the kernels by
device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

# device-kernel names of the port's hand-written kernels (csrc/*.cu)
OWN_KERNELS = ("warp_kernel", "squaring_kernel", "vel_head", "dfgrad_kernel",
               "mgrad_kernel", "squaring_bwd_kernel", "box_axis_kernel")


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
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.kernels import _build
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.train import create_train_state, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    _build.build_all()
    cfg = PULPoConfig(input_size=(160, 192, 224), total_levels=5, latent_levels=4,
                      n0=32, compute_dtype="bfloat16", df_resolution="level_res",
                      dataset="synthetic", batch_size=1)
    model = PULPoModel(cfg)
    state, tx = create_train_state(model, seed=0)
    step = make_train_step(model, tx)
    pair = SyntheticDataset(shape=cfg.input_size, n=2, seed=0).get_pair(
        0, np.random.default_rng(0))
    batch = {"x": torch.as_tensor(pair["x"][None]).cuda(),
             "y": torch.as_tensor(pair["y"][None]).cuda()}
    state, _ = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
    print(f"steps (ms, host clock, profiled): {' '.join(f'{w:.1f}' for w in walls)}; "
          f"total_loss {float(metrics['total_loss']):.4f}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kernels)
    wall = sum(walls)
    print(f"device busy {busy:.1f} ms of {wall:.1f} ms -> idle share {1 - busy / wall:.3f}")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e3)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    total = sum(sum(v) for _, v in rows)
    own = sum(sum(v) for n, v in rows if any(k in n for k in OWN_KERNELS))
    print(f"port's own kernels {own / args.steps:.1f} ms/step ({own / total:.3f} of device "
          f"time); everything else {(total - own) / args.steps:.1f} ms/step")
    print(f"{'device ms/step':>15s} {'share':>6s} {'calls/step':>10s}  kernel")
    for name, ts in rows[:args.top]:
        print(f"{sum(ts) / args.steps:15.2f} {sum(ts) / total:6.3f} "
              f"{len(ts) / args.steps:10.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
