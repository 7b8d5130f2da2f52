#!/usr/bin/env python3
"""How far apart are two runs of the same Trainer steps on the card?

    python3 scripts/probe_trainer_spread.py [--runs 6] [--settings NAME,...] [--json PATH]
    python3 scripts/probe_trainer_spread.py --pool A.json B.json ...

Runs the two Trainer steps of tests/test_torch_gpu.py::
test_trainer_on_the_card_matches_the_cpu (24x28x32, 3/2 levels, n0 = 8,
synthetic pairs, validation, checkpoints and logging after each step,
posterior draws made on the CPU) once on the CPU and `runs` times on the
card in one process, under each of three settings:
- `default`: as the test runs them;
- `cudnn_deterministic`: `torch.backends.cudnn.deterministic = True`
  (and `benchmark = False`), so cuDNN takes deterministic algorithms;
- `cudnn_deterministic_plain_bwd`: that, and the squaring step's
  backward kernel (csrc/squaring_bwd.cu) replaced by its plain version
  run on the CPU (the moving-cotangent kernel is not launched: the
  moving image needs no gradient).
The squaring backward sums its scatter order-free in 64-bit fixed point
(csrc/fixed.cuh), so under `cudnn_deterministic` no add of the step
depends on the order it lands in, and two card runs are expected to give
the same bits (a float32-atomic scatter made them differ by up to
1.04e-3). For each setting and logged metric it prints the largest
relative difference between two card runs (the card-to-card spread) and
between the card and the CPU. TF32 is off, as in the test. The test
runs once a process, so run the script in several processes (a shell
loop), each with --json, and pool their records with --pool: the spread
between any two runs of all processes, per setting and metric. Needs a
CUDA device (not for --pool).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def run_steps(cfg, dev, run_root: str, tag: str) -> list[dict]:
    """The logged rows of two Trainer steps on `dev`."""
    from pulpo_tpu_torch.data.loader import DataLoader
    from pulpo_tpu_torch.data.synthetic import SyntheticDataset
    from pulpo_tpu_torch.train.loop import Trainer
    from pulpo_tpu_torch.train.metrics import read_metrics

    ds = SyntheticDataset(shape=cfg.input_size, n=4, seed=3)
    trainer = Trainer(cfg, run_dir=run_root, experiment=tag, device=dev)
    state = trainer.fit(DataLoader(ds, 1, shuffle=True, seed=0), DataLoader(ds, 1, seed=1),
                        max_steps=2)
    trainer.close()
    assert state.step == 2 and not state.nan_flag
    return read_metrics(trainer.run_dir)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-6)


def spread(rows: list[list[dict]], ref: list[dict]) -> dict:
    """Per metric (step/key): the largest relative difference between two
    of `rows`, and between any of them and `ref`."""
    out = {}
    for i, r in enumerate(ref):
        for k in r:
            if k == "step":
                continue
            vals = [run[i][k] for run in rows]
            out[f"{r['step']}/{k}"] = {
                "card_card": max(rel(a, b) for a in vals for b in vals),
                "card_cpu": max(rel(a, r[k]) for a in vals),
                "values": vals, "cpu": r[k]}
    return out


def pool(paths: list[str]) -> int:
    """The card-to-card spread over the runs of several processes' JSON
    records, per setting and metric, and its largest value per setting."""
    records = []
    for path in paths:
        with open(path) as fh:
            records.append(json.load(fh))
    print(f"pooled {len(records)} processes; cards: {sorted({r['card'] for r in records})}")
    for setting in records[0]["results"]:
        worst = 0.0
        for k in records[0]["results"][setting]:
            vals = [v for r in records for v in r["results"][setting][k]["values"]]
            d = max(rel(a, b) for a in vals for b in vals)
            worst = max(worst, d)
            print(f"  {setting} {k:28s} card-card {d:.3e} over {len(vals)} runs")
        print(f"{setting}: card-to-card spread over all processes at most {worst:.3e}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--settings", default="default,cudnn_deterministic,"
                    "cudnn_deterministic_plain_bwd")
    ap.add_argument("--json", default=None)
    ap.add_argument("--pool", nargs="+", default=None,
                    help="pool these JSON records (of --json) instead of running")
    args = ap.parse_args()
    if args.pool:
        return pool(args.pool)

    import torch

    if not torch.cuda.is_available():
        print("probe_trainer_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import card_line
    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.kernels import squaring
    from pulpo_tpu_torch.models import pulpo

    print(f"card: {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plain_draw = pulpo.draw_normal
    pulpo.draw_normal = (lambda seed, samples, level, shape, device:
                         plain_draw(seed, samples, level, shape, "cpu").to(device))
    cfg = PULPoConfig(input_size=(24, 28, 32), total_levels=3, latent_levels=2, n0=8,
                      log_every_n_steps=1, dataset="synthetic")
    kernel_bwd = squaring.squaring_step_bwd
    results = {}
    with tempfile.TemporaryDirectory() as root:
        ref = run_steps(cfg, "cpu", root, "cpu")
        for setting in args.settings.split(","):
            torch.backends.cudnn.deterministic = setting != "default"
            torch.backends.cudnn.benchmark = False
            if setting.endswith("plain_bwd"):
                squaring.squaring_step_bwd = (
                    lambda v, g: kernel_bwd(v.cpu(), g.cpu()).to(v.device))
            rows = [run_steps(cfg, torch.device("cuda"), root, f"{setting}_{i}")
                    for i in range(args.runs)]
            squaring.squaring_step_bwd = kernel_bwd
            results[setting] = spread(rows, ref)
            print(f"{setting}: card-to-card spread at most "
                  f"{max(d['card_card'] for d in results[setting].values()):.3e}, "
                  f"card-to-CPU at most {max(d['card_cpu'] for d in results[setting].values()):.3e}",
                  flush=True)
            for k, d in results[setting].items():
                print(f"  {k:28s} card-card {d['card_card']:.3e}  card-cpu {d['card_cpu']:.3e}")
    torch.backends.cudnn.deterministic = False
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card_line(), "runs": args.runs, "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
