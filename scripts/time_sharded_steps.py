#!/usr/bin/env python3
"""Time the depth-sharded training steps of a tree, and check whether the
output-channel split's ranks compute their replicated gradients alike
under cuDNN's default settings.

    python3 scripts/time_sharded_steps.py --tree DIR [--repeats 3] [--tp] [--json PATH]
    python3 scripts/time_sharded_steps.py --tree DIR --accelerator cpu --small   # rehearsal

Starts two torchrun processes that share one card over gloo (mesh (1, 2),
as `chip_smoke.py` phase 11 runs them), each importing `pulpo_tpu_torch`
from DIR, so that a parent commit and its change (each unpacked with `git
archive`) can be timed in one call on one card. Each rank builds the
flagship network (160x192x224, 5 / 4 levels, n0 32, B = 1; `--small`: a
32^3 volume, 3 / 2 levels, n0 8) with random weights from seed 0, takes
the synthetic pair and the draws of `chip_smoke.py` phase 11, and runs
the sharded step `spatial.spatial_compute_grads` in bf16, in f32 and in
f32 at full_res: once to warm up, then `repeats` times between two
synchronizes of the card, each time with its exchanges
(`spatial.traffic`: calls and bytes by kind) and the peak.

With --tp each rank then takes the training step's gradients under the
output-channel split at model 2 (`tp.sharded`), in bf16 and f32, with
cuDNN at its defaults (deterministic and benchmark off, TF32 off), twice,
and keeps its replicated leaves' gradients as it computed them (where
the tree still averages them over the ranks, `tp.mean_replicated`, the
average is left out); the launcher prints how far apart the two ranks'
are (0: bit-equal), and how far rank 0's two runs.

Prints one line a case and rank, and one JSON object as its last line
(also written to --json).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

FLAGSHIP = dict(input_size=(160, 192, 224), total_levels=5, latent_levels=4, n0=32,
                compute_dtype="bfloat16", df_resolution="level_res", dataset="synthetic")
SMALL = dict(FLAGSHIP, input_size=(32, 32, 32), total_levels=3, latent_levels=2, n0=8)
FULLRES_KW = dict(df_resolution="full_res",
                  feedback=("samples", "velocity_fields", "individual_dfs", "combined_dfs",
                            "final_dfs"))
STEPS = (("step bfloat16", {}, "bfloat16"), ("step float32", {}, "float32"),
         ("fullres step float32", FULLRES_KW, "float32"))
SPACE = 2


def inputs(cfg, dev):
    """chip_smoke.py phase 11's batch (one synthetic pair) and draws."""
    import numpy as np
    import torch

    from pulpo_tpu_torch.data.synthetic import SyntheticDataset

    pair = SyntheticDataset(shape=cfg.input_size, n=2, seed=1).get_pair(0, np.random.default_rng(1))
    batch = {k: torch.as_tensor(pair[k][None]).to(dev) for k in ("x", "y")}
    g = np.random.default_rng(7)
    noise = {l: torch.from_numpy(g.standard_normal((1, *cfg.level_sizes[l], cfg.zdim),
                                                   dtype=np.float32))
             for l in range(cfg.latent_levels)}
    return batch, noise


def worker(tree: str, accelerator: str, small: bool, repeats: int, do_tp: bool,
           out_dir: str) -> int:
    """One rank: the timed sharded steps, then (--tp) the split's
    replicated gradients; writes `out_dir/rank_<r>.pt`."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from pulpo_tpu_torch import PULPoConfig
    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.parallel import multihost, spatial, tp
    from pulpo_tpu_torch.train.step import compute_grads

    dev = torch.device("cuda" if accelerator == "gpu" else "cpu")
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(device=dev, backend="gloo")
    rank = torch.distributed.get_rank()
    base = SMALL if small else FLAGSHIP
    out = {"rank": rank, "steps": {}, "tp": {}}
    try:
        cfg = PULPoConfig(**base, batch_size=1)
        batch, noise = inputs(cfg, dev)
        mesh = spatial.make_2d_mesh(1, SPACE)
        block = {k: spatial.shard_volume(v, mesh) for k, v in batch.items()}
        for name, kw, dtype in STEPS:
            model = PULPoModel(PULPoConfig(**{**base, **kw, "compute_dtype": dtype},
                                           batch_size=1), device=dev)
            model.init(0)
            run = lambda: spatial.spatial_compute_grads(model, block, mesh, noise=noise)
            run()
            times, traffic, peak = [], None, 0.0
            for _ in range(repeats):
                spatial.reset_traffic()
                sync()
                if card:
                    base_mem = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                run()
                sync()
                times.append(time.perf_counter() - t)
                traffic = dict(spatial.traffic)
                if card:
                    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
            out["steps"][name] = {"s": times, "traffic": traffic, "peak": peak}
            del model
            if card:
                torch.cuda.empty_cache()
        if do_tp:
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.benchmark = False
            tmesh = tp.make_model_mesh(SPACE)
            average = getattr(tp, "mean_replicated", None)
            if average is not None:
                tp.mean_replicated = lambda grads, model: grads
            try:
                for dtype in ("bfloat16", "float32"):
                    model = PULPoModel(cfg.replace(compute_dtype=dtype), device=dev)
                    tp.shard_params(model, tmesh)
                    model.init(0)
                    for i in range(2):
                        with tp.sharded(tmesh):
                            grads, _, _ = compute_grads(model, batch, noise=noise)
                        out["tp"][f"{dtype} run {i}"] = {
                            n: g.detach().cpu() for n, g in grads.items()
                            if n not in model.module.tp_split}
                        del grads
                    del model
                    if card:
                        torch.cuda.empty_cache()
            finally:
                if average is not None:
                    tp.mean_replicated = average
        torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))
    finally:
        multihost.shutdown()
    return 0


def apart(a: dict, b: dict) -> float:
    """Relative L2 distance of two gradient dicts (0: bit-equal)."""
    num = sum(float((a[n].double() - b[n].double()).pow(2).sum()) for n in a)
    den = sum(float(b[n].double().pow(2).sum()) for n in a)
    return (num / max(den, 1e-300)) ** 0.5


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", required=True, help="the checkout whose pulpo_tpu_torch to run")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--tp", action="store_true", help="also the split's replicated gradients")
    p.add_argument("--accelerator", default="gpu", choices=("gpu", "cpu"))
    p.add_argument("--small", action="store_true", help="a small network (rehearsal)")
    p.add_argument("--json", default=None)
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker is not None:
        return worker(a.tree, a.accelerator, a.small, a.repeats, a.tp, a.worker)
    import torch

    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(SPACE), os.path.abspath(__file__), "--tree", a.tree,
               "--repeats", str(a.repeats), "--accelerator", a.accelerator, "--worker", out]
        cmd += ["--tp"] * a.tp + ["--small"] * a.small
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], sep="\n")
            return proc.returncode
        ranks = [torch.load(os.path.join(out, f"rank_{r}.pt"), weights_only=False)
                 for r in range(SPACE)]
    record = {"tree": a.tree, "steps": {}, "tp": {}}
    for name in ranks[0]["steps"]:
        record["steps"][name] = [r["steps"][name] for r in ranks]
        for r in ranks:
            s = r["steps"][name]
            print(f"{name} rank {r['rank']}: median {statistics.median(s['s']):.4f} s of "
                  f"{' '.join(f'{t:.4f}' for t in s['s'])}, peak {s['peak']:.3f} GiB, "
                  f"exchanges {s['traffic']}", flush=True)
    for key in ranks[0]["tp"]:
        d = apart(ranks[1]["tp"][key], ranks[0]["tp"][key])
        odd = sorted(n for n, g in ranks[0]["tp"][key].items()
                     if not torch.equal(g, ranks[1]["tp"][key][n]))
        record["tp"][key] = {"ranks_apart": d, "leaves": len(ranks[0]["tp"][key]),
                             "unequal_leaves": odd}
        print(f"tp {key} (cuDNN defaults): the ranks' {len(ranks[0]['tp'][key])} replicated "
              f"leaves' gradients {d:.3e} apart (relative L2), {len(odd)} leaves not bit-equal",
              flush=True)
    for dtype in ("bfloat16", "float32"):
        runs = [ranks[0]["tp"].get(f"{dtype} run {i}") for i in range(2)]
        if all(runs):
            record["tp"][f"{dtype} run-to-run"] = apart(runs[1], runs[0])
            print(f"tp {dtype} (cuDNN defaults): rank 0's replicated gradients run to run "
                  f"{record['tp'][f'{dtype} run-to-run']:.3e}", flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(record, f)
    print(json.dumps({"tree": a.tree, "median_s": {
        n: [statistics.median(r["s"]) for r in v] for n, v in record["steps"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
