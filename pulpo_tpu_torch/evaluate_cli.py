"""Evaluation CLI: the flags of the JAX package's evaluate_cli (the
reference's evaluate.py __main__, evaluate.py:1806-1840) and
`--accelerator`.

    python -m pulpo_tpu_torch.evaluate_cli --run_dir runs/<exp>/version_0 \
        --task oasis --segs --lms --data_path OASIS.h5 --N 10 --no_visualize

`--accelerator gpu` (the default) runs on `cuda`, `cpu` on the CPU.
Unless `--no_visualize` is given, the command first writes the figures
(`Evaluate.run_one_model`): each figure's panels as
`evaluation/vis/allvis<loader>_<prediction>.npz`, its `.png` where
matplotlib is installed, and the JDet tables under `evaluation/jdet`.
`--export PATH` writes the loaded model's serving artifact
(`serve.export_model`, at `--export_batch` pairs and `--N` samples) and
returns, as the JAX CLI does.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a trained model.")
    p.add_argument("--run_dir", type=str, default=None,
                   help="run directory (contains config.json + checkpoints/)")
    # reference-style addressing: model_dir + git_hash + version
    p.add_argument("--model_dir", type=str, default="runs")
    p.add_argument("--git_hash", type=str, default=None,
                   help="experiment name (reference: git hash + seed)")
    p.add_argument("--version", type=str, default=None, help="e.g. version_0")
    p.add_argument("--segs", action="store_true", default=False)
    p.add_argument("--lms", action="store_true", default=False)
    p.add_argument("--mask", action="store_true", default=False)
    p.add_argument("--task", type=str, default="oasis")
    p.add_argument("--N", type=int, default=10)
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--no_visualize", action="store_true", default=False)
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="export the model's serving artifact (serve.py) to PATH and exit")
    p.add_argument("--export_batch", type=int, default=1)
    p.add_argument("--accelerator", type=str, default="gpu",
                   help="gpu (cuda, the default) or cpu")
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    from pulpo_tpu_torch.train_cli import device_of

    device = device_of(args.accelerator)
    from pulpo_tpu_torch.eval.evaluator import Evaluate

    run_dir = args.run_dir
    if run_dir is None:
        if args.git_hash is None or args.version is None:
            from pulpo_tpu_torch.train.checkpoint import latest_run

            run_dir = latest_run(args.model_dir, args.git_hash)
            if run_dir is None:
                raise SystemExit("no run found; pass --run_dir")
        else:
            run_dir = f"{args.model_dir}/{args.git_hash}/{args.version}"

    ev = Evaluate(device=device)
    ev.load_model(run_dir)
    if args.export:
        from pulpo_tpu_torch.serve import export_model

        export_model(ev.model, args.export, batch_size=args.export_batch, N=args.N)
        print(f"exported serving artifact -> {args.export}")
        return None
    perf, unc = ev.run_one_model(
        segs=args.segs, lms=args.lms, mask=args.mask, N=args.N, task=args.task,
        data_path=args.data_path, visualize=not args.no_visualize)
    print(perf)
    if unc is not None:
        print(unc)
    return perf, unc


if __name__ == "__main__":
    main()
