"""Training CLI: every flag of the JAX package's train_cli (the
reference's train.py:133-168).

    python -m pulpo_tpu_torch.train_cli --dataset lungct --data_path LungCT.h5 \
        --compute_dtype bfloat16 --max_steps 1000

`--accelerator` picks the device: `gpu` (the default) runs on `cuda`,
`cpu` on the CPU (the kernels' plain versions). `--dataset` reads
OASIS (`--segs` adds the one-hot segmentations for a `dice` loss),
BraTS (the default; `--interpatient` pairs across patients), LungCT or
synthetic pairs; `--ndims 2` trains the 2D configuration on OASIS
slices or 64x64 synthetic ones. After training the run is evaluated
(`Evaluate.run_one_model`: the performance and uncertainty tables)
unless `--skip_eval` is given. Unlike the JAX CLI, it draws no figures
there: `evaluate_cli` draws them.

Data parallelism: one process a replica, under torchrun,

    torchrun --nproc_per_node 4 -m pulpo_tpu_torch.train_cli \
        --data_parallel 4 --batch_size 4 ...

(`--batch_size` is the global batch; each rank trains on its rows).
The process group starts from torchrun's environment with NCCL on `gpu`
and gloo on `cpu`, or the backend `--dist_backend` names (gloo also
carries CUDA tensors, as two ranks sharing one card need). Only rank 0
writes the run directory and evaluates the run.
"""

from __future__ import annotations

import argparse
import os
import subprocess

ACCELERATORS = {"gpu": "cuda", "cpu": "cpu"}


def get_git_revision_short_hash() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"], stderr=subprocess.DEVNULL
        ).decode("ascii").strip()
    except (OSError, subprocess.CalledProcessError):
        return "nogit"


def device_of(accelerator: str) -> str:
    if accelerator not in ACCELERATORS:
        raise ValueError(f"--accelerator {accelerator!r}: expected one of {sorted(ACCELERATORS)}")
    return ACCELERATORS[accelerator]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Main trainer file for all models.")
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--max_epochs", type=int, default=1000)
    p.add_argument("--accelerator", type=str, default="gpu",
                   help="gpu (cuda, the default) or cpu")
    p.add_argument("--dataset", type=str, default="brats",
                   help="brats, oasis, lungct or synthetic")
    p.add_argument("--segs", action="store_true", default=False)
    p.add_argument("--lms", action="store_true", default=False)
    p.add_argument("--mask", action="store_true", default=False)
    p.add_argument("--total_levels", type=int, default=5)
    p.add_argument("--latent_levels", type=int, default=4)
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--recon_loss", nargs="+", default=["ncc"],
                   help="subset of: mse ncc dice")
    p.add_argument("--dice_factor", type=int, default=50)
    p.add_argument("--gamma", type=float, default=0.05)
    p.add_argument("--similarity_pyramid", action="store_true", default=False)
    p.add_argument("--lambda", type=float, default=0.025, dest="lamb")
    p.add_argument("--regularizer", type=str, default="L2", help="L2 or jdet")
    p.add_argument("--image_logging_frequency", type=int, default=5000)
    p.add_argument("--feedback", nargs="+",
                   default=["samples", "velocity_field", "individual_dfs",
                            "combined_dfs", "final_dfs", "transformed"])
    p.add_argument("--df_resolution", type=str, default="level_res")
    p.add_argument("--n0", type=int, default=32)
    p.add_argument("--ndims", type=int, default=3)
    p.add_argument("--interpatient", action="store_true", default=False)
    p.add_argument("--nondiagonal", action="store_true", default=False)
    p.add_argument("--cp_depth", type=int, default=3)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="float32 or bfloat16")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="data-parallel replicas: the torchrun world size")
    p.add_argument("--dist_backend", type=str, default=None,
                   help="process-group backend (default nccl on gpu, gloo on cpu)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--run_dir", type=str, default="runs")
    p.add_argument("--data_path", type=str, default=None,
                   help="override the dataset .h5 path")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10-13 here")
    p.add_argument("--skip_eval", action="store_true", default=False)
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    device = device_of(args.accelerator)

    from pulpo_tpu_torch.config import PULPoConfig

    # the input size comes from the data (reference: train.py:80)
    if args.dataset == "oasis":
        from pulpo_tpu_torch.data import oasis

        train_loader, val_loader, _, _ = oasis.create_data_loaders(
            args.batch_size, segs=args.segs, lms=False, mask=False,
            ndims=args.ndims, path=args.data_path, seed=args.random_seed)
        input_size = train_loader.dataset.input_size
    elif args.dataset == "brats":
        from pulpo_tpu_torch.data import brats

        train_loader, val_loader, _ = brats.create_data_loaders(
            args.batch_size, segs=args.segs, lms=args.lms, mask=args.mask,
            ndims=args.ndims, interpatient=args.interpatient,
            path=args.data_path, seed=args.random_seed)
        input_size = train_loader.dataset.input_size
    elif args.dataset == "lungct":
        from pulpo_tpu_torch.data import lungct

        train_loader, val_loader, _ = lungct.create_data_loaders(
            args.batch_size, segs=False, lms=args.lms, mask=args.mask,
            ndims=args.ndims, path=args.data_path, seed=args.random_seed)
        input_size = train_loader.dataset.input_size
    elif args.dataset == "synthetic":
        from pulpo_tpu_torch.data.loader import DataLoader
        from pulpo_tpu_torch.data.synthetic import SyntheticDataset

        input_size = (32, 32, 32) if args.ndims == 3 else (64, 64)
        ds = SyntheticDataset(shape=input_size, n=8, segs=args.segs,
                              lms=args.lms, seed=args.random_seed)
        train_loader = DataLoader(ds, args.batch_size, shuffle=True, seed=args.random_seed)
        val_loader = DataLoader(ds, args.batch_size, shuffle=False,
                                seed=args.random_seed + 1)
    else:
        raise ValueError("Dataset not recognized.")

    # the JAX package routes LungCT's warps to its coarse-offset tier
    # through this pair; the port keeps it (inert) so that config.json
    # reads as the JAX CLI's does
    routing = (("PULPO_WARP_COARSE", "1"),) if args.dataset == "lungct" else ()
    cfg = PULPoConfig(
        routing=routing,
        input_size=tuple(int(s) for s in input_size),
        total_levels=args.total_levels,
        latent_levels=args.latent_levels,
        n0=args.n0,
        cp_depth=args.cp_depth,
        feedback=tuple(args.feedback),
        df_resolution=args.df_resolution,
        beta=args.beta,
        recon_loss=tuple(args.recon_loss),
        gamma=args.gamma,
        lamb=args.lamb,
        dice_factor=args.dice_factor,
        regularizer=args.regularizer,
        similarity_pyramid=args.similarity_pyramid,
        nondiagonal=args.nondiagonal,
        lr=args.learning_rate,
        batch_size=args.batch_size,
        max_epochs=args.max_epochs,
        random_seed=args.random_seed,
        dataset=args.dataset,
        segs=args.segs,
        lms=args.lms,
        mask=args.mask,
        interpatient=args.interpatient,
        compute_dtype=args.compute_dtype,
        image_logging_frequency=args.image_logging_frequency,
        run_dir=args.run_dir,
        data_parallel=args.data_parallel,
    )

    import torch.distributed as dist

    from pulpo_tpu_torch.parallel import multihost
    from pulpo_tpu_torch.train.loop import Trainer

    # a replica a process: the group starts from torchrun's environment
    # (the Trainer refuses a world size other than --data_parallel)
    started = False
    if (args.data_parallel > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1) and \
            not dist.is_initialized():
        started = multihost.initialize(backend=args.dist_backend, device=device)
    try:
        experiment = "-".join([get_git_revision_short_hash(), f"seed={args.random_seed}", ""])
        trainer = Trainer(cfg, run_dir=args.run_dir, experiment=experiment,
                          profile_dir=args.profile_dir, device=device)
        print(f"RUNNING FOR {cfg.max_epochs} EPOCHS. Run dir: {trainer.run_dir}")
        try:
            trainer.fit(train_loader, val_loader, max_steps=args.max_steps)
        finally:
            trainer.close()
    finally:
        if started:
            multihost.shutdown()

    if not args.skip_eval and trainer.rank == 0:
        print("TRAINING FINISHED, STARTING EVALUATION.")
        from pulpo_tpu_torch.eval.evaluator import Evaluate

        ev = Evaluate(device=device)
        ev.load_model(trainer.run_dir)
        ev.run_one_model(segs=args.segs, lms=args.lms, mask=args.mask, N=10,
                         task=args.dataset, data_path=args.data_path, visualize=False)
    return trainer.run_dir


if __name__ == "__main__":
    main()
