"""One rank of the port's two-process data-parallel tests (gloo, CPU).

    python tests/torch_dp_worker.py RANK WORLD INIT_URL INPUT OUT_DIR

INPUT (torch.save) holds the config keywords, the initial state_dict,
a global batch and its per-row draws. The rank joins the process group
at INIT_URL (a `file://` rendezvous), then writes OUT_DIR/rank_<r>.pt:

- `grads`, `stats`, `metrics`: `dp_compute_grads` on its rows of the
  batch (BatchNorm over both ranks, gradients and metrics averaged);
- `after`, `step_metrics`: the model after one `make_dp_train_step`
  step from the same state;
- `trainer`: `Trainer.fit` at data_parallel = WORLD on synthetic pairs
  (2 steps, validation after each), then a second Trainer that resumes
  the first one's `latest` for one more step: the final payloads and
  whether this rank's Trainer writes;
- `cli`: the run directory of `train_cli --data_parallel WORLD` (2
  steps, --skip_eval);
- `mismatch`: the error a Trainer raises at data_parallel = WORLD + 1.

Imports torch and the port only (no JAX).
"""

from __future__ import annotations

import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pulpo_tpu_torch import PULPoConfig, train_cli  # noqa: E402
from pulpo_tpu_torch.data.loader import DataLoader  # noqa: E402
from pulpo_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from pulpo_tpu_torch.models import PULPoModel  # noqa: E402
from pulpo_tpu_torch.parallel import multihost  # noqa: E402
from pulpo_tpu_torch.parallel.dp import make_dp_train_step, replicate_state  # noqa: E402
from pulpo_tpu_torch.parallel.mesh import make_mesh, shard_batch_spec  # noqa: E402
from pulpo_tpu_torch.train import create_train_state  # noqa: E402
from pulpo_tpu_torch.train.checkpoint import state_payload  # noqa: E402
from pulpo_tpu_torch.train.loop import Trainer  # noqa: E402
from pulpo_tpu_torch.train.step import dp_compute_grads  # noqa: E402


def floats(metrics: dict) -> dict:
    return {k: ({l: float(x) for l, x in v.items()} if isinstance(v, dict) else float(v))
            for k, v in metrics.items()}


def run(rank: int, world: int, url: str, inp_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    out_dir = pathlib.Path(out_dir)
    inp = torch.load(inp_path, weights_only=False)
    multihost.initialize(url, world, rank, device="cpu")
    mesh = make_mesh(world)
    cfg = PULPoConfig(**inp["cfg"])
    rows = shard_batch_spec(mesh, len(inp["batch"]["x"]))
    batch = {k: v[rows] for k, v in inp["batch"].items()}
    noise = {l: v[rows] for l, v in inp["noise"].items()}
    out = {}

    # the step; each rank starts from other weights, so that the
    # broadcast of rank 0's state is what makes them equal
    model = PULPoModel(cfg, device="cpu")
    state, tx = create_train_state(model, seed=rank + 1)
    if rank == 0:
        model.load_state_dict(inp["state_dict"])
    replicate_state(state, mesh)
    grads, stats, metrics = dp_compute_grads(model, batch, mesh, noise=noise)
    out.update(grads=grads, stats=stats, metrics=floats(metrics))
    state, step_metrics = make_dp_train_step(model, tx, mesh)(state, batch, noise=noise)
    out.update(after=model.state_dict(), step_metrics=floats(step_metrics))

    # the Trainer, then a resume of its `latest`
    tcfg = PULPoConfig(**{**inp["cfg"], "data_parallel": world, "batch_size": 2,
                          "max_epochs": 2, "val_check_interval": 0.5})
    ds = SyntheticDataset(shape=tcfg.input_size, n=4, seed=0)
    loaders = lambda: (DataLoader(ds, 2, shuffle=True, seed=0), DataLoader(ds, 2, seed=1))
    runs = out_dir / "runs"
    first = Trainer(tcfg, run_dir=runs, experiment="dp", device="cpu")
    fitted = first.fit(*loaders(), max_steps=2)
    first.close()
    second = Trainer(tcfg, run_dir=runs, experiment="dp", device="cpu")
    if rank == 0:
        (second.run_dir / "checkpoints").mkdir()
        shutil.copy(first.run_dir / "checkpoints" / "latest.pt",
                    second.run_dir / "checkpoints" / "latest.pt")
    dist.barrier()
    resumed = second.fit(*loaders(), max_steps=3, resume=True)
    second.close()
    out["trainer"] = {"run_dirs": [str(first.run_dir), str(second.run_dir)],
                      "fitted": state_payload(fitted), "resumed": state_payload(resumed),
                      "steps": [len(first.times["step"]), len(second.times["step"])],
                      "writes": [type(t.writer).__name__ for t in (first, second)]}

    # the CLI on the running group
    run_dir = train_cli.main([
        "--dataset", "synthetic", "--accelerator", "cpu", "--data_parallel", str(world),
        "--batch_size", "2", "--max_steps", "2", "--n0", "2", "--total_levels", "3",
        "--latent_levels", "2", "--run_dir", str(out_dir / "cli"), "--skip_eval"])
    out["cli"] = str(run_dir)

    try:
        Trainer(PULPoConfig(**{**inp["cfg"], "data_parallel": world + 1}),
                run_dir=out_dir / "refused", device="cpu")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)

    torch.save(out, out_dir / f"rank_{rank}.pt")
    multihost.shutdown()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
