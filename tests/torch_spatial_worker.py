"""One rank of the port's depth-sharded and output-channel-split tests
(gloo, CPU).

    python tests/torch_spatial_worker.py MODE RANK WORLD INIT_URL INPUT OUT_DIR

MODE `spatial` (world 4): for each case of INPUT["forward"] (config
keywords, state_dict, global x and y, a seed), the deterministic and
the sampled `make_spatial_forward` at mesh (1, 4); then, for
INPUT["step"] (config keywords, state_dict, global batch and draws), at
mesh (2, 2) the gradients, BatchNorm statistics and metrics of
`spatial_compute_grads`, and the state after one
`make_spatial_train_step` step, with the exchanges' traffic; for each
case of INPUT["seg_steps"] (the Dice step and the jdet step: config
keywords, state_dict, global batch with or without segmentations, draws)
the same at mesh (2, 2) without the update; then, at meshes (2, 2) and
(1, 4), `soft_dice_loss` and `jdet_std` under `sharded` on this rank's
block of INPUT["rule"]'s global inputs at a split and at a replicated
level: each rank's term and its gradient to its block.
MODE `remat_fullres` (world 4): the deterministic and the sampled
`make_spatial_forward` at mesh (1, 4) for each case of INPUT["forward"]
(the full_res configurations), then at mesh (2, 2) the gradients,
statistics, metrics and traffic of `spatial_compute_grads` for each case
of INPUT["steps"] (the full_res step, the plain, `remat` and
`remat_down` steps, the Dice step plain and under `remat`).
MODE `spatial2d` (world 4): the same as `remat_fullres` on the 2D
configurations (each image (B, H, W, C) sharded along H), a step case
with "update" also taking one `make_spatial_train_step` step.
MODE `tp` (world 2): the model split by `tp.shard_params` at model 2,
its rules and `predict_deterministic` under `tp.sharded`, and the error
a train forward raises there.
Each rank writes OUT_DIR/rank_<r>.pt. Imports torch and the port only
(no JAX).
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pulpo_tpu_torch import PULPoConfig  # noqa: E402
from pulpo_tpu_torch.models import PULPoModel  # noqa: E402
from pulpo_tpu_torch.parallel import multihost, spatial, tp  # noqa: E402
from pulpo_tpu_torch.train.step import Adam, TrainState  # noqa: E402


def _model(case: dict) -> PULPoModel:
    model = PULPoModel(PULPoConfig(**case["cfg"]), device="cpu")
    model.load_state_dict(case["state_dict"])
    return model


def run_forwards(cases: list) -> list:
    """Each case's deterministic and sampled forward at mesh (1, 4)."""
    out = []
    mesh = spatial.make_2d_mesh(1, 4)
    for case in cases:
        model = _model(case)
        x, y = (spatial.shard_volume(case[k], mesh) for k in "xy")
        det = spatial.make_spatial_forward(model, mesh)(x, y)
        sampled = spatial.make_spatial_forward(model, mesh, deterministic=False)(
            x, y, seed=case["seed"])
        out.append({"det": det, "sampled": sampled})
    return out


def run_steps(cases: list, mesh) -> dict:
    """{name: gradients, statistics, metrics and traffic} of each case's
    `spatial_compute_grads` on `mesh` (no update)."""
    out = {}
    for case in cases:
        model = _model(case)
        batch = {k: spatial.shard_volume(v, mesh) for k, v in case["batch"].items()}
        spatial.reset_traffic()
        grads, stats, metrics = spatial.spatial_compute_grads(model, batch, mesh,
                                                              noise=case["noise"])
        out[case["name"]] = dict(grads=grads, stats=stats, metrics=metrics,
                                 traffic=dict(spatial.traffic))
        if case.get("update"):
            tx = Adam(model.cfg.lr)
            state = TrainState(step=0, model=model,
                               opt_state=tx.init(dict(model.module.named_parameters())),
                               rng=torch.Generator().manual_seed(0))
            _, step_metrics = spatial.make_spatial_train_step(model, tx, mesh)(
                state, batch, noise=case["noise"])
            out[case["name"]].update(after=model.state_dict(), step_metrics=step_metrics)
    return out


def run_remat_fullres(inp: dict) -> dict:
    return {"forward": run_forwards(inp["forward"]),
            "steps": run_steps(inp["steps"], spatial.make_2d_mesh(2, 2))}


def run_spatial(inp: dict) -> dict:
    out = {"forward": run_forwards(inp["forward"])}
    case = inp["step"]
    mesh = spatial.make_2d_mesh(2, 2)
    model = _model(case)
    batch = {k: spatial.shard_volume(v, mesh) for k, v in case["batch"].items()}
    spatial.reset_traffic()
    grads, stats, metrics = spatial.spatial_compute_grads(model, batch, mesh,
                                                          noise=case["noise"])
    out.update(grads=grads, stats=stats, metrics=metrics, traffic=dict(spatial.traffic))
    tx = Adam(model.cfg.lr)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.module.named_parameters())),
                       rng=torch.Generator().manual_seed(0))
    state, step_metrics = spatial.make_spatial_train_step(model, tx, mesh)(
        state, batch, noise=case["noise"])
    out.update(after=model.state_dict(), step_metrics=step_metrics)
    out["seg_steps"] = run_steps(inp["seg_steps"], mesh)
    out["rule"] = run_rule(inp["rule"])
    return out


def run_rule(rule: dict) -> dict:
    """{(mesh, loss, level): (this rank's term, its gradient to the block)}."""
    from pulpo_tpu_torch.ops import losses

    cfg = PULPoConfig(**rule["cfg"])
    fns = {"dice": lambda t, other: losses.soft_dice_loss(t, other, dice_factor=50.0),
           "jdet": lambda t, other: losses.jdet_std(t, lamb=0.025)}
    out = {}
    for shape in rule["meshes"]:
        mesh = spatial.make_2d_mesh(*shape)
        for (name, level), (x, other) in rule["inputs"].items():
            xb = spatial.shard_volume(x, mesh).clone().requires_grad_(True)
            ob = None if other is None else spatial.shard_volume(other, mesh)
            with spatial.sharded(mesh, cfg):
                term = fns[name](xb, ob)
            (grad,) = torch.autograd.grad(term, xb)
            out[(shape, name, level)] = (term.detach(), grad)
    return out


def run_tp(inp: dict) -> dict:
    mesh = tp.make_model_mesh(2)
    model = _model(inp)
    rules = tp.param_sharding_rules(model, mesh)
    tp.shard_params(model, mesh)
    with tp.sharded(mesh):
        warped, dfs = model.predict_deterministic(inp["x"], inp["y"])
        try:
            model.apply_train(inp["x"], inp["y"])
            refused = None
        except NotImplementedError as e:
            refused = str(e)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    return {"rules": rules, "warped": warped, "dfs": dfs, "refused": refused, "shapes": shapes}


def main(mode: str, rank: int, world: int, url: str, inp_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(inp_path, weights_only=False)
    multihost.initialize(url, world, rank, device="cpu")
    out = {"spatial": run_spatial, "remat_fullres": run_remat_fullres,
           "spatial2d": run_remat_fullres, "tp": run_tp}[mode](inp)
    torch.save(out, pathlib.Path(out_dir) / f"rank_{rank}.pt")
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
