"""The plain reference against the port's CPU path, at a tiny size, with
the same weights, pairs and seeds: a UQ request and three training
steps, in float32 (the reference's arithmetic) and in bfloat16."""

import ast
from pathlib import Path

import pytest
import torch

from conftest import TINY
from portbench import compare, harness, pool
from portbench.reference import pulpo_ref as R

REF_DIR = Path(R.__file__).parent


def model(cfg: str, **kw) -> dict:
    return dict(harness.cell(cfg).model, **TINY, **kw)


def port_model(m, weights):
    from pulpo_tpu_torch.models import PULPoModel

    from portbench.kinds.uq import port_config

    net = PULPoModel(port_config(m), device="cpu")
    net.load_state_dict(weights)
    return net


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4), ("bfloat16", 0.03)])
def test_uq_request_matches_the_port(dtype, tol):
    from pulpo_tpu_torch.uq.predict import predict_with_uncertainty

    m = model("oasis-uq32", compute_dtype=dtype)
    w = pool.make_weights(m, 11, "cpu")
    x, y = pool.make_pairs(tuple(m["input_size"]), 1, 12, "cpu")[0]
    res = predict_with_uncertainty(port_model(m, w), x, y, 8, seed=13, chunk=4)
    ref = R.uq_request(m, w, x, y, 8, 13, first=4)
    assert set(ref) == {"mean_outputs", "avg_dfs", "final_dfs", "outputs", "output_std",
                        "individual_df_std", "final_df_std", "output_mse", "output_entropy"}
    for leaf, levels in ref.items():
        for l, r in levels.items():
            assert compare.rel_gap(getattr(res, leaf)[l], r) < tol, (leaf, l)


@pytest.mark.parametrize("dtype, tol", [("float32", (1e-4, 5e-3, 0.02)),
                                        ("bfloat16", (0.02, 0.3, 0.2))])
def test_training_steps_match_the_port(dtype, tol):
    from pulpo_tpu_torch.train.step import Adam, TrainState, make_train_step

    m = model("oasis-train", compute_dtype=dtype)
    w = pool.make_weights(m, 21, "cpu")
    pairs = pool.make_pairs(tuple(m["input_size"]), 3, 22, "cpu")
    net = port_model(m, w)
    tx = Adam(float(m["lr"]))
    state = TrainState(step=0, model=net, opt_state=tx.init(dict(net.module.named_parameters())),
                       rng=torch.Generator().manual_seed(23))
    step = make_train_step(net, tx)
    losses = []
    for i, (x, y) in enumerate(pairs):
        state, met = step(state, {"x": x, "y": y})
        losses.append(float(met["total_loss"]))
        if i == 0:
            g1 = {n: v / (1 - tx.b1) for n, v in state.opt_state.mu.items()}
    ref_losses, ref_grads, ref_after = R.train_steps(m, w, pairs, R.step_seeds(23, 3))
    for p, r in zip(losses, ref_losses):
        assert abs(p - r[0]) / (abs(r[1]) + abs(r[2]) + abs(r[3])) < tol[0]
    moving = compare.moving_leaves(ref_grads)
    assert len(moving) < len(ref_grads)  # the conv biases in front of a train BatchNorm
    assert max(compare.leaf_gaps(g1, ref_grads, moving).values()) < tol[1]
    after = net.state_dict()
    delta = lambda s: {n: s[n] - w[n] for n in moving}
    assert max(compare.leaf_gaps(delta(after), delta(ref_after), moving).values()) < tol[2]


def test_the_draws_are_the_reference_rule():
    a = R.draw(5, [0, 3], 1, 2, (4, 5, 6), 3, "cpu")
    assert a.shape == (4, 3, 4, 5, 6)
    g = torch.Generator().manual_seed(R.sample_seed(5, 3, 1))
    assert torch.equal(a[2:], torch.randn((2, 4, 5, 6, 3), generator=g).movedim(-1, 1))


def imported_roots(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in REF_DIR.glob("*.py"):
        assert not imported_roots(path) & {"pulpo_tpu_torch", "pulpo_tpu", "jax", "jaxlib",
                                           "flax"}, path
