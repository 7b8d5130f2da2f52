"""The port's output-channel split of the eval forward
(pulpo_tpu_torch/parallel/tp.py) on the CPU.

Two ranks over gloo (tests/torch_spatial_worker.py `tp`, no JAX),
launched once, split the JAX test's model (`tests/test_parallel.py:321`:
12 x 14 x 16, n0 4, 3 levels, B = 1) at model 2 and run
`predict_deterministic`. The references are the JAX package's rules and
its forward with the sharded weights on 2 of conftest's 8 virtual
devices (the JAX test holds that to its replicated forward), and the
port's replicated forward. The weights are the port's initial ones
(`tests/test_torch_spatial.py:jax_variables`).

Tolerances:
- the rules: the same tensors, name for name through
  `compat.from_jax_variables`;
- the split forward against the JAX sharded forward: rtol 2e-5, atol
  2e-5 (the JAX test's, for its own sharded forward against the
  replicated one);
- against the port's replicated forward: 1e-6 of scale (the units run
  as the conv-unit kernel's plain version on the CPU, the replicated
  forward as its ConvUnits: the same float32 operations; measured 0);
- the two ranks' outputs: bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.parallel.tp import make_model_mesh as jax_make_model_mesh
from pulpo_tpu.parallel.tp import param_sharding_rules as jax_param_sharding_rules
from pulpo_tpu.parallel.tp import shard_params as jax_shard_params
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.parallel import tp
from pulpo_tpu_torch.parallel.mesh import Mesh
from test_torch_spatial import _run_workers, jax_variables
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(input_size=(12, 14, 16), total_levels=3, latent_levels=2, n0=4, batch_size=1)
WORLD = 2

to_np = lambda t: jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def jax_tp():
    """The weights and pair, the JAX rule as a 0/1 mask of each leaf's
    shape, and the JAX `predict_deterministic` with sharded weights."""
    if jax.device_count() < WORLD:
        pytest.skip("needs 2 JAX devices")
    jm = JaxModel(JaxConfig(**KW))
    variables = jax_variables(KW, 0)
    rng = np.random.default_rng(1)
    x, y = (rng.random((1, *KW["input_size"], 1), dtype=np.float32) for _ in "xy")
    mesh = jax_make_model_mesh(WORLD)
    rules = jax_param_sharding_rules(variables, mesh)
    mask = jax.tree.map(
        lambda a, r: np.full(np.shape(a), float(r.spec != jax.sharding.PartitionSpec()),
                             np.float32),
        variables, rules, is_leaf=lambda r: hasattr(r, "spec"))
    sharded = jm.predict_deterministic(jax_shard_params(variables, mesh), x, y)
    return dict(variables=variables, x=x, y=y, mask=to_np(mask), sharded=to_np(sharded))


@pytest.fixture(scope="module")
def ranks(jax_tp, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inp = tmp / "input.pt"
    cfg = PULPoConfig(**KW)
    torch.save({"cfg": KW, "state_dict": from_jax_variables(jax_tp["variables"], cfg),
                "x": torch.from_numpy(jax_tp["x"]), "y": torch.from_numpy(jax_tp["y"])}, inp)
    return _run_workers(tmp, inp, "tp", WORLD)


def test_the_rule_picks_the_jax_rules_tensors_name_for_name(jax_tp, ranks):
    mask = from_jax_variables(jax_tp["mask"], PULPoConfig(**KW))
    jax_split = {n for n, m in mask.items() if bool(m.any())}
    assert {n for n, m in mask.items() if bool(m.any()) != bool(m.all())} == set()
    rules = ranks[0]["rules"]
    assert set(rules) == set(mask)
    assert {n for n, d in rules.items() if d == 0} == jax_split
    assert all(d in (0, None) for d in rules.values())
    # the 3-channel heads stay whole, every n0-wide conv is split
    assert rules["autoencoder.decoders.0.velocity_field._op.2.weight"] is None
    assert rules["downpath.down_blocks.0._op.0._op.0.weight"] == 0


def test_shard_params_keeps_each_ranks_slice(jax_tp, ranks):
    cfg = PULPoConfig(**KW)
    full = from_jax_variables(jax_tp["variables"], cfg)
    for r in ranks:
        for name, shape in r["shapes"].items():
            n = full[name].shape[0] // WORLD if r["rules"][name] == 0 else full[name].shape[0]
            assert shape == (n, *full[name].shape[1:]), name


def test_split_forward_matches_the_jax_sharded_forward(jax_tp, ranks):
    got = ranks[0]
    for i, key in enumerate(("warped", "dfs")):
        for l, v in got[key].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jax_tp["sharded"][i][l], np.float32),
                                       rtol=2e-5, atol=2e-5, err_msg=f"{key}[{l}]")


def test_split_forward_matches_the_port_replicated_forward(jax_tp, ranks):
    cfg = PULPoConfig(**KW)
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(jax_tp["variables"], cfg))
    warped, dfs = model.predict_deterministic(jax_tp["x"], jax_tp["y"])
    for key, ref in (("warped", warped), ("dfs", dfs)):
        for l, r in ref.items():
            got = ranks[0][key][l]
            assert float((got - r).abs().max()) <= 1e-6 * float(r.abs().max()), (key, l)


def test_the_ranks_agree_and_a_train_forward_raises(ranks):
    a, b = ranks
    for key in ("warped", "dfs"):
        assert all(torch.equal(a[key][l], b[key][l]) for l in a[key])
    assert a["refused"] is not None and "eval forward only" in a["refused"]


def test_the_rule_on_other_meshes_and_tensors():
    """At n = 1 every float tensor of >= 2 output channels is split (in
    one piece), as the JAX rule marks it; an integer tensor and one of
    fewer than 2n channels never."""
    model = PULPoModel(PULPoConfig(**KW), device="cpu")
    rules = tp.param_sharding_rules(model, Mesh(size=1, rank=0))
    assert set(rules.values()) == {0}
    assert tp.param_sharding_rules({"w": torch.zeros(3, 2), "n": torch.zeros(4, dtype=torch.int64)},
                                   Mesh(size=2, rank=0)) == {"w": None, "n": None}
