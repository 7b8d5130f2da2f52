"""The port's model against the JAX package's, on the CPU.

Weights come from a JAX init (with non-trivial BatchNorm statistics)
and cross with `pulpo_tpu_torch.compat.from_jax_variables`; every one
of the 8 per-level output dicts of a deterministic eval forward must
equal `PULPoModule.apply(..., deterministic=True, train=False)` at
atol 1e-4 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.compat.torch_import import import_torch_state_dict
from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.models import PULPoModel
from test_torch_threads import one_torch_thread  # noqa: F401

NAMES = ("mus", "sigmas", "samples", "velocity_fields", "individual_dfs",
         "combined_dfs", "final_dfs", "transformed")


def jax_model_and_variables(seed=0, **kw):
    """A JAX model and its variables, BatchNorm statistics randomised so
    that the eval BatchNorm is not the identity."""
    jm = JaxModel(JaxConfig(**kw))
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    stats = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.2).astype(np.float32), v["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: np.abs(a) + 0.5 if path[-1].key == "var" else a, stats)
    return jm, {"params": v["params"], "batch_stats": stats}


def port_model(variables, **kw):
    cfg = PULPoConfig(**kw)
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    return model


@pytest.mark.parametrize("df_resolution", ["level_res", "full_res"])
@pytest.mark.parametrize("size", [(16, 20, 24), (15, 18, 21)])
def test_deterministic_forward_matches_jax(size, df_resolution):
    kw = dict(input_size=size, total_levels=3, latent_levels=2, n0=4,
              df_resolution=df_resolution)
    jm, variables = jax_model_and_variables(**kw)
    model = port_model(variables, **kw)
    rng = np.random.default_rng(1)
    x = rng.random((2, *size, 1), dtype=np.float32)
    y = rng.random((2, *size, 1), dtype=np.float32)
    ref = jm.apply_eval(variables, jnp.asarray(x), jnp.asarray(y), deterministic=True)
    got = model.apply_eval(x, y, deterministic=True)
    for name, dr, dg in zip(NAMES, ref, got):
        assert sorted(dr) == sorted(dg), name
        for l in dr:
            np.testing.assert_allclose(dg[l].numpy(), np.asarray(dr[l]), rtol=0, atol=1e-4,
                                       err_msg=f"{name}[{l}]")


def test_fullres_batched_level_warp_matches_jax():
    """full_res without `transformed` feedback: the levels' image warps
    run as one batched warp after the level loop."""
    kw = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4,
              df_resolution="full_res",
              feedback=("samples", "velocity_fields", "final_dfs"))
    jm, variables = jax_model_and_variables(seed=3, **kw)
    model = port_model(variables, **kw)
    rng = np.random.default_rng(4)
    x = rng.random((1, 16, 20, 24, 1), dtype=np.float32)
    y = rng.random((1, 16, 20, 24, 1), dtype=np.float32)
    ref = jm.apply_eval(variables, jnp.asarray(x), jnp.asarray(y), deterministic=True)
    got = model.apply_eval(x, y, deterministic=True)
    for name, dr, dg in zip(NAMES, ref, got):
        for l in dr:
            np.testing.assert_allclose(dg[l].numpy(), np.asarray(dr[l]), rtol=0, atol=1e-4,
                                       err_msg=f"{name}[{l}]")


def test_state_dict_round_trips_through_the_reference_importer():
    kw = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4)
    _, variables = jax_model_and_variables(seed=5, **kw)
    model = port_model(variables, **kw)
    back = import_torch_state_dict(model.state_dict(), JaxConfig(**kw))
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_init_is_seeded_and_torch_scaled():
    cfg = PULPoConfig(input_size=(8, 8, 8), total_levels=2, latent_levels=2, n0=4)
    a, b = PULPoModel(cfg, device="cpu"), PULPoModel(cfg, device="cpu")
    sa, sb = a.init(7), b.init(7)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["downpath.down_blocks.0._op.0._op.0.weight"]  # fan_in = 2 * 27
    assert float(w.abs().max()) <= 1 / np.sqrt(54)
    assert not torch.equal(w, PULPoModel(cfg, device="cpu").init(8)[
        "downpath.down_blocks.0._op.0._op.0.weight"])


def test_bf16_model_runs_and_keeps_integration_in_f32():
    cfg = PULPoConfig(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4,
                      compute_dtype="bfloat16")
    model = PULPoModel(cfg, device="cpu")
    model.init(0)
    x = np.random.default_rng(0).random((1, 16, 20, 24, 1), dtype=np.float32)
    outs = model.apply_eval(x, x, seed=1)
    assert outs[4][0].dtype == torch.bfloat16
    assert outs[6][0].dtype == torch.float32 and outs[7][0].dtype == torch.float32
    assert all(bool(torch.isfinite(v.float()).all()) for d in outs for v in d.values())
