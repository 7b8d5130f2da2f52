"""The port's depth-sharded full_res paths and remat steps
(pulpo_tpu_torch/parallel/spatial.py) on the CPU.

A file of its own beside tests/test_torch_spatial.py, so that xdist's
`--dist loadfile` runs the two side by side. The ranks are four
processes over gloo (tests/torch_spatial_worker.py, mode
`remat_fullres`, which imports no JAX), launched once; their weights are
the port's initial ones, carried into flax and back (`from_jax_variables`).

The slab plain versions first: the channels-first squaring step (#3)
and image warp (#8) at every offset of a field split 2 and 4 ways, bit
for bit against the channels-last slab on a view of the same values and
against the matching planes of the whole CF launch, and against the JAX
package's Pallas CF step (interpret mode) and CF image warp on the whole
field's planes, within 1e-5 relative (tests/test_torch_cf.py's bound:
the stencil and the cascade sum their taps in another order).

Then at mesh (1, 4) the full_res forward (16 x 14 x 16, 3 levels, n0 2:
the full-res depth 16 and the latent depth 8 split, depth 4 replicated)
on the channels-first decode (the feedback without "transformed"), held
to the JAX `make_spatial_forward` at full_res on 4 virtual devices
within 1e-5 of each output's scale and to the port's unsharded forward
within 2e-6 of scale, deterministic and sampled (tests/test_torch_
spatial.py's bounds and reasons); and the full_res forward with the
default feedback (each level warps its image in the decode, channels-
last), held to the port's unsharded forward alone.

At mesh (2, 2), with tests/test_torch_spatial.py's step tolerances:
- the full_res step (channels-last in training: the L x B stacked dfs of
  the batched warp a #4 slab launch with L df rows a moving row) against
  the float64 JAX sharded full_res step (losses rtol 1e-4, gradients 1e-3
  of each leaf's scale, running statistics atol 1e-5) and against the
  port's unsharded step (losses, level metrics and running statistics
  rtol 1e-5 / 1e-5 of scale), its gradients by the rule
  tests/test_torch_spatial.py holds the Dice and jdet steps to: within
  2e-5 of each leaf's scale of the float64 gradient plus the unsharded
  step's own float32 error there (the larger of its distance from
  float64 and its spread under a one-ulp move of x and y; on a leaf whose
  float64 gradient is zero to rounding, its distance plus twice its
  spread). Held to the unsharded step itself (2e-5 of scale plus its
  distance from float64), one of 80 leaves misses: the bias of
  down_blocks.0's third conv, which feeds a train BatchNorm (float64
  gradient 2.8e-15 of the largest leaf's: rounding noise), 5.59e-5 of
  scale from the unsharded step against 3.12e-5 allowed; there the
  unsharded step is 1.12e-5 from float64 and moves 3.85e-5 under a
  one-ulp input move, the sharded step 4.47e-5 from float64. The sharded
  step is the closer to float64 on 42 of the 80 leaves.
- the `remat=True` and `remat_down=(0,)` steps bit-equal to the sharded
  plain step (the recomputation replays the forward's operations and
  exchanges, models/pulpo.py's module doc), as tests/test_torch_remat.py
  holds the unsharded remat step; the remat step also against the float64
  JAX sharded remat step; and the 4-level Dice step under `remat=True`
  bit-equal to the sharded Dice step of tests/test_torch_spatial.py's
  configuration;
- the ranks' gradients, statistics and metrics bit-equal; a remat step's
  recomputed exchanges counted apart in `traffic`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.kernels.warp_halo import warp_cascaded_cf_image
from pulpo_tpu.kernels.warp_local import (
    _round_up,
    _squaring_step_cf_pallas,
    cf_interior,
    cf_pad,
    local_bound,
)
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.parallel.spatial import make_2d_mesh as jax_make_2d_mesh
from pulpo_tpu.parallel.spatial import make_spatial_forward as jax_make_spatial_forward
from pulpo_tpu.parallel.spatial import replicated as jax_replicated
from pulpo_tpu.parallel.spatial import volume_batch_spec as jax_volume_batch_spec
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.kernels import squaring, warp
from pulpo_tpu_torch.models import PULPoModel
from test_torch_spatial import (
    SEG_STEPS,
    STEP,
    WORLD,
    _close,
    _held_to_jax,
    _held_to_port,
    _jax_sharded_step,
    _onehot,
    _run_workers,
    jax_variables,
)
from test_torch_threads import one_torch_thread  # noqa: F401

SIZE = (16, 14, 16)
# the channels-first decode: full_res, no "transformed" feedback
CF_FEEDBACK = ("samples", "velocity_fields", "individual_dfs", "combined_dfs", "final_dfs")
FULLRES = dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2,
               df_resolution="full_res", feedback=CF_FEEDBACK)
FORWARD = {"cf": FULLRES, "transformed": dict(FULLRES, feedback=PULPoConfig().feedback)}
FULLRES_STEP = dict(FULLRES, batch_size=2)
REMAT = {"remat": dict(STEP, remat=True), "remat_down_0": dict(STEP, remat_down=(0,))}
DICE_REMAT = dict(SEG_STEPS["dice"], remat=True)
# the slab plain versions' field (tests/test_torch_cf.py's SHAPE) and splits
SLAB_SHAPE = (16, 24, 28)
SLABS = [(space, r) for space in (2, 4) for r in range(space)]


def _cf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return v * (mag / np.abs(v).max())


# ----------------------------------------------------------------------
# the slab plain versions of #3 and #8
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cf_wholes():
    """A sub-voxel field with the Pallas CF step's planes, and an image
    with 2 x 2 CF dfs and the JAX CF image warp's planes."""
    v = _field((2, *SLAB_SHAPE, 3), 0.8 * local_bound(SLAB_SHAPE), 0)
    step = cf_interior(_squaring_step_cf_pallas(cf_pad(jnp.asarray(v)), SLAB_SHAPE,
                                                interpret=True), SLAB_SHAPE)
    rng = np.random.default_rng(19)
    img = rng.random((2, *SLAB_SHAPE, 1), dtype=np.float32)
    df = _field((4, *SLAB_SHAPE, 3), 2.8, 23)
    s0, s1, s2 = SLAB_SHAPE
    dcf = np.pad(np.moveaxis(df, -1, 1), ((0, 0), (0, 0), (0, 0), (0, _round_up(s1, 8) - s1),
                                          (0, _round_up(s2, 128) - s2)))
    warped = warp_cascaded_cf_image(jnp.asarray(img), jnp.asarray(dcf), SLAB_SHAPE, doff=0,
                                    interpret=True)
    return dict(v=v, step=np.asarray(step), img=img, df=df,
                warped=np.moveaxis(np.asarray(warped), -1, 1))


@pytest.mark.parametrize("space,r", SLABS, ids=[f"{s}way-slab{r}" for s, r in SLABS])
def test_cf_squaring_slab_plain_version(cf_wholes, space, r):
    """`squaring_step_cf_plain` of planes z0.. of the whole CF field: the
    channels-last slab on a view bit for bit, the whole CF step's planes
    bit for bit, the Pallas CF step's planes within 1e-5; with and
    without the first step's scale."""
    per = SLAB_SHAPE[0] // space
    z0 = r * per
    v = _cf(cf_wholes["v"])
    for scale in (1.0, 1.0 / 2**7):
        got = squaring.squaring_step_cf(v, scale=scale, z0=z0, depth=per)
        assert got.shape == (2, 3, per, *SLAB_SHAPE[1:])
        cl = squaring.squaring_step_plain(v.permute(0, 2, 3, 4, 1) * scale, z0, per)
        assert torch.equal(got, cl.permute(0, 4, 1, 2, 3))
        whole = squaring.squaring_step_cf(v, scale=scale)
        assert torch.equal(got, whole[:, :, z0:z0 + per])
    got = squaring.squaring_step_cf_plain(v, z0, per)
    np.testing.assert_allclose(got.numpy(), cf_wholes["step"][:, :, z0:z0 + per],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("space,r", SLABS, ids=[f"{s}way-slab{r}" for s, r in SLABS])
def test_cf_warp_slab_plain_version(cf_wholes, space, r):
    """`warp_cf_plain` of a df slab from z0 (2 df rows a moving row): the
    channels-last slab on a view bit for bit, the whole CF warp's planes
    bit for bit, the JAX CF image warp's planes within 1e-5."""
    per = SLAB_SHAPE[0] // space
    z0, zg = r * per, SLAB_SHAPE[0]
    moving, df = _cf(cf_wholes["img"]), _cf(cf_wholes["df"])
    d = df[:, :, z0:z0 + per].contiguous()
    got = warp.warp_cf(moving, d, z0, zg)
    assert got.shape == (4, 1, per, *SLAB_SHAPE[1:])
    cl = warp.warp_plain(moving.permute(0, 2, 3, 4, 1), d.permute(0, 2, 3, 4, 1), z0, zg)
    assert torch.equal(got, cl.permute(0, 4, 1, 2, 3))
    assert torch.equal(got, warp.warp_cf(moving, df)[:, :, z0:z0 + per])
    np.testing.assert_allclose(got.numpy(), cf_wholes["warped"][:, :, z0:z0 + per],
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the JAX references and the ranks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """Flax variables of each configuration's initial weights."""
    return {"forward": {case: jax_variables(kw, 0) for case, kw in FORWARD.items()},
            "fullres_step": jax_variables(FULLRES_STEP, 1), "step": jax_variables(STEP, 0)}


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(30)
    forward = {k: rng.random((1, *SIZE, 1), dtype=np.float32) for k in "xy"}
    step = {k: rng.random((2, *SIZE, 1), dtype=np.float32) for k in "xy"}
    return forward, step


@pytest.fixture(scope="module")
def jax_fullres_forward(weights, pairs):
    """The JAX sharded full_res forward's level-0 final df and warped
    image at mesh (1, 4)."""
    if jax.device_count() < WORLD:
        pytest.skip("needs 4 JAX devices")
    mesh = jax_make_2d_mesh(1, 4)
    x, y = pairs[0]["x"], pairs[0]["y"]
    df, warped = jax_make_spatial_forward(JaxModel(JaxConfig(**FULLRES)), mesh)(
        jax.device_put(weights["forward"]["cf"], jax_replicated(mesh)),
        jax.device_put(x, jax_volume_batch_spec(mesh)),
        jax.device_put(y, jax_volume_batch_spec(mesh)), jax.random.key(1))
    return np.asarray(df), np.asarray(warped)


@pytest.fixture(scope="module")
def jax_steps(weights, pairs):
    """The float64 JAX sharded full_res step and remat step at (2, 2)
    (`_jax_sharded_step`: SGD(0.1), gradients from the update)."""
    return {"fullres": _jax_sharded_step(FULLRES_STEP, weights["fullres_step"], pairs[1]),
            "remat": _jax_sharded_step(REMAT["remat"], weights["step"], pairs[1])}


def _dice_case():
    """The Dice configuration's weights, batch and draws (no JAX)."""
    model = PULPoModel(PULPoConfig(**SEG_STEPS["dice"]), device="cpu")
    model.init(2)
    size = SEG_STEPS["dice"]["input_size"]
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.random((2, *size, 1), dtype=np.float32)) for k in "xy"}
    batch.update(seg_x=torch.from_numpy(_onehot(5)), seg_y=torch.from_numpy(_onehot(6)))
    cfg = PULPoConfig(**SEG_STEPS["dice"])
    noise = {l: torch.from_numpy(rng.standard_normal((2, *cfg.level_sizes[l], cfg.zdim),
                                                     dtype=np.float32))
             for l in range(cfg.latent_levels)}
    return model.state_dict(), batch, noise


@pytest.fixture(scope="module")
def ranks(weights, pairs, jax_steps, tmp_path_factory):
    """The four ranks' forwards and steps."""
    tmp = tmp_path_factory.mktemp("remat_fullres")
    inp = tmp / "input.pt"
    tensors = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    forward = [{"cfg": kw, "state_dict": from_jax_variables(weights["forward"][case],
                                                            PULPoConfig(**kw)),
                **tensors(pairs[0]), "seed": 3} for case, kw in FORWARD.items()]
    ref = jax_steps["remat"]
    step_sd = from_jax_variables(ref["before"], PULPoConfig(**STEP))
    plain = {"batch": tensors(ref["batch"]), "noise": tensors(ref["noise"]),
             "state_dict": step_sd}
    full = jax_steps["fullres"]
    dice_sd, dice_batch, dice_noise = _dice_case()
    dice = {"batch": dice_batch, "noise": dice_noise, "state_dict": dice_sd}
    steps = [dict(plain, name="plain", cfg=STEP),
             *(dict(plain, name=n, cfg=kw) for n, kw in REMAT.items()),
             {"name": "fullres", "cfg": FULLRES_STEP, "batch": tensors(full["batch"]),
              "noise": tensors(full["noise"]),
              "state_dict": from_jax_variables(full["before"], PULPoConfig(**FULLRES_STEP))},
             dict(dice, name="dice", cfg=SEG_STEPS["dice"]),
             dict(dice, name="dice_remat", cfg=DICE_REMAT)]
    torch.save({"forward": forward, "steps": steps}, inp)
    return _run_workers(tmp, inp, "remat_fullres", WORLD)


def _joined(ranks, case, key):
    """The four slabs of forward `case` joined along depth."""
    i = list(FORWARD).index(case)
    return [torch.cat([r["forward"][i][key][k] for r in ranks], dim=1) for k in (0, 1)]


# ----------------------------------------------------------------------
# the full_res forward at mesh (1, 4) and step at (2, 2)
# ----------------------------------------------------------------------

def test_sharded_fullres_forward_matches_the_jax_sharded_forward(jax_fullres_forward, ranks):
    df, warped = _joined(ranks, "cf", "det")
    assert df.shape == (1, *SIZE, 3) and warped.shape == (1, *SIZE, 1)
    _close(df, jax_fullres_forward[0], 1e-5, "df")
    _close(warped, jax_fullres_forward[1], 1e-5, "warped")


@pytest.mark.parametrize("case", list(FORWARD))
def test_sharded_fullres_forward_matches_the_unsharded_port(weights, pairs, ranks, case):
    """Deterministic, and sampled from the same seed."""
    cfg = PULPoConfig(**FORWARD[case])
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(weights["forward"][case], cfg))
    x, y = pairs[0]["x"], pairs[0]["y"]
    for key, outs in (("det", model.apply_eval(x, y, deterministic=True)),
                      ("sampled", model.apply_eval(x, y, seed=3))):
        df, warped = _joined(ranks, case, key)
        _close(df, outs[6][0], 2e-6, (key, "df"))
        _close(warped, outs[7][0], 2e-6, (key, "warped"))


def test_sharded_fullres_step_matches_the_jax_sharded_step(jax_steps, ranks):
    _held_to_jax(ranks[0]["steps"]["fullres"], jax_steps["fullres"],
                 PULPoConfig(**FULLRES_STEP))


def test_sharded_fullres_step_matches_the_unsharded_port_step(jax_steps, ranks):
    got = ranks[0]["steps"]["fullres"]
    _held_to_port(got, jax_steps["fullres"], PULPoConfig(**FULLRES_STEP), to_exact=True)
    assert float(got["metrics"]["nan_flag"]) == 0.0
    assert set(got["traffic"]) == {"halo", "gather", "reduce"}


# ----------------------------------------------------------------------
# remat at (2, 2)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,plain", [("remat", "plain"), ("remat_down_0", "plain"),
                                        ("dice_remat", "dice")])
def test_sharded_remat_step_is_bit_equal_to_the_sharded_plain_step(ranks, name, plain):
    got, ref = ranks[0]["steps"][name], ranks[0]["steps"][plain]
    for key in ("grads", "stats"):
        assert set(got[key]) == set(ref[key])
        for n, v in ref[key].items():
            assert torch.equal(got[key][n], v), (key, n)
    for k, v in ref["metrics"].items():
        pairs = v.items() if isinstance(v, dict) else [(None, v)]
        for l, t in pairs:
            assert torch.equal(got["metrics"][k] if l is None else got["metrics"][k][l], t), k


def test_sharded_remat_step_matches_the_jax_sharded_remat_step(jax_steps, ranks):
    _held_to_jax(ranks[0]["steps"]["remat"], jax_steps["remat"], PULPoConfig(**REMAT["remat"]))


@pytest.mark.parametrize("name", ["remat", "remat_down_0", "dice_remat"])
def test_recomputed_exchanges_are_counted_apart(ranks, name):
    """A remat step's first-pass exchanges are the plain step's; the
    recomputation's are counted under "<kind>_recomputed"."""
    got = ranks[0]["steps"][name]["traffic"]
    plain = ranks[0]["steps"]["dice" if name == "dice_remat" else "plain"]["traffic"]
    first = {k: v for k, v in got.items() if not k.endswith("_recomputed")}
    assert first == plain
    assert got["halo_recomputed"][0] > 0
    assert set(got) - set(first) <= {f"{k}_recomputed" for k in plain}


@pytest.mark.parametrize("name", ["plain", "remat", "remat_down_0", "fullres", "dice",
                                  "dice_remat"])
def test_the_ranks_agree_bit_for_bit(ranks, name):
    a = ranks[0]["steps"][name]
    for r in ranks[1:]:
        b = r["steps"][name]
        for key in ("grads", "stats"):
            for n, v in a[key].items():
                assert torch.equal(v, b[key][n]), (key, n)
        for k, v in a["metrics"].items():
            pairs = v.items() if isinstance(v, dict) else [(None, v)]
            for l, t in pairs:
                assert torch.equal(t, b["metrics"][k] if l is None else b["metrics"][k][l]), k
