"""The port's depth-sharded 2D configuration (pulpo_tpu_torch/parallel/
spatial.py, ndims = 2) on the CPU.

A 2D image (B, H, W, C) is sharded along H, as the JAX package's
`volume_batch_spec`, P("data", "space"), shards axis 1 of any
configuration; a level's tensors are known by their plane, (W,).

The slab plain versions first: the 2D squaring step (#1's 2D arm) and
the 2D warp (C = 1 and C = 36) at every offset of a field split 2 and 4
ways along H, bit for bit against the matching lines of the whole step
and warp (the step with and without the first step's 1/128 scale), and
the whole step's and warp's lines against the JAX package's 2D arm of
`_squaring_step_pallas` (interpret mode) and `ops/warp.py:warp_image`
within 1e-5 of scale (tests/test_torch_2d.py's bound: the stencil sums
9 hat-weighted taps, the gather 4 corners).

Then four processes over gloo (tests/torch_spatial_worker.py, mode
`spatial2d`, which imports no JAX), launched once, on weights carried
into flax and back (`from_jax_variables`):
- at mesh (1, 4) the forward of 16 x 14, 3 levels, n0 2 (depths 16 / 8
  split, 4 replicated: slabs of one line), deterministic and sampled,
  held to the JAX `make_spatial_forward` on 4 of conftest's virtual
  devices within 1e-5 of each output's scale (the JAX test holds its own
  sharded forward to its unsharded one at rtol 1e-4, atol 1e-5) and to
  the port's unsharded forward within 2e-6 of scale (the halo convs and
  band resizes may sum the same float32 terms in another order);
- at mesh (2, 2) on the 4-level network (depth 2 replicated at space 2)
  the default step (NCC, L2 regularizer) at 16 x 14 and, at 16 x 18, the
  Dice step (NCC + Dice, dice_factor 50, one-hot maps of 36 classes) and
  the `jdet` step. 16 x 18 because the Jacobian determinant needs a
  coarsest level of at least 3 columns: at 16 x 14 the coarsest level is
  2 x 2, where the voxel scale (s - 2) / 2 is 0 on both axes, the
  determinant is 1 everywhere and its standard deviation 0, whose square
  root has no derivative (tests/test_torch_spatial.py's SEG_SIZE, for
  the same reason). Each step is held to the float64 JAX sharded step
  (`make_spatial_train_step`, SGD) at losses rtol 1e-4 and gradients
  1e-3 of each leaf's scale (running statistics atol 1e-5), and to the
  port's unsharded step with tests/test_torch_spatial.py's bounds: losses
  and level metrics rtol 1e-5, running statistics 1e-5 of scale, and the
  gradients by that file's rule for its Dice and jdet steps: within 2e-5
  of each leaf's scale of the float64 gradient plus the unsharded step's
  own float32 error there, the larger of its distance from the float64
  gradient and its spread under a one-ulp move of x and y (distance plus
  twice the spread where the float64 gradient is zero to rounding). The
  default step too: held to the unsharded step itself (2e-5 of scale
  plus its distance from float64), one of its 122 leaves misses, the
  weight of down_blocks.0's first BatchNorm, 8.2e-5 of scale from the
  unsharded step against 5.4e-5 allowed; the two sit on either side of
  the float64 gradient there (4.85e-5 and 3.38e-5 of scale from it), as
  the 3D Dice and jdet steps' BatchNorm leaves do (a cotangent summed
  over every pixel of a level through the train BatchNorm's fast
  variance). The sharded step is the closer to float64 on 62 of the 122
  leaves, and its farthest leaf (4.85e-5) is nearer than the unsharded
  step's (5.14e-5). The default step also takes one
  `make_spatial_train_step` update;
- the Dice step under `remat=True` bit-equal to the sharded Dice step,
  its recomputed exchanges counted apart;
- the ranks' gradients, statistics and metrics bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pulpo_tpu.config import PULPoConfig as JaxConfig
from pulpo_tpu.kernels.warp_local import _squaring_step_pallas, local_bound
from pulpo_tpu.models.api import PULPoModel as JaxModel
from pulpo_tpu.ops import warp as jax_warp
from pulpo_tpu.parallel.spatial import make_2d_mesh as jax_make_2d_mesh
from pulpo_tpu.parallel.spatial import make_spatial_forward as jax_make_spatial_forward
from pulpo_tpu.parallel.spatial import replicated as jax_replicated
from pulpo_tpu.parallel.spatial import volume_batch_spec as jax_volume_batch_spec
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.compat import from_jax_variables
from pulpo_tpu_torch.kernels import squaring, warp
from pulpo_tpu_torch.models import PULPoModel
from pulpo_tpu_torch.parallel import spatial
from test_torch_spatial import (
    SEG_CLASSES,
    WORLD,
    _close,
    _held_to_jax,
    _held_to_port,
    _jax_sharded_step,
    _run_workers,
    jax_variables,
)
from test_torch_threads import one_torch_thread  # noqa: F401

SIZE = (16, 14)
FORWARD = dict(input_size=SIZE, total_levels=3, latent_levels=2, n0=2)
STEP = dict(input_size=SIZE, total_levels=4, latent_levels=3, n0=2, batch_size=2)
SEG_SIZE = (16, 18)
SEG = dict(STEP, input_size=SEG_SIZE)
STEPS = {"plain": STEP, "dice": dict(SEG, segs=True, recon_loss=("ncc", "dice"), dice_factor=50),
         "jdet": dict(SEG, regularizer="jdet")}
DICE_REMAT = dict(STEPS["dice"], remat=True)
# the slab plain versions' fields: the forward's split levels, split 2 and 4 ways
SLAB_SIZES = [(16, 14), (8, 7)]
SLABS = [(size, space, r) for size in SLAB_SIZES for space in (2, 4) for r in range(space)
         if spatial.splits(size[0], space)]


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return v * (mag / np.abs(v).max())


def _onehot(size, seed: int) -> np.ndarray:
    labels = np.random.default_rng(seed).integers(0, SEG_CLASSES, (2, *size))
    return np.eye(SEG_CLASSES, dtype=np.float32)[labels]


# ----------------------------------------------------------------------
# the slab plain versions of #1's 2D arm and the 2D warp
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def wholes():
    """Per slab size: a sub-voxel field and the Pallas 2D step on it; an
    image, a 36-channel map, 2 x 2 dfs and the JAX warp of each."""
    out = {}
    for i, size in enumerate(SLAB_SIZES):
        v = _field((2, *size, 2), 0.8 * local_bound(size), i)
        rng = np.random.default_rng(40 + i)
        img = rng.random((2, *size, 1), dtype=np.float32)
        seg = rng.random((2, *size, SEG_CLASSES), dtype=np.float32)
        df = _field((4, *size, 2), 2.8, 50 + i)
        out[size] = dict(v=v, step=np.asarray(_squaring_step_pallas(jnp.asarray(v),
                                                                   interpret=True)),
                         img=img, seg=seg, df=df,
                         warped={c: np.asarray(jax_warp.warp_image(jnp.asarray(m),
                                                                   jnp.asarray(df)))
                                 for c, m in ((1, img), (SEG_CLASSES, seg))})
    return out


@pytest.mark.parametrize("size,space,r", SLABS,
                         ids=[f"{s[0]}x{s[1]}-{n}way-slab{r}" for s, n, r in SLABS])
def test_2d_squaring_slab_plain_version(wholes, size, space, r):
    """`squaring_step` of lines z0.. of the whole 2D field (on the CPU:
    its plain version): the whole step's lines bit for bit, with and
    without the first step's scale; the Pallas 2D arm's lines within
    1e-5 of scale."""
    per = size[0] // space
    z0 = r * per
    v = torch.from_numpy(wholes[size]["v"])
    for scale in (1.0, 1.0 / 2**7):
        got = squaring.squaring_step(v, scale=scale, z0=z0, depth=per)
        assert got.shape == (2, per, size[1], 2)
        assert torch.equal(got, squaring.squaring_step(v, scale=scale)[:, z0:z0 + per])
        assert torch.equal(got, squaring.squaring_step_plain(v * scale, z0, per))
    ref = wholes[size]["step"][:, z0:z0 + per]
    _close(squaring.squaring_step_plain(v, z0, per), ref, 1e-5, "step")


@pytest.mark.parametrize("c", [1, SEG_CLASSES])
@pytest.mark.parametrize("size,space,r", SLABS,
                         ids=[f"{s[0]}x{s[1]}-{n}way-slab{r}" for s, n, r in SLABS])
def test_2d_warp_slab_plain_version(wholes, size, space, r, c):
    """`warp` of a 2D df slab from line z0 (2 df rows a moving row) at
    C = 1 and C = 36: the whole warp's lines bit for bit, the JAX warp's
    lines within 1e-5 of scale; its gradients the plain slab's."""
    per = size[0] // space
    z0, zg = r * per, size[0]
    case = wholes[size]
    moving = torch.from_numpy(case["img"] if c == 1 else case["seg"])
    df = torch.from_numpy(case["df"])
    d = df[:, z0:z0 + per].contiguous().requires_grad_(True)
    got = warp.warp(moving, d, z0, zg)
    assert got.shape == (4, per, size[1], c)
    assert torch.equal(got, warp.warp_plain(moving, df)[:, z0:z0 + per])
    _close(got.detach(), case["warped"][c][:, z0:z0 + per], 1e-5, "warp")
    g = torch.from_numpy(np.random.default_rng(r).standard_normal(got.shape, np.float32))
    (gd,) = torch.autograd.grad(got, d, g)
    whole = df.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(warp.warp_plain(moving, whole)[:, z0:z0 + per], whole, g)
    assert torch.equal(gd, ref[:, z0:z0 + per])


# ----------------------------------------------------------------------
# the JAX references and the ranks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    return {"forward": jax_variables(FORWARD, 0), "plain": jax_variables(STEP, 1),
            "seg": jax_variables(SEG, 2)}


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(60)
    forward = {k: rng.random((1, *SIZE, 1), dtype=np.float32) for k in "xy"}
    plain = {k: rng.random((2, *SIZE, 1), dtype=np.float32) for k in "xy"}
    seg = {k: rng.random((2, *SEG_SIZE, 1), dtype=np.float32) for k in "xy"}
    return forward, plain, seg


@pytest.fixture(scope="module")
def jax_forward(weights, pairs):
    """The JAX sharded 2D forward's level-0 final df and warped image at
    mesh (1, 4)."""
    if jax.device_count() < WORLD:
        pytest.skip("needs 4 JAX devices")
    mesh = jax_make_2d_mesh(1, 4)
    x, y = pairs[0]["x"], pairs[0]["y"]
    df, warped = jax_make_spatial_forward(JaxModel(JaxConfig(**FORWARD)), mesh)(
        jax.device_put(weights["forward"], jax_replicated(mesh)),
        jax.device_put(x, jax_volume_batch_spec(mesh)),
        jax.device_put(y, jax_volume_batch_spec(mesh)), jax.random.key(1))
    return np.asarray(df), np.asarray(warped)


@pytest.fixture(scope="module")
def jax_steps(weights, pairs):
    """The float64 JAX sharded steps at (2, 2) (`_jax_sharded_step`:
    SGD(0.1), gradients from the update); the Dice and jdet steps share
    one network, pair and draws."""
    out = {"plain": _jax_sharded_step(STEP, weights["plain"], pairs[1])}
    segs = {"seg_x": _onehot(SEG_SIZE, 5), "seg_y": _onehot(SEG_SIZE, 6)}
    out["dice"] = _jax_sharded_step(STEPS["dice"], weights["seg"], dict(pairs[2], **segs))
    out["jdet"] = _jax_sharded_step(STEPS["jdet"], weights["seg"], pairs[2], out["dice"]["noise"])
    return out


@pytest.fixture(scope="module")
def ranks(weights, pairs, jax_steps, tmp_path_factory):
    """The four ranks' forwards and steps."""
    tmp = tmp_path_factory.mktemp("spatial2d")
    inp = tmp / "input.pt"
    tensors = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    forward = [{"cfg": FORWARD, "state_dict": from_jax_variables(weights["forward"],
                                                                 PULPoConfig(**FORWARD)),
                **tensors(pairs[0]), "seed": 3}]
    steps = [{"name": name, "cfg": kw, "batch": tensors(jax_steps[name]["batch"]),
              "noise": tensors(jax_steps[name]["noise"]), "update": name == "plain",
              "state_dict": from_jax_variables(jax_steps[name]["before"], PULPoConfig(**kw))}
             for name, kw in STEPS.items()]
    steps.append(dict(steps[1], name="dice_remat", cfg=DICE_REMAT))
    torch.save({"forward": forward, "steps": steps}, inp)
    return _run_workers(tmp, inp, "spatial2d", WORLD)


def _joined(ranks, key):
    """The four slabs of the forward joined along H."""
    return [torch.cat([r["forward"][0][key][k] for r in ranks], dim=1) for k in (0, 1)]


# ----------------------------------------------------------------------
# the forward at mesh (1, 4)
# ----------------------------------------------------------------------

def test_sharded_2d_forward_matches_the_jax_sharded_forward(jax_forward, ranks):
    df, warped = _joined(ranks, "det")
    assert df.shape == (1, *SIZE, 2) and warped.shape == (1, *SIZE, 1)
    assert ranks[0]["forward"][0]["det"][0].shape == (1, SIZE[0] // WORLD, SIZE[1], 2)
    _close(df, jax_forward[0], 1e-5, "df")
    _close(warped, jax_forward[1], 1e-5, "warped")


@pytest.mark.parametrize("key", ["det", "sampled"])
def test_sharded_2d_forward_matches_the_unsharded_port(weights, pairs, ranks, key):
    """Deterministic, and sampled from the same seed (each rank's draws
    its block of the whole draw)."""
    cfg = PULPoConfig(**FORWARD)
    model = PULPoModel(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(weights["forward"], cfg))
    x, y = pairs[0]["x"], pairs[0]["y"]
    outs = (model.apply_eval(x, y, deterministic=True) if key == "det"
            else model.apply_eval(x, y, seed=3))
    df, warped = _joined(ranks, key)
    _close(df, outs[6][0], 2e-6, (key, "df"))
    _close(warped, outs[7][0], 2e-6, (key, "warped"))


def test_a_2d_image_is_sharded_along_h():
    """H splits as a volume's depth does; a level's tensors are known by
    their (W,) plane."""
    cfg = PULPoConfig(**STEP)
    assert [spatial.splits(s[0], 2) for s in cfg.global_level_sizes.values()] == [True] * 3 + [
        False]
    mesh = spatial.Mesh2D((2, 2), 3, *(None,) * 3)
    x = torch.zeros((4, *SIZE, 1))
    assert spatial.shard_volume(x, mesh).shape == (2, SIZE[0] // 2, SIZE[1], 1)
    with spatial.sharded(spatial.make_2d_mesh(1, 1), cfg):
        for size in cfg.global_level_sizes.values():
            assert spatial.layout(torch.zeros((2, *size, 5))) == (size[0], False)
        with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
            spatial.layout(torch.zeros((2, 16, 5, 1)))


# ----------------------------------------------------------------------
# the steps at mesh (2, 2)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_2d_step_matches_the_jax_sharded_step(jax_steps, ranks, name):
    _held_to_jax(ranks[0]["steps"][name], jax_steps[name], PULPoConfig(**STEPS[name]))


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_2d_step_matches_the_unsharded_port_step(jax_steps, ranks, name):
    got = ranks[0]["steps"][name]
    _held_to_port(got, jax_steps[name], PULPoConfig(**STEPS[name]), to_exact=True)
    assert float(got["metrics"]["nan_flag"]) == 0.0
    want = {"halo", "gather", "reduce"} | ({"stats"} if name != "plain" else set()) | (
        {"gather_seg"} if name == "dice" else set())
    assert set(got["traffic"]) == want


def test_the_2d_train_step_updates_the_weights(jax_steps, ranks):
    got = ranks[0]["steps"]["plain"]
    assert float(got["step_metrics"]["total_loss"]) == float(got["metrics"]["total_loss"])
    before = from_jax_variables(jax_steps["plain"]["before"], PULPoConfig(**STEP))
    assert any(not torch.equal(got["after"][n], v) for n, v in before.items()
               if "running" not in n)


def test_sharded_2d_remat_step_is_bit_equal_to_the_sharded_step(ranks):
    got, ref = ranks[0]["steps"]["dice_remat"], ranks[0]["steps"]["dice"]
    for key in ("grads", "stats"):
        assert set(got[key]) == set(ref[key])
        for n, v in ref[key].items():
            assert torch.equal(got[key][n], v), (key, n)
    for k, v in ref["metrics"].items():
        pairs = v.items() if isinstance(v, dict) else [(None, v)]
        for l, t in pairs:
            assert torch.equal(got["metrics"][k] if l is None else got["metrics"][k][l], t), k
    first = {k: v for k, v in got["traffic"].items() if not k.endswith("_recomputed")}
    assert first == ref["traffic"] and got["traffic"]["halo_recomputed"][0] > 0


@pytest.mark.parametrize("name", [*STEPS, "dice_remat"])
def test_the_ranks_agree_bit_for_bit(ranks, name):
    a = ranks[0]["steps"][name]
    for r in ranks[1:]:
        b = r["steps"][name]
        for key in ("grads", "stats") + (("after",) if name == "plain" else ()):
            for n, v in a[key].items():
                assert torch.equal(v, b[key][n]), (key, n)
        for k, v in a["metrics"].items():
            pairs = v.items() if isinstance(v, dict) else [(None, v)]
            for l, t in pairs:
                assert torch.equal(t, b["metrics"][k] if l is None else b["metrics"][k][l]), k
