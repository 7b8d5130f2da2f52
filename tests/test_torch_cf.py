"""The port's channels-first (CF) field path against the JAX package's, on the CPU.

The port's CF functions (`squaring_step_cf`, `integrate_svf_cf`,
`warp_cf`, `resize_vecfield_cf`, `batched_level_warp_cf`,
`combine_dfs_cf`) carry unpadded (B, 3, *S) fields; the JAX package's
carry the TPU's tile-padded layout, so the comparisons read the JAX
interiors (`cf_interior`, `[..., :S1, :S2]`). On the CPU each wrapper
runs its plain version; the CUDA kernels against those:
tests/test_torch_gpu.py.

Tolerances: against a Pallas stencil or cascade, 1e-5 relative (the
stencil sums its taps in another order than the gather); the
integration 2e-5, the JAX package's own bound for its CF chain against
the gather (tests/test_cf.py:136); the resize 1e-6 (the same matrices,
the matmul's order); CF against CL in the port: bit-equal. The UQ
request: 1e-4, as tests/test_torch_uq.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulpo_tpu.kernels.warp_halo import warp_cascaded_cf_image
from pulpo_tpu.kernels.warp_local import (
    _round_up,
    _squaring_step_cf_pallas,
    cf_interior,
    cf_pad,
    local_bound,
)
from pulpo_tpu.kernels.warp_local import integrate_svf_cf as jax_integrate_svf_cf
from pulpo_tpu.ops.warp import resize_vecfield_cf as jax_resize_vecfield_cf
from pulpo_tpu_torch import PULPoConfig
from pulpo_tpu_torch.kernels import squaring, warp
from pulpo_tpu_torch.models.api import combine_dfs, combine_dfs_cf
from pulpo_tpu_torch.models.pulpo import cf_fields
from pulpo_tpu_torch.ops.warp import (
    batched_level_warp,
    batched_level_warp_cf,
    integrate_svf,
    integrate_svf_cf,
    resize_vecfield,
    resize_vecfield_cf,
)
from pulpo_tpu_torch.uq.predict import UQResult, predict_with_uncertainty
from test_torch_model import jax_model_and_variables, port_model
from test_torch_uq import comparable, jax_noise

SHAPE = (16, 24, 28)  # tests/test_cf.py's SHAPE


def _field(shape, mag, seed):
    v = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return v * (mag / np.abs(v).max())


def _cf(a: np.ndarray) -> torch.Tensor:
    """A channels-last numpy field as a contiguous CF tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# ----------------------------------------------------------------------
# #3: the CF squaring step and integration
# ----------------------------------------------------------------------

def test_squaring_step_cf_matches_pallas_cf():
    """Sub-voxel field: the TPU's CF stencil on the padded layout."""
    v = _field((2, *SHAPE, 3), 0.8 * local_bound(SHAPE), 0)
    ref = cf_interior(_squaring_step_cf_pallas(cf_pad(jnp.asarray(v)), SHAPE, interpret=True),
                      SHAPE)
    got = squaring.squaring_step_cf(_cf(v))
    assert got.shape == (2, 3, *SHAPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_integrate_svf_cf_matches_jax_past_the_stencil_bound():
    """A field whose scaled start is past the stencil's bound, so every
    JAX step takes the `squaring_beyond_cf` branch: the CF halo-tier
    cascade (`_warp_halo_pallas_cf`, kernel #8) on the padded layout."""
    nsteps = 2
    v = _field((2, *SHAPE, 3), 3.0 * local_bound(SHAPE) * 2**nsteps, 5)
    ref = jax_integrate_svf_cf(jnp.asarray(v), nsteps, True)  # channels-last out
    got = integrate_svf_cf(_cf(v), nsteps)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------------
# #8: the CF warp
# ----------------------------------------------------------------------

def test_warp_cf_matches_jax_cf_image_warp():
    """The decode's batched image warp: C = 1, 2 samples x 2 pairs of df
    rows on the resize's padded CF layout (doff = 0), past the first
    halo tier."""
    rng = np.random.default_rng(19)
    img = rng.random((2, *SHAPE, 1), dtype=np.float32)
    df = _field((4, *SHAPE, 3), 2.8, 23)
    S0, S1, S2 = SHAPE
    dcf = np.pad(np.moveaxis(df, -1, 1), ((0, 0), (0, 0), (0, 0), (0, _round_up(S1, 8) - S1),
                                          (0, _round_up(S2, 128) - S2)))
    ref = warp_cascaded_cf_image(jnp.asarray(img), jnp.asarray(dcf), SHAPE, doff=0,
                                 interpret=True)
    got = warp.warp_cf(_cf(img), _cf(df))
    assert got.shape == (4, 1, *SHAPE)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the resize and the mean-SVF tail
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scale", [2.0, 0.5, 1.0])
def test_resize_vecfield_cf_matches_jax_interior(scale):
    v = _field((2, 8, 12, 14, 3), 1.0, 31)
    out_size = tuple(int(s * scale) for s in (8, 12, 14))
    ref = jax_resize_vecfield_cf(jnp.asarray(np.moveaxis(v, -1, 1)), 1.0 / scale, out_size)
    S0, S1, S2 = out_size
    got = resize_vecfield_cf(_cf(v), 1.0 / scale, out_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[..., :S1, :S2], rtol=0, atol=1e-6)


FULLRES = dict(input_size=(16, 20, 24), total_levels=3, latent_levels=2, n0=4,
               df_resolution="full_res",
               feedback=("samples", "velocity_fields", "individual_dfs", "combined_dfs",
                         "final_dfs"))


def _individual_dfs(cfg, rows, seed):
    return {l: _field((rows, *cfg.level_sizes[l], 3), 1.5, seed + l)
            for l in range(cfg.latent_levels)}


def test_combine_dfs_cf_matches_jax_interior(monkeypatch):
    from pulpo_tpu.config import PULPoConfig as JaxConfig
    from pulpo_tpu.models.api import combine_dfs_cf as jax_combine_dfs_cf

    # interpret-mode Pallas wherever the JAX CF chain would run a kernel
    monkeypatch.setenv("PULPO_CF_PIPELINE", "interpret")
    cfg = PULPoConfig(**FULLRES)
    ind = _individual_dfs(cfg, 2, 40)
    ref_comb, ref_fin = jax_combine_dfs_cf(JaxConfig(**FULLRES),
                                           {l: jnp.asarray(v) for l, v in ind.items()})
    comb, fin = combine_dfs_cf(cfg, {l: torch.from_numpy(v) for l, v in ind.items()})
    _, S1, S2 = cfg.input_size
    for l in ind:
        np.testing.assert_allclose(comb[l].numpy(), np.asarray(ref_comb[l]), rtol=0, atol=1e-6)
        assert fin[l].shape == (2, 3, *cfg.input_size)
        np.testing.assert_allclose(fin[l].numpy(), np.asarray(ref_fin[l])[..., :S1, :S2],
                                   rtol=2e-5, atol=2e-5, err_msg=f"final[{l}]")


# ----------------------------------------------------------------------
# CF against CL in the port: the same operations, bit for bit
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mag", [0.3, 6.0])
def test_cf_integration_and_step_bit_equal_cl(mag):
    v = _field((2, 9, 10, 11, 3), mag, 50)
    cl = torch.from_numpy(v)
    assert torch.equal(integrate_svf_cf(_cf(v), 7).permute(0, 2, 3, 4, 1), integrate_svf(cl, 7))
    assert torch.equal(squaring.squaring_step_cf(_cf(v), scale=0.25).permute(0, 2, 3, 4, 1),
                       squaring.squaring_step(cl, scale=0.25))


@pytest.mark.parametrize("c", [1, 3])
def test_cf_warp_bit_equal_cl(c):
    rng = np.random.default_rng(51)
    m = rng.random((2, 9, 10, 11, c), dtype=np.float32)
    d = _field((4, 9, 10, 11, 3), 4.0, 52)
    got = warp.warp_cf(_cf(m), _cf(d)).permute(0, 2, 3, 4, 1)
    assert torch.equal(got, warp.warp(torch.from_numpy(m), torch.from_numpy(d)))


def test_cf_resize_combine_and_batched_warp_bit_equal_cl():
    cfg = PULPoConfig(**FULLRES)
    ind = {l: torch.from_numpy(v) for l, v in _individual_dfs(cfg, 2, 60).items()}
    comb, fin = combine_dfs(cfg, ind)
    comb_cf, fin_cf = combine_dfs_cf(cfg, ind)
    for l in ind:
        assert torch.equal(comb_cf[l], comb[l])
        assert torch.equal(fin_cf[l].permute(0, 2, 3, 4, 1), fin[l])
        assert torch.equal(resize_vecfield_cf(comb[l].permute(0, 4, 1, 2, 3), 0.5,
                                              cfg.input_size).permute(0, 2, 3, 4, 1),
                           resize_vecfield(comb[l], 0.5, cfg.input_size))
    x = torch.from_numpy(np.random.default_rng(61).random((1, *cfg.input_size, 1),
                                                          dtype=np.float32))
    got, want = batched_level_warp_cf(x, fin_cf), batched_level_warp(x, fin)
    for l in want:
        assert got[l].shape == want[l].shape and torch.equal(got[l], want[l])


def test_cf_gate_is_fixed_by_configuration():
    assert cf_fields(PULPoConfig(**FULLRES))
    assert not cf_fields(PULPoConfig(**dict(FULLRES, df_resolution="level_res")))
    assert not cf_fields(PULPoConfig(**dict(FULLRES, feedback=FULLRES["feedback"]
                                            + ("transformed",))))


def test_cf_gradient_is_the_plain_versions():
    """On the CPU the CF functions are their plain versions; a gradient
    through them equals the channels-last chain's."""
    v = torch.from_numpy(_field((1, 7, 8, 9, 3), 2.0, 70))
    a = v.permute(0, 4, 1, 2, 3).clone().requires_grad_(True)
    b = v.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(torch.sin(integrate_svf_cf(a, 3)).sum(), a)
    (gb,) = torch.autograd.grad(torch.sin(integrate_svf(b, 3)).sum(), b)
    np.testing.assert_allclose(ga.permute(0, 2, 3, 4, 1).numpy(), gb.numpy(),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# the slice: a full_res UQ request through the CF path against JAX
# ----------------------------------------------------------------------

def test_fullres_uq_matches_jax_leaf_by_leaf(monkeypatch):
    """The port's predict_with_uncertainty on a full_res config (CF decode,
    CF mean tail, kept samples, landmarks, mask) against the JAX package's
    `_uq_impl` with its default routing, same weights and draws. The JAX
    package holds its CF path to that default within 2e-5
    (tests/test_cf.py:171-186, 234-253)."""
    from pulpo_tpu.uq.predict import _uq_impl

    monkeypatch.delenv("PULPO_CF_PIPELINE", raising=False)
    jm, variables = jax_model_and_variables(seed=3, **FULLRES)
    model = port_model(variables, **FULLRES)
    assert cf_fields(model.cfg)
    rng_np = np.random.default_rng(7)
    shape = (1, *FULLRES["input_size"], 1)
    x, y = rng_np.random(shape, dtype=np.float32), rng_np.random(shape, dtype=np.float32)
    mask = (x > 0.4).astype(np.float32)
    lm = np.array([[[3.0, 4.0, 5.0], [10.5, 12.0, 20.0]]], np.float32)
    rng = jax.random.key(11)
    N = 4
    ref = _uq_impl(jm, variables, jnp.asarray(x), jnp.asarray(y), N, rng,
                   mask=jnp.asarray(mask), chunk=2, keep_samples=True, lm=jnp.asarray(lm))
    noise = {l: torch.from_numpy(v) for l, v in jax_noise(jm.cfg, rng, N, 1).items()}
    got = predict_with_uncertainty(model, x, y, N, chunk=2, mask=mask, keep_samples=True,
                                   lm=lm, noise=noise)
    for field in UQResult._fields:
        r, g = getattr(ref, field), getattr(got, field)
        if field == "sample_landmarks":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)
            continue
        assert sorted(r) == sorted(g), field
        for l in r:
            assert tuple(g[l].shape) == tuple(r[l].shape), (field, l)
            np.testing.assert_allclose(comparable(field, g[l].numpy()), comparable(field, r[l]),
                                       rtol=0, atol=1e-4, err_msg=f"{field}[{l}]")


def test_served_fullres_manifest_names_the_cf_kernels(tmp_path):
    import json
    import zipfile

    from pulpo_tpu_torch.models import PULPoModel
    from pulpo_tpu_torch.serve import export_model

    model = PULPoModel(PULPoConfig(**FULLRES), device="cpu")
    path = str(tmp_path / "fullres.pulpo")
    export_model(model, path, batch_size=1, N=2)
    with zipfile.ZipFile(path) as zf:
        kernels = json.loads(zf.read("manifest.json"))["kernels"]
    assert kernels["warp_cf"] == "pulpo_tpu_torch/csrc/warp.cu"
    assert kernels["squaring_cf"] == "pulpo_tpu_torch/csrc/squaring.cu"
    assert "warp" not in kernels and "squaring" not in kernels
