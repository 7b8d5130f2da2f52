"""The port's narrow-input conv (kernel #12) against the JAX package's, on the CPU.

On the CPU `conv_narrow` runs its plain version (the 27-tap float32 sum
the CUDA kernel repeats); it is held against
`pulpo_tpu/attic/conv_narrow.py:conv3d_narrow_mxu` in interpret mode,
its gradient against `jax.grad` through `conv3d_narrow` (XLA's conv
VJP), and the train ConvUnit that routes its conv here against the
flax ConvUnit. The CUDA kernel against the plain version:
tests/test_torch_gpu.py.

Tolerances: float32, 1e-5 of the output's scale (the MXU contraction
sums the taps in another order); bfloat16, one bf16 ulp at the output's
scale (each side rounds one float32 sum once); gradients and the train
unit in float32, 1e-5 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pulpo_tpu.attic.conv_narrow import conv3d_narrow, conv3d_narrow_mxu
from pulpo_tpu.models.blocks import ConvUnit as FlaxConvUnit
from pulpo_tpu_torch.kernels import conv_narrow
from pulpo_tpu_torch.models.blocks import ConvUnit, conv_cl
from test_torch_threads import one_torch_thread  # noqa: F401


def _case(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((cout, shape[-1], 3, 3, 3)) / np.sqrt(27 * shape[-1])).astype(
        np.float32)
    return x, w


def _jax_kernel(w: np.ndarray) -> jnp.ndarray:
    """(cout, cin, 3, 3, 3) -> the JAX (3, 3, 3, cin, cout)."""
    return jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 10, 3), (2, 16, 12, 20, 2)])
def test_plain_matches_pallas_narrow_conv(shape, dtype):
    x, w = _case(shape, 8, sum(shape))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    xj = jnp.asarray(x).astype(jdt)
    ref = np.asarray(conv3d_narrow_mxu(xj, _jax_kernel(w), interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = conv_narrow.conv_narrow(xt, torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (*shape[:-1], 8)
    scale = float(np.abs(ref).max())
    tol = 1e-5 * max(1.0, scale) if dtype == "float32" else _bf16_ulp(scale)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


def test_gradients_match_jax_conv_vjp():
    """dx and dW of sum(out * g) through `NarrowConv` against `jax.grad`
    through `conv3d_narrow` (the Pallas forward, XLA's conv VJP)."""
    x, w = _case((2, 8, 6, 10, 3), 8, 3)
    g = np.random.default_rng(4).standard_normal((2, 8, 6, 10, 8)).astype(np.float32)
    ref_x, ref_k = jax.grad(
        lambda a, k: jnp.sum(conv3d_narrow(a, k, True) * g), argnums=(0, 1))(
        jnp.asarray(x), _jax_kernel(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    gx, gw = torch.autograd.grad((conv_narrow.conv_narrow(xt, wt) * torch.from_numpy(g)).sum(),
                                 (xt, wt))
    for got, ref in ((gx.numpy(), np.asarray(ref_x)),
                     (np.transpose(gw.numpy(), (2, 3, 4, 1, 0)), np.asarray(ref_k))):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_gradient_is_the_library_conv_backward():
    """The backward is `aten.convolution_backward`, as F.conv3d's: on the
    same inputs the gradients are the cuDNN/oneDNN conv's, and dx is
    left out when x needs none."""
    x, w = _case((1, 5, 6, 7, 2), 4, 5)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 5, 6, 7, 4)).astype(
        np.float32))
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    got = torch.autograd.grad((conv_narrow.conv_narrow(xt, wt) * g).sum(), (xt, wt))
    lib = F.conv3d(xt.permute(0, 4, 1, 2, 3), wt, padding=1).permute(0, 2, 3, 4, 1)
    want = torch.autograd.grad((lib * g).sum(), (xt, wt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    (gw,) = torch.autograd.grad((conv_narrow.conv_narrow(xt.detach(), wt) * g).sum(), (wt,))
    np.testing.assert_allclose(gw.numpy(), want[1].numpy(), rtol=0, atol=1e-6)


def test_conv3d_cl_routes_narrow_convs_by_shape():
    """k = 3, pad = 1 and <= 4 input channels: the narrow conv (its plain
    version on the CPU, bit for bit); anything else: F.conv3d."""
    x, w = _case((1, 5, 6, 7, 4), 6, 7)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(conv_cl(xt, wt, 1), conv_narrow.conv_narrow_plain(xt, wt))
    x5, w5 = _case((1, 5, 6, 7, 5), 6, 8)
    assert not conv_narrow.takes(torch.from_numpy(x5), torch.from_numpy(w5))
    lib = F.conv3d(torch.from_numpy(x5).permute(0, 4, 1, 2, 3), torch.from_numpy(w5),
                   padding=1).permute(0, 2, 3, 4, 1)
    assert torch.equal(conv_cl(torch.from_numpy(x5), torch.from_numpy(w5), 1), lib)
    before = conv_narrow.launches
    conv_cl(xt, wt, 1)
    assert conv_narrow.launches == before  # the CPU runs the plain version


def test_train_conv_unit_with_three_inputs_matches_flax():
    """A velocity head's first unit (zdim 3 -> 8) in train mode: the
    narrow conv, the bias, batch-statistics BatchNorm and LeakyReLU, and
    the gradients of the conv weight and of the input."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 7, 8, 3)).astype(np.float32)
    g = rng.standard_normal((2, 6, 7, 8, 8)).astype(np.float32)
    fu = FlaxConvUnit(8)
    v = fu.init(jax.random.key(2), jnp.asarray(x), train=True)
    params = jax.tree.map(np.asarray, v["params"])
    params["BatchNorm_0"] = {"scale": rng.standard_normal(8).astype(np.float32) + 1,
                             "bias": rng.standard_normal(8).astype(np.float32)}

    def loss(p, a):
        out, _ = fu.apply({"params": p, "batch_stats": v["batch_stats"]}, a, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * g), out

    (_, ref), (ref_p, ref_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    unit = ConvUnit(3, 8, torch.float32)
    conv, bn = unit._op
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(params["TorchConv_0"]["Conv_0"]["kernel"],
                                                        (4, 3, 0, 1, 2))))
        conv.bias.copy_(torch.from_numpy(params["TorchConv_0"]["Conv_0"]["bias"]))
        bn.weight.copy_(torch.from_numpy(params["BatchNorm_0"]["scale"]))
        bn.bias.copy_(torch.from_numpy(params["BatchNorm_0"]["bias"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = unit(xt, train=True)
    gx, gk = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (xt, conv.weight))
    ref_k = np.asarray(ref_p["TorchConv_0"]["Conv_0"]["kernel"])
    for got, want in ((out.detach().numpy(), np.asarray(ref)), (gx.numpy(), np.asarray(ref_x)),
                      (np.transpose(gk.numpy(), (2, 3, 4, 1, 0)), ref_k)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
