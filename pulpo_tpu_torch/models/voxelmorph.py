"""The diffeomorphic-VoxelMorph baseline (DIF-VM).

Port of pulpo_tpu/models/voxelmorph.py: a U-Net over concat(moving,
fixed) predicting (mu, log sigma) of an SVF at half resolution, sampled,
integrated by scaling and squaring and upscaled (Dalca et al.), trained
with the VoxelMorph-diff loss (MSE / (2 sigma^2) + the non-diagonal KL
per SVF element).

It runs on the port's ops, so on a CUDA tensor every call below is a
kernel of the port: each 3x3 conv goes through `models/blocks.conv_cl`
(the first, 2 -> 16 at the input size, is the narrow-conv kernel
`csrc/conv_narrow.cu`; the others are the library's), the integration
is `csrc/squaring.cu` (its backward `csrc/squaring_bwd.cu`) and the
moved image `csrc/warp.cu` (its df-cotangent `csrc/warp_bwd.cu`).
Pooling and resizing are `ops/resize.py`'s matrices, as in the JAX
package. The JAX package convolves with XLA and integrates with XLA's
gather; on the CPU the port's plain versions compute the same.

Noise: `eps` (the standard-normal draws, (N, B, *half, ndims)) may be
injected, as the tests inject the JAX draws; otherwise it is drawn from
a `torch.Generator` seeded by `seed`, on the model's device.

`VxmModel.predict` runs the U-Net ONCE per pair and draws its N noises
on the one (mu, sigma): the N fields are integrated, resized and warped
as N rows of one batch. The JAX `predict` vmaps the whole forward over
the N keys, so it recomputes the same U-Net activations N times; the
outputs are the same function of the same draws.

Layout: channels-last, images (B, *spatial, 1), fields (B, *spatial,
ndims). Parameters are float32; the module computes in `dtype`
(default float32, as the JAX module's `dtype=None`).
"""

from __future__ import annotations

import torch
from torch import nn

from pulpo_tpu_torch.kernels.vel_head import leaky
from pulpo_tpu_torch.models.api import _as_tensor, resolve_device
from pulpo_tpu_torch.models.blocks import conv_cl, conv_module
from pulpo_tpu_torch.ops.resize import avg_pool_ceil, resize_linear
from pulpo_tpu_torch.ops.warp import integrate_svf, resize_vecfield, warp_image

ENC_FEATURES = (16, 32, 32, 32)
DEC_FEATURES = (32, 32, 32, 32, 16, 16)


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A SAME 3x3 conv of channels-last x with its bias, in x's dtype."""
    return conv_cl(x, conv.weight, 1) + conv.bias.to(x.dtype)


class VxmDense(nn.Module):
    """U-Net -> probabilistic SVF -> diffeomorphic warp. `convs` are the
    JAX module's `_ConvLReLU_0..9` (4 encoder, 4 decoder, 2 final)."""

    def __init__(self, ndims: int = 3, int_steps: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ndims, self.int_steps, self.dtype = ndims, int_steps, dtype
        conv = conv_module(ndims)
        cins, cin = [], 2
        for f in ENC_FEATURES:
            cins.append((cin, f))
            cin = f
        for i, f in enumerate(DEC_FEATURES[:4]):
            cins.append((cin, f))
            cin = f + (ENC_FEATURES[-(i + 1)] if i < len(ENC_FEATURES) else 0)
        for f in DEC_FEATURES[4:]:
            cins.append((cin, f))
            cin = f
        self.convs = nn.ModuleList([conv(i, o, 3, padding=1) for i, o in cins])
        self.flow_mu = conv(cin, ndims, 3, padding=1)
        self.flow_log_sigma = conv(cin, ndims, 3, padding=1)

    def features(self, moving: torch.Tensor, fixed: torch.Tensor):
        """The U-Net and the SVF head: (mu, sigma), float32, at half size."""
        x = torch.cat([moving, fixed], dim=-1).to(self.dtype)
        n_enc = len(ENC_FEATURES)
        skips, h = [], x
        for conv in self.convs[:n_enc]:
            h = leaky(_conv(conv, h))
            skips.append(h)
            h = avg_pool_ceil(h)
        for i, conv in enumerate(self.convs[n_enc:n_enc + 4]):
            h = leaky(_conv(conv, h))
            if i < len(skips):
                skip = skips[-(i + 1)]
                h = resize_linear(h, tuple(skip.shape[1:-1]))
                h = torch.cat([h, skip], dim=-1)
        for conv in self.convs[n_enc + 4:]:
            h = leaky(_conv(conv, h))
        half = tuple(-(-s // 2) for s in moving.shape[1:-1])
        h = resize_linear(h, half)
        mu = _conv(self.flow_mu, h).float()
        sigma = torch.exp(_conv(self.flow_log_sigma, h).float())
        return mu, sigma

    def warp(self, moving: torch.Tensor, z: torch.Tensor):
        """Integrate the SVF rows `z` (R, *half, nd), resize them to the
        input size and warp `moving` by them (row r reads moving row
        r % B). Returns (moved, full_df)."""
        integrated = integrate_svf(z, nsteps=self.int_steps)
        full_df = resize_vecfield(integrated, 0.5, out_size=tuple(moving.shape[1:-1]))
        return warp_image(moving.float(), full_df), full_df

    def forward(self, moving, fixed, deterministic: bool = False, eps=None):
        """(moved, full_df, (mu, sigma, z)); `eps` (B, *half, nd) unless
        deterministic."""
        mu, sigma = self.features(moving, fixed)
        z = mu if deterministic else mu + sigma * eps
        moved, full_df = self.warp(moving, z)
        return moved, full_df, (mu, sigma, z)


class VxmModel:
    """The baseline's weights and entry points (the JAX `VxmModel`'s API
    with the port's conventions: a device, seeds or injected draws).
    Runs on `cuda` unless `device="cpu"` is given."""

    def __init__(self, input_size, dtype: torch.dtype | None = None, int_steps: int = 7,
                 device=None):
        self.input_size = tuple(input_size)
        self.device = resolve_device(device)
        self.module = VxmDense(len(self.input_size), int_steps,
                               dtype or torch.float32).to(self.device).eval()

    @property
    def half_size(self) -> tuple[int, ...]:
        return tuple(-(-s // 2) for s in self.input_size)

    def init(self, seed: int = 0) -> dict:
        """Initialise the weights from `seed` as PyTorch initialises convs
        (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel and bias, the JAX
        module's torch-style init). Returns the state_dict."""
        g = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.module.modules():
                if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                    bound = 1.0 / float(m.weight[0].numel()) ** 0.5
                    for p in (m.weight, m.bias):
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))
        return self.state_dict()

    def state_dict(self) -> dict:
        return self.module.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.module.load_state_dict(state_dict)

    def noise(self, n: int, batch: int, seed: int = 0) -> torch.Tensor:
        """(n, batch, *half, ndims) standard-normal draws from `seed`."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randn((n, batch, *self.half_size, self.module.ndims), generator=g,
                           device=self.device, dtype=torch.float32)

    def _pair(self, moving, fixed):
        return _as_tensor(moving, self.device), _as_tensor(fixed, self.device)

    @torch.inference_mode()
    def apply(self, moving, fixed, deterministic: bool = False, seed: int = 0, eps=None):
        """One forward: (moved, full_df, (mu, sigma, z)). `eps` (B, *half,
        nd), or drawn from `seed`, unless deterministic."""
        moving, fixed = self._pair(moving, fixed)
        if not deterministic and eps is None:
            eps = self.noise(1, moving.shape[0], seed)[0]
        if eps is not None:
            eps = _as_tensor(eps, self.device)
        return self.module(moving, fixed, deterministic=deterministic, eps=eps)

    @torch.inference_mode()
    def predict(self, moving, fixed, num_samples: int, seed: int = 0, eps=None):
        """(avg_moved, avg_df, moved_std, df_std, all_moved, all_dfs): the
        reference's predict_vxm outputs (evaluate.py:282-309). `all_*` are
        (N, B, ...), the stds Bessel-corrected (ddof=1) over the samples
        and averaged over the channels, (B, *spatial). `eps` (N, B, *half,
        nd), or drawn from `seed`."""
        moving, fixed = self._pair(moving, fixed)
        b, n = moving.shape[0], num_samples
        eps = self.noise(n, b, seed) if eps is None else _as_tensor(eps, self.device)
        mu, sigma = self.module.features(moving, fixed)
        z = (mu + sigma * eps).reshape(n * b, *mu.shape[1:])  # sample-major rows
        moved, dfs = self.module.warp(moving, z)
        moved = moved.reshape(n, b, *moved.shape[1:])
        dfs = dfs.reshape(n, b, *dfs.shape[1:])
        moved_std = torch.std(moved, dim=0, correction=1).mean(dim=-1)
        df_std = torch.std(dfs, dim=0, correction=1).mean(dim=-1)
        return moved.mean(dim=0), dfs.mean(dim=0), moved_std, df_std, moved, dfs


def vxm_loss(model: VxmModel, batch: dict, eps: torch.Tensor, image_sigma: float = 0.02,
             prior_lambda: float = 20.0):
    """The VoxelMorph-diff loss of one batch with draws `eps` (B, *half,
    nd): -log p(y | moved) = MSE / (2 image_sigma^2), plus the
    non-diagonal KL on the SVF posterior over the SVF's element count.
    Returns (total, metrics), differentiable in the module's weights."""
    from pulpo_tpu_torch.ops.losses import kl_nondiagonal

    x, y = model._pair(batch["x"], batch["y"])
    moved, _df, (mu, sigma, _z) = model.module(x, y, eps=eps)
    recon = torch.mean((moved - y) ** 2) / (2 * image_sigma**2)
    # normalise the KL per voxel to keep the magnitudes comparable
    kl = kl_nondiagonal(mu, sigma, prior_lambda=prior_lambda) / float(mu.numel())
    total = recon + kl
    return total, {"total_loss": total, "recon": recon, "kl": kl}


def vxm_grads(model: VxmModel, batch: dict, eps: torch.Tensor, **loss_kw):
    """(grads by parameter name, metrics) of `vxm_loss`."""
    named = dict(model.module.named_parameters())
    total, metrics = vxm_loss(model, batch, eps, **loss_kw)
    grads = torch.autograd.grad(total, list(named.values()))
    return dict(zip(named, grads)), {k: v.detach() for k, v in metrics.items()}


def make_vxm_train_step(model: VxmModel, tx: torch.optim.Optimizer, image_sigma: float = 0.02,
                        prior_lambda: float = 20.0, seed: int = 0):
    """VoxelMorph-diff training with the torch optimizer `tx` over the
    module's parameters: ``step(batch, eps=None) -> metrics``. Each step
    draws its noise from a generator seeded by `seed` (as the JAX step
    splits its key), unless `eps` (B, *half, nd) is given."""
    g = torch.Generator().manual_seed(int(seed))

    def step(batch: dict, eps=None):
        if eps is None:
            b = len(batch["x"])
            eps = model.noise(1, b, int(torch.randint(0, 2**62, (1,), generator=g)))[0]
        grads, metrics = vxm_grads(model, batch, _as_tensor(eps, model.device),
                                   image_sigma=image_sigma, prior_lambda=prior_lambda)
        tx.zero_grad(set_to_none=True)
        for name, p in model.module.named_parameters():
            p.grad = grads[name]
        tx.step()
        return metrics

    return step
