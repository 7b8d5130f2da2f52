"""Carry weights from the JAX package's variables into the port.

`from_jax_variables` takes the flax ``{'params', 'batch_stats'}`` tree
(nested dicts of numpy arrays, or anything `numpy.asarray` reads) and
returns a state_dict in the reference checkpoint's layout, which the
port's modules use: conv kernels go from flax's (*K, I, O) to PyTorch's
(O, I, *K), BatchNorm scale/bias/mean/var to weight/bias/running_mean/
running_var. It is the inverse of the JAX package's
`compat/torch_import.py:import_torch_state_dict`.
"""

from __future__ import annotations

import numpy as np
import torch

from pulpo_tpu_torch.config import PULPoConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel(k) -> torch.Tensor:
    """flax (*K, I, O) -> torch (O, I, *K)."""
    k = np.asarray(k)
    nd = k.ndim - 2
    return _t(np.transpose(k, (nd + 1, nd) + tuple(range(nd))))


def _conv(out: dict, prefix: str, tree: dict) -> None:
    conv = tree["Conv_0"]
    out[f"{prefix}.weight"] = _kernel(conv["kernel"])
    out[f"{prefix}.bias"] = _t(conv["bias"])


def _convunit(out: dict, prefix: str, p: dict, s: dict) -> None:
    _conv(out, f"{prefix}._op.0", p["TorchConv_0"])
    out[f"{prefix}._op.1.weight"] = _t(p["BatchNorm_0"]["scale"])
    out[f"{prefix}._op.1.bias"] = _t(p["BatchNorm_0"]["bias"])
    out[f"{prefix}._op.1.running_mean"] = _t(s["BatchNorm_0"]["mean"])
    out[f"{prefix}._op.1.running_var"] = _t(s["BatchNorm_0"]["var"])


def _convseq(out: dict, prefix: str, depth: int, p: dict, s: dict) -> None:
    for i in range(depth):
        _convunit(out, f"{prefix}._op.{i}", p[f"ConvUnit_{i}"], s[f"ConvUnit_{i}"])


def from_jax_variables(variables, cfg: PULPoConfig) -> dict[str, torch.Tensor]:
    """State_dict of the port (reference layout) from flax variables."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    dp, ds = params["downpath"], stats["downpath"]
    for k in range(cfg.total_levels):
        _convseq(out, f"downpath.down_blocks.{k}", 3, dp[f"down_block_{k}"],
                 ds[f"down_block_{k}"])
    ap, as_ = params["autoencoder"], stats["autoencoder"]
    for k in range(cfg.lk_offset, cfg.total_levels - 1):
        _convseq(out, f"autoencoder.up_blocks.{k}", 2, ap[f"up_block_{k}"],
                 as_[f"up_block_{k}"])
    for l in range(cfg.latent_levels):
        enc = ap[f"encoder_{l}"]
        pre = f"autoencoder.encoders.{l}"
        if l < cfg.latent_levels - 1:
            _convseq(out, f"{pre}.sample_merge_block", 2, enc["sample_merge_block"],
                     as_[f"encoder_{l}"]["sample_merge_block"])
        _conv(out, f"{pre}.mu_sigma._conv_mu", enc["mu_sigma"]["conv_mu"])
        _conv(out, f"{pre}.mu_sigma._conv_sigma.0", enc["mu_sigma"]["conv_sigma"])
    for l in range(cfg.latent_levels):
        vf = ap[f"decoder_{l}"]["velocity_field"]
        pre = f"autoencoder.decoders.{l}.velocity_field"
        if cfg.cp_depth >= 2:
            vs = as_[f"decoder_{l}"]["velocity_field"]
            for i in range(cfg.cp_depth - 1):
                _convunit(out, f"{pre}._op.{i}", vf[f"ConvUnit_{i}"], vs[f"ConvUnit_{i}"])
            _conv(out, f"{pre}._op.{cfg.cp_depth - 1}", vf["TorchConv_0"])
        elif cfg.cp_depth == 1:
            _conv(out, f"{pre}._op.0", vf["TorchConv_0"])
    return out


def pos_head_params_from_jax(p: dict) -> dict[str, torch.Tensor]:
    """The JAX posterior-head kernel's parameter dict
    (pulpo_tpu/kernels/pos_head.py:286-299: flax (3, 3, 3, I, O) and
    (1, 1, 1, I, O) kernels) as kernels/pos_head.py takes it (PyTorch
    (O, I, *K) kernels, the same keys)."""
    return {k: _kernel(v) if np.ndim(v) == 5 else _t(v) for k, v in p.items()}


def conv_chain_stages_from_jax(stages: list[dict]) -> list[dict[str, torch.Tensor]]:
    """The JAX conv-chain kernel's stages (pulpo_tpu/attic/conv_chain.py:
    k (3, 3, 3, I, O), b, mean, var, scale, bias) as kernels/conv_chain.py
    takes them."""
    return [{k: _kernel(v) if k == "k" else _t(v) for k, v in s.items()} for s in stages]
