"""Hand-written CUDA kernels (sources in pulpo_tpu_torch/csrc/), each
beside its plain PyTorch version and with a count of its launches."""
