"""Eval kernels whose gradient is their plain version's.

The fused eval kernels (velocity head, posterior head, conv chain) have
no backward kernel: like the JAX package's `jax.custom_vjp`s around
them (pulpo_tpu/kernels/vel_head.py:281-300, pos_head.py:414-433,
attic/conv_chain.py:294-313), a gradient through one replays the plain
PyTorch version under autograd and returns that version's VJP. The
eval path never differentiates, but a gradient through it must not
silently leave the kernel's contribution out.
"""

from __future__ import annotations

import torch


class _PlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ctx.plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [x for x, n in zip(xs, need) if n]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return (None, None, *[next(got) if n else None for n in need])


def apply(kernel, plain, *inputs):
    """`kernel(*inputs)`, differentiated as `plain(*inputs)`. Every input
    is a tensor; `kernel` and `plain` return a tensor or a tuple of them."""
    return _PlainVJP.apply(kernel, plain, *inputs)
