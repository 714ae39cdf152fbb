"""Differentiability shim for the hand-written kernels (counterpart of
``vv_dsp_tpu/utils/kernel_grad.py``).

A CUDA kernel has no autograd rule, but each one has a plain PyTorch
version that computes the same function. ``kernel_with_torch_vjp`` pairs
them: the forward runs the kernel, the backward differentiates the plain
version at the same inputs. The backward costs what the op would have
cost without the kernel, and only when differentiating.
"""

from __future__ import annotations

import torch


class _KernelWithVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fast_fn, ref_fn, *tensors):
        ctx.ref_fn = ref_fn
        ctx.save_for_backward(*tensors)
        return fast_fn(*tensors)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[2:])]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ctx.ref_fn(*inputs)
        grads = iter(torch.autograd.grad(out, wrt, grad))
        return (None, None, *(next(grads) if t.requires_grad else None
                              for t in inputs))


def kernel_with_torch_vjp(fast_fn, ref_fn):
    """Callable over tensor positional args: forward runs fast_fn (the
    kernel path), backward runs the VJP of ref_fn (the plain path computing
    the same function). Static parameters are closed over by both."""

    def f(*tensors):
        return _KernelWithVjp.apply(fast_fn, ref_fn, *tensors)

    return f
