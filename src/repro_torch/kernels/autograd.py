"""Gradients of the kernel ops: the kernel forward, the plain version's
gradient backward.

No Pallas kernel of the reference has a ``custom_vjp``: the reference
differentiates its plain ``jnp`` model, so each op's gradient is the
gradient of its plain version. ``PlainGrad`` is the ``torch.autograd.Function``
every op's CUDA path goes through when a gradient is needed. Its forward
runs the op's kernel; the kernel's output is what the forward returns. Its
backward recomputes the plain version under ``torch.enable_grad()`` from the
saved inputs and returns ``torch.autograd.grad`` of it: the plain version runs
on the card only there, inside a backward, never in place of a kernel.
"""
from __future__ import annotations

import torch


class PlainGrad(torch.autograd.Function):
    """``PlainGrad.apply(kernel, plain, *args)``: ``kernel(*args)`` forward,
    the gradient of ``plain(*args)`` backward. ``args`` mixes tensors (saved
    for the backward) and other values (kept as they are); integer tensors
    and non-tensors take no gradient. An output whose gradient is missing
    (the scan's final state in training) counts as zero: it is left out of
    the recompute's ``autograd.grad``."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a, t in zip(args, ctx.is_tensor) if t))
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grad_out):
        need = ctx.needs_input_grad[2:]
        saved = iter(ctx.saved_tensors)
        # the profiler's name for this recompute, e.g. PlainGrad.backward[gmm_ref]
        with torch.enable_grad(), torch.profiler.record_function(
                f"PlainGrad.backward[{ctx.plain.__name__}]"):
            args = [next(saved).detach().requires_grad_(n) if t else o
                    for t, o, n in zip(ctx.is_tensor, ctx.others, need)]
            out = ctx.plain(*args)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grad_out)
                     if g is not None and o.requires_grad]
            wrt = [a for a, n in zip(args, need) if n]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs], allow_unused=True)
                       if pairs else [None] * len(wrt))
        return (None, None, *(next(got) if n else None for n in need))


def kernel_op(kernel, plain, *args):
    """``kernel(*args)``, through ``PlainGrad`` when autograd needs a
    gradient of one of ``args``: the same kernel launch either way."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return PlainGrad.apply(kernel, plain, *args)
    return kernel(*args)
