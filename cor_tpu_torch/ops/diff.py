"""Gradients for kernels that have no backward kernel, the PyTorch counterpart
of ``cor_tpu.ops.diff``.

``with_plain_vjp(kernel_fn, plain_fn)`` returns a function that runs
``kernel_fn`` forward and, in the backward, recomputes ``plain_fn`` from the
saved inputs under ``torch.enable_grad()`` and takes its vector-Jacobian
product with ``torch.autograd.grad``: the recompute ``cor_tpu``'s
``with_oracle_vjp`` does with ``jax.vjp``, so nothing beyond the inputs is
kept alive between the forward and the backward. Both callables take the
same positional arguments (tensors, and plain values such as a head count or
an eps, which receive no gradient) and return one tensor. The kernel and its
plain version agree to the tolerance the kernel's tests hold, so the
gradient is exact for the plain version and right to that tolerance for the
kernel's output.

K5 (``ops.kernels.layernorm``) and K4 (``ops.kernels.seq_attention``) take
their gradients this way, as ``cor_tpu`` computes theirs in XLA.
"""

from __future__ import annotations

from typing import Callable

import torch


def with_plain_vjp(kernel_fn: Callable, plain_fn: Callable) -> Callable:
    """Differentiable wrapper: ``kernel_fn`` forward, the VJP of ``plain_fn``
    (recomputed from the inputs) backward."""

    class _PlainVjp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            is_t = [isinstance(a, torch.Tensor) for a in args]
            ctx.is_t = is_t
            ctx.consts = [None if t else a for a, t in zip(args, is_t)]
            ctx.save_for_backward(*(a for a, t in zip(args, is_t) if t))
            return kernel_fn(*args)

        @staticmethod
        def backward(ctx, grad_out):
            saved = iter(ctx.saved_tensors)
            args, wrt = [], []
            for i, (t, c) in enumerate(zip(ctx.is_t, ctx.consts)):
                if not t:
                    args.append(c)
                    continue
                a = next(saved).detach()
                if ctx.needs_input_grad[i]:
                    a.requires_grad_(True)
                    wrt.append((i, a))
                args.append(a)
            grads = [None] * len(args)
            if wrt:
                with torch.enable_grad():
                    out = plain_fn(*args)
                got = torch.autograd.grad(out, [a for _, a in wrt], grad_out, allow_unused=True)
                for (i, _), g in zip(wrt, got):
                    grads[i] = g
            return tuple(grads)

    return _PlainVjp.apply


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on these inputs."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would record an op on these inputs: for the kernels
    whose ``cor_tpu`` counterparts have no backward (K1, K2, K3)."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what} has no backward (nor has cor_tpu's kernel): call it under "
            "torch.no_grad(), or train through the decoder's fused=False path")
