"""The conv's derivative algebra: differentiable to any order through two kernels.

Counterpart of ``saragan_tpu/ops/core.py:300-438`` (``_conv3d_C``, ``_conv3d_W``,
``_flip_swap``).  With

    C(x, w)[n,f,s]  = sum_o sum_c x[n,c,s+o] w[o,c,f]      (the conv, kernel #1)
    W(x, dy)[o,c,f] = sum_{n,s} x[n,c,s+o] dy[n,f,s]       (its wgrad, kernel #2)

the adjoints close on the same two functions:

    dC/dx^T u = C(u, fs(w));   dC/dw^T u = W(x, u)
    dW/dx^T v = C(dy, fs(v));  dW/ddy^T v = C(x, v)

where fs(w)[o,f,c] = w[-o,c,f] flips the spatial axes and swaps in/out channels (an
involution).  ``Conv3dC`` and ``Conv3dW`` are ``autograd.Function``s whose backwards call
only ``Conv3dC.apply``, ``Conv3dW.apply`` and ``flip_swap`` (neither is
``once_differentiable``), so ``torch.autograd.grad(..., create_graph=True)``, as the
WGAN-GP penalty uses it, records the backward's own kernel calls and every order of
gradient re-enters the kernels.

A backward computes an input's gradient only when the running backward pass will use it
(``_grad_needed``): the penalty's inner ``grad(D(x), x)`` needs no weight gradients, and
computing them would launch wgrads that nothing reads.  Operands are made contiguous here,
at the Function boundary (the inputs themselves are saved, so a graph recorded in a
backward reaches their history); the kernels take contiguous tensors of one dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from saragan_tpu_torch.ops.conv3d_flat import conv3d_flat, conv3d_flat_wgrad


def flip_swap(w: torch.Tensor) -> torch.Tensor:
    """fs(w): flip the spatial kernel axes, swap the in/out channel axes (contiguous)."""
    r = w.ndim - 2
    return w.flip(dims=tuple(range(r))).transpose(-2, -1).contiguous()


def _grad_needed(ctx, i: int) -> bool:
    """Whether the running backward pass uses the gradient of input `i`.  needs_input_grad
    says only whether the input requires grad; the engine knows whether this pass (for
    example an ``autograd.grad`` with respect to the images only) will run the node that
    consumes it."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None:
        return True
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:  # a leaf that autograd.grad() asked for: the engine cannot say
        return True


class Conv3dC(torch.autograd.Function):
    """C(x, w): SAME stride-1 conv3d, x (N,C,D,H,W), w (kd,kh,kw,C,F) of x's dtype.
    `role` labels the kernel's launch count ("forward" in the model, "dgrad" when a
    backward pass calls it)."""

    @staticmethod
    def forward(ctx, x, w, role="forward"):
        ctx.save_for_backward(x, w)
        return conv3d_flat(x.contiguous(), w.contiguous(), role)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = Conv3dC.apply(dy, flip_swap(w), "dgrad") if _grad_needed(ctx, 0) else None
        dw = Conv3dW.apply(x, dy, tuple(w.shape[:3])) if _grad_needed(ctx, 1) else None
        return dx, dw, None


class Conv3dW(torch.autograd.Function):
    """W(x, dy): the conv's weight gradient for a `kernel`-sized window, in x's dtype."""

    @staticmethod
    def forward(ctx, x, dy, kernel: Tuple[int, int, int]):
        ctx.save_for_backward(x, dy)
        return conv3d_flat_wgrad(x.contiguous(), dy.contiguous(), kernel)

    @staticmethod
    def backward(ctx, uw):
        x, dy = ctx.saved_tensors
        uw = uw.contiguous()
        dx = Conv3dC.apply(dy, flip_swap(uw), "dgrad") if _grad_needed(ctx, 0) else None
        ddy = Conv3dC.apply(x, uw, "dgrad") if _grad_needed(ctx, 1) else None
        return dx, ddy, None


def conv3d_c(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """C(x, w) with the algebra's gradients (the model's convs under ``flat``)."""
    return Conv3dC.apply(x, w)
