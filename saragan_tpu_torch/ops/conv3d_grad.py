"""The conv's derivative algebra: differentiable to any order through two functions.

Counterpart of ``saragan_tpu/ops/core.py:300-438`` (``_conv3d_C``, ``_conv3d_W``,
``_flip_swap``).  With

    C(x, w)[n,f,s]  = sum_o sum_c x[n,c,s+o] w[o,c,f]      (the conv)
    W(x, dy)[o,c,f] = sum_{n,s} x[n,c,s+o] dy[n,f,s]       (its wgrad)

the adjoints close on the same two functions:

    dC/dx^T u = C(u, fs(w));   dC/dw^T u = W(x, u)
    dW/dx^T v = C(dy, fs(v));  dW/ddy^T v = C(x, v)

where fs(w)[o,f,c] = w[-o,c,f] flips the spatial axes and swaps in/out channels (an
involution).  ``Conv3dC`` and ``Conv3dW`` are ``autograd.Function``s whose backwards call
only ``Conv3dC.apply``, ``Conv3dW.apply`` and ``flip_swap`` (neither is
``once_differentiable``), so ``torch.autograd.grad(..., create_graph=True)``, as the
WGAN-GP penalty uses it, records the backward's own calls and every order of gradient
re-enters the same engines.

The engines behind C and W (`algebra`, a (conv, wgrad, stats) triple from
``ops.core.Ops``), as the reference's ``_conv3d_engine`` and ``_conv3d_W`` pick them:

* "flat": C is kernel #1 (``conv3d_flat``), W kernel #2 (``conv3d_flat_wgrad``);
* "flat_v2": C is kernel #3 (``conv3d_flat_v2``), W the `wgrad` choice: the reference's
  ``_conv3d_W`` takes its kernel #2 only under ``pallas`` (``:418``), whatever its
  ``_conv3d_engine`` docstring (``:360-363``) says of ``pallas2``;
* "gemm_custom": C is the scan GEMM (``conv3d_gemm.shifted_gemm``), W the `wgrad` choice,
  "library" (the library conv's weight gradient, the reference's ``xla``) or "einsum".

Under every engine a 1x1x1 C is the GEMM formulation's ``conv_1x1`` and a skinny 1x1x1 W
(C and F at most 32) ``wgrad_mulsum_1x1``, their channel sums in the `stats` dtype.

A backward computes an input's gradient only when the running backward pass will use it
(``_grad_needed``): the penalty's inner ``grad(D(x), x)`` needs no weight gradients, and
computing them would launch wgrads that nothing reads.  Operands are made contiguous here,
at the Function boundary (the inputs themselves are saved, so a graph recorded in a
backward reaches their history); the kernels take contiguous tensors of one dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from saragan_tpu_torch.ops.conv3d_flat import conv3d_flat, conv3d_flat_v2, conv3d_flat_wgrad
from saragan_tpu_torch.ops.conv3d_gemm import (shifted_gemm, wgrad_einsum, wgrad_library,
                                               wgrad_mulsum_1x1)

FLAT = ("flat", "library", "f32")  # kernels #1 and #2, f32 statistics


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


def _c(x, w, role, algebra):
    conv, _, stats = algebra
    if conv == "gemm_custom" or math.prod(w.shape[:3]) == 1:
        return shifted_gemm(x, w, stats)
    if conv == "flat_v2":
        return conv3d_flat_v2(x, w, role)
    return conv3d_flat(x, w, role)


def _w(x, dy, kernel, algebra):
    conv, wgrad, stats = algebra
    if math.prod(kernel) == 1 and x.shape[1] <= 32 and dy.shape[1] <= 32:
        return wgrad_mulsum_1x1(x, dy, stats)
    if conv == "flat":
        return conv3d_flat_wgrad(x, dy, kernel)
    if wgrad == "einsum":
        return wgrad_einsum(x, dy, kernel)
    return wgrad_library(x, dy, kernel)


class Conv3dC(torch.autograd.Function):
    """C(x, w): SAME stride-1 conv3d, x (N,C,D,H,W), w (kd,kh,kw,C,F) of x's dtype.
    `role` labels a kernel's launch count ("forward" in the model, "dgrad" when a backward
    pass calls it); `algebra` picks the engines (module docstring)."""

    @staticmethod
    def forward(ctx, x, w, role="forward", algebra=FLAT):
        ctx.save_for_backward(x, w)
        ctx.algebra = algebra
        return _c(x.contiguous(), w.contiguous(), role, algebra)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if _grad_needed(ctx, 0):
            dx = Conv3dC.apply(dy, flip_swap(w), "dgrad", ctx.algebra)
        if _grad_needed(ctx, 1):
            dw = Conv3dW.apply(x, dy, tuple(w.shape[:3]), ctx.algebra)
        return dx, dw, None, None


class Conv3dW(torch.autograd.Function):
    """W(x, dy): the conv's weight gradient for a `kernel`-sized window, in x's dtype."""

    @staticmethod
    def forward(ctx, x, dy, kernel: Tuple[int, int, int], algebra=FLAT):
        ctx.save_for_backward(x, dy)
        ctx.algebra = algebra
        return _w(x.contiguous(), dy.contiguous(), kernel, algebra)

    @staticmethod
    def backward(ctx, uw):
        x, dy = ctx.saved_tensors
        uw = uw.contiguous()
        dx = ddy = None
        if _grad_needed(ctx, 0):
            dx = Conv3dC.apply(dy, flip_swap(uw), "dgrad", ctx.algebra)
        if _grad_needed(ctx, 1):
            ddy = Conv3dC.apply(x, uw, "dgrad", ctx.algebra)
        return dx, ddy, None, None


def conv3d_c(x: torch.Tensor, w: torch.Tensor, algebra=FLAT) -> torch.Tensor:
    """C(x, w) with the algebra's gradients (the model's convs under ``flat``, ``flat_v2``
    and ``gemm_custom``)."""
    return Conv3dC.apply(x, w, "forward", algebra)
