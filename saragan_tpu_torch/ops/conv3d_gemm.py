"""The 3-D conv as channel GEMMs, and the weight gradients of the C/W algebra, in plain
PyTorch ops (counterparts of ``_conv3d_shifted_gemm``, ``_wgrad_mulsum_1x1``,
``_wgrad_einsum`` and ``_wgrad_xla``, ``saragan_tpu/ops/core.py:182-247, 332-357,
394-411``).

* ``shifted_gemm``: the SAME stride-1 conv of x (N, C, D, H, W) with w (kd, kh, kw, C, F)
  as y[n, f, s] = sum over the kernel offsets o of x_pad[n, :, s + o] @ w[o], one
  (N, C, DHW) x (C, F) channel GEMM per offset, every product landing in ONE accumulator
  of f32 (f64 for f64 inputs): each slice and its weight are cast up before their GEMM, so
  no term is rounded to x's dtype before the sum, as the reference's
  ``preferred_element_type=f32`` keeps it; the sum rounds once.  Autograd differentiates
  it (the reference's ``gemm`` engine), each offset's GEMM a recompute region
  (non-reentrant ``torch.utils.checkpoint``) that keeps only its slice of the padded
  input, a view: kept for the backward, the f32 copies of 27 slices took 46 GiB at the
  flagship step on an H100 (PERF.md); 1x1x1 kernels go to ``conv_1x1``.
* ``conv_1x1``: skinny channel counts (C and F at most 32) as a broadcast multiply,
  rounded to x's dtype, and a channel sum; wider ones as one channel GEMM in f32.
* the C/W algebra's weight gradients dw[o, c, f] = sum_{n, s} x[n, c, s + o] dy[n, f, s]:
  ``wgrad_mulsum_1x1`` (skinny 1x1x1: multiply and sum), ``wgrad_einsum`` (one
  (C, NDHW) x (NDHW, F) GEMM per offset, f32) and ``wgrad_library`` (the library conv's
  own weight gradient, ``aten.convolution_backward`` with only the weight mask: the
  reference's ``xla`` choice, the transpose of its native conv).

`stats` ("f32" or "compute", ``ops.core.Ops.stats``) is the dtype the skinny channel sums
are taken in.  PyTorch's reductions accumulate bf16 in f32 inside the kernel whatever the
dtype they write, so "compute" changes the dtype of the reduction's output (no full-size
f32 intermediate), not its accumulation; the reference's XLA:CPU accumulates such a bf16
sum in bf16.
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The GEMM accumulator of inputs of `dtype`: f64 for f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def stats_dtype(dtype: torch.dtype, stats: str) -> torch.dtype:
    """The dtype a statistic of `dtype` inputs is taken in: `dtype` itself under
    "compute", else ``acc_dtype``."""
    return dtype if stats == "compute" else acc_dtype(dtype)


def _same_pad(x: torch.Tensor, kernel) -> torch.Tensor:
    """x padded for a SAME conv with the odd `kernel` (k // 2 zeros at each end)."""
    kd, kh, kw = kernel
    return F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kd // 2, kd // 2))


def _offsets(kernel):
    return itertools.product(*(range(k) for k in kernel))


def conv_1x1(x: torch.Tensor, w: torch.Tensor, stats: str = "f32") -> torch.Tensor:
    """The 1x1x1 conv of the GEMM formulation: C, F <= 32 as a broadcast multiply and a
    channel sum in ``stats_dtype`` (C = 1: the product alone), else a channel GEMM
    accumulated in ``acc_dtype``; rounded once to x's dtype."""
    n, c = x.shape[:2]
    spatial = x.shape[2:]
    t = math.prod(spatial)
    f = w.shape[-1]
    w2 = w.reshape(c, f).to(x.dtype)
    if c <= 32 and f <= 32:
        if c == 1:
            return (x.reshape(n, 1, t) * w2.reshape(1, f, 1)).reshape(n, f, *spatial)
        y = torch.sum(x.reshape(n, c, 1, t) * w2.reshape(1, c, f, 1), dim=1,
                      dtype=stats_dtype(x.dtype, stats))
        return y.to(x.dtype).reshape(n, f, *spatial)
    acc = acc_dtype(x.dtype)
    y = torch.einsum("nct,cf->nft", x.reshape(n, c, t).to(acc), w2.to(acc))
    return y.to(x.dtype).reshape(n, f, *spatial)


def _term(xs: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """One offset's (N, C, DHW) x (C, F) GEMM, both operands cast to the accumulator."""
    acc = acc_dtype(xs.dtype)
    return torch.einsum("nct,cf->nft", xs.reshape(*xs.shape[:2], -1).to(acc), wk.to(acc))


def shifted_gemm(x: torch.Tensor, w: torch.Tensor, stats: str = "f32") -> torch.Tensor:
    """SAME stride-1 conv of x (N, C, D, H, W) with the odd kernel w (kd, kh, kw, C, F) of
    x's dtype as a sum of per-offset channel GEMMs into one f32 (f64) accumulator."""
    n, c, d, h, wd = x.shape
    kernel = tuple(int(k) for k in w.shape[:3])
    f = w.shape[-1]
    if math.prod(kernel) == 1:
        return conv_1x1(x, w, stats)
    xp = _same_pad(x, kernel)
    w_flat = w.reshape(-1, c, f)
    recorded = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    acc = None
    for o, (i, j, k) in enumerate(_offsets(kernel)):
        xs = xp[:, :, i:i + d, j:j + h, k:k + wd]
        term = (checkpoint(_term, xs, w_flat[o], use_reentrant=False) if recorded
                else _term(xs, w_flat[o]))
        acc = term if acc is None else acc + term
    return acc.to(x.dtype).reshape(n, f, d, h, wd)


def wgrad_mulsum_1x1(x: torch.Tensor, dy: torch.Tensor, stats: str = "f32") -> torch.Tensor:
    """The 1x1x1 weight gradient dw[c, f] = sum_{n, s} x[n, c, s] dy[n, f, s] as a
    broadcast multiply (rounded to x's dtype) and a sum in ``stats_dtype``, shaped
    (1, 1, 1, C, F)."""
    n, c = x.shape[:2]
    f = dy.shape[1]
    t = math.prod(x.shape[2:])
    dw = torch.sum(x.reshape(n, c, 1, t) * dy.reshape(n, 1, f, t), dim=(0, 3),
                   dtype=stats_dtype(x.dtype, stats))
    return dw.to(x.dtype).reshape(1, 1, 1, c, f)


def wgrad_einsum(x: torch.Tensor, dy: torch.Tensor, kernel: Tuple[int, int, int]) -> torch.Tensor:
    """dw (kd, kh, kw, C, F) as one (C, NDHW) x (NDHW, F) GEMM per kernel offset in
    ``acc_dtype``, rounded once to x's dtype."""
    n, c, d, h, wd = x.shape
    acc = acc_dtype(x.dtype)
    xp = _same_pad(x, kernel)
    dya = dy.to(acc)
    rows = [torch.einsum("ncdhw,nfdhw->cf", xp[:, :, i:i + d, j:j + h, k:k + wd].to(acc), dya)
            for i, j, k in _offsets(kernel)]
    return torch.stack(rows).reshape(*kernel, c, dy.shape[1]).to(x.dtype)


def wgrad_library(x: torch.Tensor, dy: torch.Tensor,
                  kernel: Tuple[int, int, int]) -> torch.Tensor:
    """dw (kd, kh, kw, C, F) of the odd `kernel`: the library conv's weight gradient in x's
    dtype (deterministic under the step's cuDNN flags)."""
    pads = [k // 2 for k in kernel]
    shape = dy.new_empty(1).expand(dy.shape[1], x.shape[1], *kernel)  # only its shape
    _, gw, _ = torch.ops.aten.convolution_backward(
        dy, x, shape, None, [1, 1, 1], pads, [1, 1, 1], False, [0, 0, 0], 1,
        [False, True, False])
    return gw.permute(2, 3, 4, 1, 0).contiguous()
