"""Functional op library of the port (counterpart of ``saragan_tpu/ops/core.py``).

Plain functions on tensors over explicit parameters (``Scope``).  Activations are NC(D)HW
and conv weights keep the reference's ``(*kernel, in, out)`` layout; they are permuted to
PyTorch's ``(out, in, *kernel)`` only at use.  Ops are rank-generic: the spatial rank
comes from ``x.ndim``.

The conv engine is an explicit argument, never a module global:

* ``direct``: ``F.conv3d`` / ``F.conv2d`` with SAME padding (the reference's serving
  default, a library conv outside any kernel of ours);
* ``flat``: the hand-written CUDA kernels of ``ops/conv3d_flat.py`` for every 3-D kernel
  that is not 1x1x1 (the reference's ``pallas`` engine), through the derivative algebra
  of ``ops/conv3d_grad.py``, so forward, dgrad and wgrad (and the penalty's second-order
  terms) all run on them; for 1x1x1 the mul-sum / channel-GEMM path of the reference's
  ``_conv3d_shifted_gemm``, differentiated by autograd.

bf16: an op rounds where the reference's rounds.  A Python constant that meets an
activation (a leaky-ReLU slope, an epsilon, a blend factor) is first rounded to the
activation's dtype, as ``jnp.asarray(c, x.dtype)`` does there.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch.core import Scope, normal_initializer, zeros_initializer
from saragan_tpu_torch.ops.conv3d_grad import conv3d_c

CONV_ENGINES = ("direct", "flat")


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (a Python float): multiplying a tensor of that dtype by
    it then rounds once, as the reference's product of two `dtype` operands does."""
    return float(torch.tensor(value, dtype=dtype))


def calculate_gain(activation: str, param=None) -> float:
    """He-init gain of the activations ``act`` applies."""
    if activation == "linear":
        return 1.0
    if activation == "leaky_relu":
        if isinstance(param, bool) or not isinstance(param, (int, float)):
            raise ValueError(f"negative_slope {param} not a valid number")
        return math.sqrt(2.0 / (1 + param**2))
    raise ValueError(f"Unsupported nonlinearity {activation}")


def get_weight(scope: Scope, shape: Sequence[int], activation: str, lrmul: float = 1.0,
               use_eq_lr: bool = True, param=None, name: str = "weight") -> torch.Tensor:
    """Equalized-learning-rate weight: stored N(0, 1/lrmul), scaled at use by
    he_std * lrmul."""
    fan_in = int(np.prod(shape[:-1]))
    he_std = calculate_gain(activation, param) / math.sqrt(fan_in)
    w = scope.get(name, shape, normal_initializer(1.0 / lrmul))
    if use_eq_lr:
        w = w * (he_std * lrmul)
    return w


def apply_bias(scope: Scope, x: torch.Tensor, lrmul: float = 1.0) -> torch.Tensor:
    """Channel bias on axis 1."""
    b = (scope.get("bias", (x.shape[1],), zeros_initializer()) * lrmul).to(x.dtype)
    if x.ndim == 2:
        return x + b
    return x + b.reshape((1, -1) + (1,) * (x.ndim - 2))


def dense(scope: Scope, x: torch.Tensor, fmaps: int, activation: str, lrmul: float = 1.0,
          param=None) -> torch.Tensor:
    """Fully connected layer without bias."""
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    w = get_weight(scope, (x.shape[1], fmaps), activation, lrmul=lrmul, param=param)
    return torch.matmul(x, w.to(x.dtype))


def _torch_weight(w: torch.Tensor) -> torch.Tensor:
    """(*kernel, in, out) -> (out, in, *kernel)."""
    r = w.ndim - 2
    return w.permute(r + 1, r, *range(r))


def _conv_direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    conv = {2: F.conv2d, 3: F.conv3d}[x.ndim - 2]
    return conv(x, _torch_weight(w).to(x.dtype), padding="same")


def _conv3d_1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1x1 conv of the flat engine (reference ``_conv3d_shifted_gemm``): skinny
    channel counts as a broadcast multiply plus an f32 channel sum, else a channel GEMM
    accumulated in f32."""
    n, c, d, h, wd = x.shape
    f = w.shape[-1]
    t = d * h * wd
    w2 = w.reshape(c, f).to(x.dtype)
    if c <= 32 and f <= 32:
        if c == 1:
            y = x.reshape(n, 1, t) * w2.reshape(1, f, 1)
            return y.reshape(n, f, d, h, wd)
        y = torch.sum(x.reshape(n, c, 1, t) * w2.reshape(1, c, f, 1), dim=1,
                      dtype=torch.float32)
        return y.to(x.dtype).reshape(n, f, d, h, wd)
    y = torch.einsum("nct,cf->nft", x.reshape(n, c, t).float(), w2.float())
    return y.to(x.dtype).reshape(n, f, d, h, wd)


def conv_apply(x: torch.Tensor, w: torch.Tensor, engine: str = "direct") -> torch.Tensor:
    """SAME stride-1 conv on explicit (*kernel, in, out) weights."""
    if engine not in CONV_ENGINES:
        raise ValueError(f"conv engine {engine!r} not in {CONV_ENGINES}")
    if engine == "flat" and x.ndim == 5:
        if w.shape[0] * w.shape[1] * w.shape[2] == 1:
            return _conv3d_1x1(x, w)
        return conv3d_c(x, w.to(x.dtype))
    return _conv_direct(x, w)


def conv(scope: Scope, x: torch.Tensor, fmaps: int, kernel: Sequence[int], activation: str,
         param=None, lrmul: float = 1.0, engine: str = "direct") -> torch.Tensor:
    """SAME conv over NC(D)HW with (*kernel, in, out) weights."""
    kernel = tuple(int(k) for k in kernel)
    if len(kernel) != x.ndim - 2:
        raise ValueError(f"kernel {kernel} does not match input {tuple(x.shape)}")
    w = get_weight(scope, (*kernel, x.shape[1], fmaps), activation, param=param, lrmul=lrmul)
    return conv_apply(x, w.to(x.dtype), engine)


def leaky_relu(x: torch.Tensor, alpha_lr: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * in_dtype(alpha_lr, x.dtype))


def act(x: torch.Tensor, activation: str, param=None) -> torch.Tensor:
    if activation == "leaky_relu":
        if param is None:
            raise ValueError("leaky_relu needs its negative slope")
        return leaky_relu(x, alpha_lr=param)
    if activation == "linear":
        return x
    raise ValueError(f"Unknown activation {activation}")


def avg_unpool(x: torch.Tensor, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Nearest-neighbour upsampling of all spatial axes."""
    if gain != 1:
        x = x * gain
    if factor == 1:
        return x
    for axis in range(2, x.ndim):
        x = torch.repeat_interleave(x, factor, dim=axis)
    return x


def upscale(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return avg_unpool(x, factor)


def _phase_taps(k: int):
    """For one axis of conv(repeat(x), w) with odd kernel size k: per output phase p
    (fine index 2q + p), the first coarse offset j0 and, per phase tap i, the kernel
    taps that read the same coarse voxel x[q + j0 + i]."""
    h = k // 2
    taps = []
    for p in (0, 1):
        j0 = (p - h) // 2
        groups = [[] for _ in range((p + k - 1 - h) // 2 - j0 + 1)]
        for dz in range(k):
            groups[(p + dz - h) // 2 - j0].append(dz)
        taps.append((j0, groups))
    return taps


def _sum_taps(w: torch.Tensor, axis: int, groups) -> torch.Tensor:
    """Phase kernel along `axis`: tap i is the sum of w's taps in groups[i].  Slices and
    adds on w's device, so preparing the kernels never waits for the device."""
    out = []
    for g in groups:
        t = w.select(axis, g[0])
        for dz in g[1:]:
            t = t + w.select(axis, dz)
        out.append(t)
    return torch.stack(out, dim=axis)


def upscale_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv(repeat(x), w) for nearest 2x upscaling and a SAME conv with odd kernel w,
    without materializing the upscaled activation (the reference's exact fusion).

    Polyphase form: output phase (p_1..p_r) of the fine grid is a stride-1 valid conv
    of the coarse x with that phase's kernel, whose taps are sums of w's taps that read
    the same coarse voxel (2 per dim for k=3, 1 for k=1).  So 2^r library convs do the
    minimal multiply-adds, through cuDNN's deterministic forward algorithms.  The
    equivalent stride-2 transposed conv runs cuDNN's deterministic dgrad, which is an
    order of magnitude slower at the phase-6 serving shapes on an H100
    (``tools/profile_serving.py`` compares the two)."""
    r = x.ndim - 2
    conv = {2: F.conv2d, 3: F.conv3d}[r]
    spatial = x.shape[2:]
    taps = [_phase_taps(int(k)) for k in w.shape[:r]]
    # one symmetric padding serves both phases of an axis: each phase's output is a
    # window of the padded conv's, so the input is never sliced (or copied)
    pad = [max(max(-j0, j0 + len(g) - 1) for j0, g in t) for t in taps]
    # along an axis of kernel size 1 both phases have the same taps: one conv for both
    groups = [[(0, 1)] if k == 1 else [(0,), (1,)] for k in w.shape[:r]]
    out = x.new_empty((x.shape[0], w.shape[-1], *(2 * s for s in spatial)))
    for combo in itertools.product(*groups):
        wk = w
        for a, ps in enumerate(combo):
            wk = _sum_taps(wk, a, taps[a][ps[0]][1])
        y = conv(x, _torch_weight(wk).to(x.dtype), padding=tuple(pad))
        for phases in itertools.product(*combo):
            src = [slice(taps[a][p][0] + pad[a], taps[a][p][0] + pad[a] + spatial[a])
                   for a, p in enumerate(phases)]
            dest = [slice(p, None, 2) for p in phases]
            out[(slice(None), slice(None), *dest)] = y[(slice(None), slice(None), *src)]
    return out


def avg_pool(x: torch.Tensor, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Average pooling of all spatial axes (stride = window = factor), as reshape + mean;
    the mean accumulates in f32 and rounds once to x.dtype, as the reference's jnp.mean
    does for bf16."""
    if gain != 1:
        x = x * gain
    if factor == 1:
        return x
    spatial = x.shape[2:]
    if any(s % factor for s in spatial):
        raise ValueError(f"avg_pool factor {factor} does not divide {tuple(x.shape)}")
    split = [v for s in spatial for v in (s // factor, factor)]
    axes = tuple(3 + 2 * i for i in range(len(spatial)))
    y = x.reshape(*x.shape[:2], *split)
    if x.dtype == torch.float64:
        return y.mean(dim=axes)
    return y.mean(dim=axes, dtype=torch.float32).to(x.dtype)


def downscale(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return avg_pool(x, factor)


def pixel_norm(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Per-voxel channel normalization, rounded where the reference rounds
    (``saragan_tpu/ops/core.py:842-844``): x² in x.dtype, the channel mean accumulated in
    f32 and returned in x.dtype, epsilon added in x.dtype, the rsqrt taken in x.dtype."""
    sq = torch.square(x)
    m = sq.mean(dim=1, keepdim=True) if x.dtype == torch.float64 else \
        sq.mean(dim=1, keepdim=True, dtype=torch.float32).to(x.dtype)
    return x * torch.rsqrt(m + in_dtype(epsilon, x.dtype))


def to_rgb(scope: Scope, x: torch.Tensor, channels: int = 1,
           engine: str = "direct") -> torch.Tensor:
    """1x1(x1) linear projection to image channels."""
    kernel = (1,) * (x.ndim - 2)
    return apply_bias(scope, conv(scope, x, channels, kernel, activation="linear",
                                  engine=engine))


def from_rgb(scope: Scope, x: torch.Tensor, filters_out: int, activation: str, param=None,
             engine: str = "direct") -> torch.Tensor:
    """1x1(x1) lift from image channels, then bias and activation."""
    kernel = (1,) * (x.ndim - 2)
    x = conv(scope, x, filters_out, kernel, activation, param, engine=engine)
    x = apply_bias(scope, x)
    return act(x, activation, param=param)


def get_kernel(x_shape: Sequence[int], desired_k_shape: Sequence[int]) -> list:
    """Shrink a desired kernel to the largest odd kernel fitting x."""
    if len(x_shape) != len(desired_k_shape):
        raise ValueError(f"shape {x_shape} and kernel {desired_k_shape} differ in rank")
    kernel = []
    for x_i, k_i in zip(x_shape, desired_k_shape):
        if x_i < k_i:
            kernel.append(x_i - 1 if x_i % 2 == 0 else x_i)
        else:
            kernel.append(k_i)
    return kernel


_FILTER_LISTS_3D = {
    "xxs": [256, 256, 64, 32, 16, 8, 4, 2],
    "xs": [256, 256, 64, 64, 32, 16, 8, 4],
    "s": [512, 512, 128, 128, 64, 32, 16, 8],
    "m": [1024, 1024, 256, 256, 128, 64, 32, 16],
    "l": [2048, 2048, 512, 512, 256, 128, 64, 32],
    "xl": [4096, 4096, 1024, 1024, 512, 256, 128, 64],
    "xxl": [8192, 8192, 2048, 1024, 1024, 512, 256, 128],
}


def num_filters(phase: int, num_phases: int, base_shape: Sequence[int],
                base_dim: Optional[int] = None, size: Optional[str] = None) -> int:
    """Voxel-count-based filter sizing: the phase's voxel count snapped to the nearest
    reference point of the 8-entry tables."""
    if size not in _FILTER_LISTS_3D:
        raise ValueError(f"Unknown size: {size}")
    filter_list = _FILTER_LISTS_3D[size]
    current_dim = [2 ** (phase - 1) * dim for dim in base_shape[1:]]
    log_product = np.log2(np.prod(current_dim))
    reference_log = np.array([4 + n * 3 for n in range(7)])
    return filter_list[int(np.argmin(np.abs(reference_log - log_product)))]


_FILTER_LISTS_2D = {
    "xxs": [64, 64, 64, 64, 64, 64, 64, 64, 32, 16, 8, 4, 2],
    "xs": [128, 128, 128, 128, 128, 128, 128, 128, 64, 32, 16, 8, 4],
    "s": [256, 256, 256, 256, 256, 256, 256, 256, 128, 64, 32, 16, 8],
    "m": [512, 512, 512, 512, 512, 512, 512, 512, 256, 128, 64, 32, 16],
    "l": [512, 512, 512, 512, 512, 512, 512, 512, 512, 256, 128, 64, 32],
    "xl": [1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 512, 256, 128, 64],
    "xxl": [2048, 2048, 2048, 2048, 2048, 2048, 2048, 2048, 2048, 1024, 512, 256, 128],
}


def num_filters_2d(phase: int, num_phases: int, base_dim=None,
                   size: Optional[str] = None) -> int:
    """2D filter sizing."""
    if size not in _FILTER_LISTS_2D:
        raise ValueError(f"Unknown size: {size}")
    return _FILTER_LISTS_2D[size][-num_phases:][phase - 1]
