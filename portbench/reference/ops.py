"""Plain PyTorch ops of the reference models, in float32 unless a rounding is given.

Weights keep the layout ``(*kernel, in, out)`` and are stored N(0, 1): they are scaled at
use by ``gain / sqrt(fan_in)`` (equalized learning rate, times ``lrmul`` where a layer
has one).  Activations are NCDHW.

``Params`` reads one named tensor per call.  In shape mode (``Params.shapes()``) it
records each name and shape it is asked for and hands back a zero tensor on the meta
device, so one pass of a model lists its parameters without computing anything.

A 1x1x1 conv is the channel contraction it is (``einsum``, a matrix product).  A nearest
2x upscale followed by a SAME conv (the growing transition) is ``upconv``: one autograd
Function whose input and weight gradients are two more Functions, each differentiable
through the other two, so the gradient penalty's second order runs through them too (each
computes both gradients whenever both operands require one).  They run a few rows at a
time, so that no upscaled operand reaches 2^31 bytes (cuDNN's float32 kernels for larger
operands are an order of magnitude slower).  The counter of
``portbench/counts.py`` books each of the three as the polyphase conv it equals (2 taps
along a 3-tap axis); their numbers are plain convs over the upscaled volume.  A 1x1x1
transition is the contraction of the coarse volume, then the upscale.

``rounding`` (``Rounding``) rounds the forward values to a narrower float where the
program under test would round them (weights at use, each layer's output), and the
gradients flowing back through those points to another.  ``FP8`` is fp8 training's pair
(e4m3 forward, e5m2 backward, one scale a tensor): the lower-precision control of the
correctness check.  The reference itself runs without one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench import counting

def _quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` rounded to `dtype` and back to float32; an 8-bit float with one scale for the
    whole tensor (its largest magnitude mapped to the format's largest finite value), as
    fp8 training scales its tensors."""
    if dtype.itemsize > 1:
        return x.to(dtype).to(torch.float32)
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max, torch.ones_like(amax))
    return (x / scale).to(dtype).to(torch.float32) * scale


class _RoundFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, forward_dtype, backward_dtype):
        ctx.backward_dtype = backward_dtype
        return _quantize(x, forward_dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward_dtype is None:
            return g, None, None
        return _RoundFn.apply(g, ctx.backward_dtype, ctx.backward_dtype), None, None


class Rounding:
    """Round forward values to `dtype`, and the gradients flowing back through them to
    `backward_dtype` (None: passed straight through); a Rounding of None rounds nothing."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 backward_dtype: Optional[torch.dtype] = None):
        self.dtype = dtype
        self.backward_dtype = backward_dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None or x.device.type == "meta":
            return x
        return _RoundFn.apply(x, self.dtype, self.backward_dtype)


FP8 = dict(dtype=torch.float8_e4m3fn, backward_dtype=torch.float8_e5m2)  # fp8 training


NO_ROUNDING = Rounding(None)


class Params:
    """Named parameters; ``Params.shapes()`` records instead of reading."""

    def __init__(self, values: Optional[Dict[str, torch.Tensor]] = None):
        self.values = values
        self.recorded: Dict[str, Tuple[int, ...]] = {}

    @classmethod
    def shapes(cls) -> "Params":
        return cls(None)

    def __call__(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.values is None:
            self.recorded[name] = shape
            return torch.zeros(shape, device="meta")
        value = self.values[name]
        if tuple(value.shape) != shape:
            raise ValueError(f"{name}: have {tuple(value.shape)}, the model needs {shape}")
        return value


def gain(activation: str, leak: float) -> float:
    return 1.0 if activation == "linear" else math.sqrt(2.0 / (1.0 + leak ** 2))


def he_std(shape: Sequence[int], activation: str, leak: float, lrmul: float = 1.0) -> float:
    fan_in = 1
    for s in shape[:-1]:
        fan_in *= int(s)
    return gain(activation, leak) / math.sqrt(fan_in) * lrmul


def weight(p: Params, name: str, shape, activation: str, leak: float, lrmul: float = 1.0):
    return p(name, shape) * he_std(shape, activation, leak, lrmul)


def lrelu(x: torch.Tensor, leak: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * leak)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


def channel_bias(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x + b.reshape((1, -1) + (1,) * (x.ndim - 2))


def upscale(x: torch.Tensor) -> torch.Tensor:
    for axis in range(2, x.ndim):
        x = torch.repeat_interleave(x, 2, dim=axis)
    return x


def downscale(x: torch.Tensor) -> torch.Tensor:
    n, c, d, h, w = x.shape
    return x.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2).mean(dim=(3, 5, 7))


def _torch_w(w: torch.Tensor) -> torch.Tensor:
    return w.permute(4, 3, 0, 1, 2)


def _pad(kernel) -> list:
    return [int(k) // 2 for k in kernel]


def _is_1x1(w: torch.Tensor) -> bool:
    return all(int(k) == 1 for k in w.shape[:3])


def conv(x: torch.Tensor, w: torch.Tensor, rounding: Rounding = NO_ROUNDING) -> torch.Tensor:
    """SAME conv with w (*kernel, in, out); a 1x1x1 conv as the channel contraction it is
    (a matrix product over the channels of every voxel)."""
    if _is_1x1(w):
        return rounding(torch.einsum("ncdhw,co->nodhw", x, rounding(w)[0, 0, 0]))
    return rounding(F.conv3d(x, _torch_w(rounding(w)), padding=_pad(w.shape[:3])))


def dense(x: torch.Tensor, w: torch.Tensor, rounding: Rounding = NO_ROUNDING) -> torch.Tensor:
    return rounding(torch.matmul(x.reshape(x.shape[0], -1), rounding(w)))


def _pool_sum(u: torch.Tensor) -> torch.Tensor:
    n, c, d, h, w = u.shape
    return u.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2).sum(dim=(3, 5, 7))


INDEX_LIMIT = 2 ** 31  # bytes: larger operands send cuDNN to its 64-bit-index kernels


def _row_chunks(x: torch.Tensor, channels: int) -> int:
    """Rows of `x` a chunk holds so that its upscaled volume with `channels` channels stays
    under ``INDEX_LIMIT`` bytes (the convs run per row, so the chunks are exact)."""
    fine = 8 * x[0, 0].numel() * channels * x.element_size()
    return max(1, (INDEX_LIMIT - 1) // max(1, fine))


class _UpConv(torch.autograd.Function):
    """T(x, w) = conv(upscale(x), w)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with counting.transition("transition", x, w):
            rows = _row_chunks(x, max(x.shape[1], w.shape[-1]))
            return torch.cat([F.conv3d(upscale(part), _torch_w(w), padding=_pad(w.shape[:3]))
                              for part in x.split(rows)])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = _UpConvInput.apply(gy, w) if ctx.needs_input_grad[0] else None
        gw = _UpConvWeight.apply(x, gy, w) if ctx.needs_input_grad[1] else None
        return gx, gw


class _UpConvInput(torch.autograd.Function):
    """D(gy, w): the gradient of T with respect to x (its adjoint in x)."""

    @staticmethod
    def forward(ctx, gy, w):
        ctx.save_for_backward(gy, w)
        with counting.transition("transition_dgrad", gy, w):
            rows = _row_chunks(gy[:, :, ::2, ::2, ::2], max(gy.shape[1], w.shape[-2]))
            return torch.cat([_pool_sum(F.conv_transpose3d(part, _torch_w(w),
                                                           padding=_pad(w.shape[:3])))
                              for part in gy.split(rows)])

    @staticmethod
    def backward(ctx, c):
        gy, w = ctx.saved_tensors
        g_gy = _UpConv.apply(c, w) if ctx.needs_input_grad[0] else None
        g_w = _UpConvWeight.apply(c, gy, w) if ctx.needs_input_grad[1] else None
        return g_gy, g_w


class _UpConvWeight(torch.autograd.Function):
    """W(x, gy): the gradient of T with respect to w (`like` gives w's shape)."""

    @staticmethod
    def forward(ctx, x, gy, like):
        ctx.save_for_backward(x, gy)
        with counting.transition("transition_wgrad", x, like):
            rows = _row_chunks(x, max(x.shape[1], gy.shape[1]))
            gw = sum(torch.nn.grad.conv3d_weight(upscale(xp), tuple(_torch_w(like).shape), gp,
                                                 padding=_pad(like.shape[:3]))
                     for xp, gp in zip(x.split(rows), gy.split(rows)))
        return gw.permute(2, 3, 4, 1, 0)

    @staticmethod
    def backward(ctx, c):
        x, gy = ctx.saved_tensors
        g_x = _UpConvInput.apply(gy, c) if ctx.needs_input_grad[0] else None
        g_gy = _UpConv.apply(x, c) if ctx.needs_input_grad[1] else None
        return g_x, g_gy, None


def upconv(x: torch.Tensor, w: torch.Tensor, rounding: Rounding = NO_ROUNDING) -> torch.Tensor:
    """conv(upscale(x), w): the growing transition, nearest 2x then a SAME conv; for a
    1x1x1 kernel the conv of the coarse volume, upscaled (the same numbers)."""
    if _is_1x1(w):
        return upscale(conv(x, w, rounding))
    return rounding(_UpConv.apply(x, rounding(w)))


def minibatch_stddev(x: torch.Tensor, group_size: int = 4) -> torch.Tensor:
    """One more channel: the stddev over groups strided across the batch (sample n in
    the group of n mod N/G), averaged over channels and voxels."""
    n = x.shape[0]
    g = min(group_size, n)
    y = x.reshape(g, n // g, *x.shape[1:])
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(torch.mean(y * y, dim=0) + 1e-8)
    y = y.mean(dim=tuple(range(1, y.ndim)), keepdim=True)  # (N/G, 1, 1, 1, 1)
    y = y.unsqueeze(0).expand(g, n // g, 1, *x.shape[2:]).reshape(n, 1, *x.shape[2:])
    return torch.cat([x, y], dim=1)


def adaptive_kernel(spatial) -> list:
    return [1 if int(s) < 3 else 3 for s in spatial]

