"""Fused bias + leaky ReLU + pixel norm: the Triton kernel, its plain version and the
``autograd.Function`` the generator calls.

Replaces ``saragan_tpu/ops/pallas_kernels.py::fused_bias_act_pixelnorm`` (Pallas body
``_fused_kernel``, custom JVP ``_fused_jvp``), which follows every generator conv:

    y = lrelu(x + b, alpha);  y = y * rsqrt(mean_c(y^2) + 1e-8)   per voxel

What bounds it on the H100: about one operation per byte, so device memory.  The kernel
reads x once and writes y once.  Program (n, j) loads a (BLOCK_C, BLOCK_S) tile that
holds every channel of BLOCK_S voxels; the tile strides C by S, so each channel's row is
a contiguous, coalesced run of voxels, and the channel reduction stays in registers.
BLOCK_C * BLOCK_S is kept near 8K elements (C=256 at 4x4 voxels up to C=16 at 524,288).

Rounding, as the reference settles it: the primal is the kernel's, everything in f32
(the f32 bias unrounded) and one rounding to x.dtype at the store;
``bias_act_pixelnorm_plain`` computes the same in torch ops.  The gradient is the VJP of
the reference's unfused oracle (``pallas_kernels.py:100-108``, here ``_oracle``), which
adds the bias and applies the leaky ReLU in x.dtype and takes the pixel-norm statistics
in f32, recomputed from the inputs.  In f32 the two are the same function.

``FusedBiasActPixelnorm`` is that pairing.  Its backward is torch ops (as the
reference's tangent is jnp) and records a graph when the caller asks for one
(``create_graph``), so the op is differentiable to any order.  The kernel wrapper
``fused_bias_act_pixelnorm`` builds no graph itself; ``bias_act_pixelnorm`` applies the
Function, whose forward launches the kernel for a CUDA tensor and runs the plain version
for a CPU (or shape-only meta) tensor.
"""

from __future__ import annotations

import functools

import torch

from saragan_tpu_torch.ops.core import in_dtype

_TILE_ELEMS = 8192


def _oracle(x: torch.Tensor, b: torch.Tensor, alpha_lr: float, pixelnorm: bool,
            eps: float = 1e-8) -> torch.Tensor:
    """The reference's unfused math (``_reference_forward``): bias and leaky ReLU in
    x.dtype, pixel-norm statistics in f32; differentiable torch ops."""
    y = x + b.reshape((1, -1) + (1,) * (x.ndim - 2)).to(x.dtype)
    y = torch.where(y >= 0, y, y * in_dtype(alpha_lr, x.dtype))
    if pixelnorm:
        y32 = y.float()
        m = torch.mean(torch.square(y32), dim=1, keepdim=True)
        y = (y32 * torch.rsqrt(m + eps)).to(x.dtype)
    return y


def bias_act_pixelnorm_plain(x: torch.Tensor, b: torch.Tensor, alpha_lr: float,
                             pixelnorm: bool, eps: float = 1e-8) -> torch.Tensor:
    """The kernel's math in torch ops: f32 throughout, one rounding to x.dtype."""
    bias_act_pixelnorm_plain.calls += 1
    y = x.float() + b.float().reshape((1, -1) + (1,) * (x.ndim - 2))
    y = torch.where(y >= 0, y, y * alpha_lr)
    if pixelnorm:
        m = torch.mean(torch.square(y), dim=1, keepdim=True)
        y = y * torch.rsqrt(m + eps)
    return y.to(x.dtype)


bias_act_pixelnorm_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def fused_kernel(x_ptr, b_ptr, y_ptr, C, S, alpha, eps,
                     PIXELNORM: tl.constexpr, BLOCK_C: tl.constexpr, BLOCK_S: tl.constexpr):
        n = tl.program_id(0)
        sb = tl.program_id(1)
        offs_c = tl.arange(0, BLOCK_C)
        offs_s = sb * BLOCK_S + tl.arange(0, BLOCK_S)
        mask_c = offs_c < C
        mask = mask_c[:, None] & (offs_s < S)[None, :]
        offs = n.to(tl.int64) * C * S + offs_c[:, None].to(tl.int64) * S + offs_s[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + offs_c, mask=mask_c, other=0.0).to(tl.float32)
        y = x + b[:, None]
        y = tl.where(y >= 0, y, y * alpha)
        if PIXELNORM:
            # masked channels and voxels hold 0 and add nothing to the sum
            m = tl.sum(y * y, axis=0) / C
            y = y * tl.rsqrt(m + eps)[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return fused_kernel


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def fused_bias_act_pixelnorm(x: torch.Tensor, b: torch.Tensor, alpha_lr: float,
                             pixelnorm: bool, eps: float = 1e-8) -> torch.Tensor:
    """Launch the Triton kernel: x (N, C, *spatial) contiguous on a CUDA device, b (C,)
    (read in f32, unrounded, whatever x's dtype)."""
    if not (x.is_cuda and b.is_cuda and x.device == b.device):
        raise ValueError(f"fused_bias_act_pixelnorm needs x and b on one CUDA device; got "
                         f"{x.device} and {b.device}")
    if x.ndim < 3 or b.shape != (x.shape[1],):
        raise ValueError(f"x must be (N, C, *spatial) and b (C,); got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_bias_act_pixelnorm needs a contiguous x")
    if torch.is_grad_enabled() and (x.requires_grad or b.requires_grad):
        raise NotImplementedError("fused_bias_act_pixelnorm builds no autograd graph: "
                                  "differentiate through FusedBiasActPixelnorm")
    n, c = x.shape[:2]
    s = x[0, 0].numel()
    b = b.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    block_c = _next_pow2(c)
    block_s = max(16, min(_next_pow2(s), _TILE_ELEMS // block_c))
    grid = (n, -(-s // block_s))
    _triton_kernel()[grid](x, b, y, c, s, float(alpha_lr), float(eps),
                           PIXELNORM=bool(pixelnorm), BLOCK_C=block_c, BLOCK_S=block_s,
                           num_warps=8 if block_c * block_s >= 4096 else 4)
    fused_bias_act_pixelnorm.launches += 1
    return y


fused_bias_act_pixelnorm.launches = 0


class FusedBiasActPixelnorm(torch.autograd.Function):
    """Primal from the kernel (or, on the CPU, its plain version); gradient from the VJP
    of the reference's oracle, recomputed from the inputs and differentiable again when
    the backward runs under ``create_graph``."""

    @staticmethod
    def forward(ctx, x, b, alpha_lr, pixelnorm):
        # the inputs themselves are saved, so a graph recorded in the backward reaches
        # their history; the kernel gets a contiguous copy where needed
        ctx.save_for_backward(x, b)
        ctx.alpha_lr, ctx.pixelnorm = alpha_lr, pixelnorm
        x = x.contiguous()
        if x.is_cuda:
            return fused_bias_act_pixelnorm(x, b, alpha_lr, pixelnorm)
        if x.device.type in ("cpu", "meta"):
            return bias_act_pixelnorm_plain(x, b, alpha_lr, pixelnorm)
        raise ValueError(f"bias_act_pixelnorm has no path for device {x.device}")

    @staticmethod
    def backward(ctx, gy):
        x, b = ctx.saved_tensors
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            # under create_graph the saved inputs keep their history, so the gradient
            # stays a function of them; otherwise a local graph is enough
            xs = x if create and x.requires_grad else x.detach().requires_grad_(True)
            bs = b if create and b.requires_grad else b.detach().requires_grad_(True)
            y = _oracle(xs, bs, ctx.alpha_lr, ctx.pixelnorm)
            gx, gb = torch.autograd.grad(y, (xs, bs), gy, create_graph=create)
        return (gx if ctx.needs_input_grad[0] else None,
                gb if ctx.needs_input_grad[1] else None, None, None)


def bias_act_pixelnorm(x: torch.Tensor, b: torch.Tensor, alpha_lr: float = 0.2,
                       pixelnorm: bool = True) -> torch.Tensor:
    """The fused op with its gradient: the kernel for CUDA tensors, the plain version for
    CPU and meta tensors."""
    return FusedBiasActPixelnorm.apply(x, b, float(alpha_lr), bool(pixelnorm))
