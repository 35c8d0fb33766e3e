"""Fused bias + leaky ReLU + pixel norm: the Triton kernels (forward and backward), their
plain versions and the ``autograd.Function``s the generator calls.

Replaces ``saragan_tpu/ops/pallas_kernels.py::fused_bias_act_pixelnorm`` (Pallas body
``_fused_kernel``, custom JVP ``_fused_jvp``), which follows every generator conv:

    y = lrelu(x + b, alpha);  y = y * rsqrt(mean_c(y^2) + 1e-8)   per voxel

What bounds both kernels on the H100: a few operations per byte, so device memory.  The
forward reads x once and writes y once.  Program (n, j) loads a (BLOCK_C, BLOCK_S) tile
that holds every channel of BLOCK_S voxels; the tile strides C by S, so each channel's
row is a contiguous, coalesced run of voxels, and the channel reduction stays in
registers.  BLOCK_C * BLOCK_S is kept near 8K elements (C=256 at 4x4 voxels up to C=16 at
524,288).

Rounding, as the reference settles it: the primal is the kernel's, everything in f32
(the f32 bias unrounded) and one rounding to x.dtype at the store;
``bias_act_pixelnorm_plain`` computes the same in torch ops.  The gradient is the VJP of
the reference's unfused oracle (``pallas_kernels.py:100-108``, here ``_oracle``), which
adds the bias and applies the leaky ReLU in x.dtype and takes the pixel-norm statistics
in f32, recomputed from the inputs.  In f32 the two are the same function.  Per voxel,
with u = x + b and a = lrelu(u) in x.dtype, g = gy in f32:

    r = rsqrt(mean_c a^2 + 1e-8),  s = sum_c g a,  ga = r g - a r^3 s / C  (to x.dtype)
    gx = where(u >= 0, ga, ga * alpha)  (x.dtype),   gb = sum_{n, voxels} gx

The backward kernel computes that closed form in one pass over x and gy (the same tile as
the forward, statistics recomputed in registers), writes gx, and writes each program's
per-channel sums of gx to a workspace; a second launch adds the workspace rows in a fixed
order into gb, with no atomics.  gb is accumulated in f64, rounded to f32 and then through
x.dtype, as the oracle's is (it adds the bias in x.dtype), by the kernel and by its plain
version ``bias_act_pixelnorm_grad_plain`` alike, so their sums agree whatever order each
takes.  Two launches per call where the VJP of the oracle in
torch ops took about twenty.

``FusedBiasActPixelnorm`` pairs the forward kernel with ``FusedBiasActPixelnormGrad``,
whose forward is the backward kernel (its plain version on a CPU or meta tensor) and whose
own backward differentiates the closed form in torch ops, so the op is differentiable to
any order, as the reference's jnp tangent is.  The kernel wrappers build no graph
themselves; ``bias_act_pixelnorm`` applies the Function.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from saragan_tpu_torch.ops.core import in_dtype

_TILE_ELEMS = 8192       # forward tile: BLOCK_C * BLOCK_S
_GRAD_TILE_ELEMS = 4096  # backward tile: x, gy and their statistics live in registers
_GRAD_PROGRAMS = 1024    # backward programs to aim for over the batch
_BIAS_BLOCK_R = 32       # workspace rows per step of the gb pass


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


def _grad_closed_form(x: torch.Tensor, b: torch.Tensor, gy: torch.Tensor, alpha_lr: float,
                      pixelnorm: bool, eps: float = 1e-8):
    """(gx, gb), the VJP of ``_oracle`` at (x, b) for gy, in closed form with the
    oracle's rounding; differentiable torch ops."""
    dt = x.dtype
    alpha = in_dtype(alpha_lr, dt)
    u = x + b.reshape((1, -1) + (1,) * (x.ndim - 2)).to(dt)
    pos = u >= 0
    if pixelnorm:
        a = torch.where(pos, u, u * alpha).float()
        g = gy.float()
        r = torch.rsqrt(torch.mean(a * a, dim=1, keepdim=True) + eps)
        s = torch.sum(g * a, dim=1, keepdim=True)
        ga = (g * r - a * (r * r * r * s / x.shape[1])).to(dt)
    else:
        ga = gy.to(dt)
    gx = torch.where(pos, ga, ga * alpha)
    gb = gx.double().sum(dim=[0, *range(2, x.ndim)]).float().to(dt).to(b.dtype)
    return gx, gb


def bias_act_pixelnorm_grad_plain(x: torch.Tensor, b: torch.Tensor, gy: torch.Tensor,
                                  alpha_lr: float, pixelnorm: bool, eps: float = 1e-8):
    """The backward kernel's math in torch ops: (gx in x.dtype, gb)."""
    bias_act_pixelnorm_grad_plain.calls += 1
    return _grad_closed_form(x, b, gy, alpha_lr, pixelnorm, eps)


bias_act_pixelnorm_grad_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _triton_kernels():
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

    @triton.jit
    def fused_grad_kernel(x_ptr, b_ptr, gy_ptr, gx_ptr, ws_ptr, C, S, SB_PER_PROG, alpha, eps,
                          PIXELNORM: tl.constexpr, BLOCK_C: tl.constexpr,
                          BLOCK_S: tl.constexpr):
        # program (n, j): voxel blocks [j * SB_PER_PROG, (j + 1) * SB_PER_PROG) of sample n
        n = tl.program_id(0)
        j = tl.program_id(1)
        xdt = x_ptr.dtype.element_ty
        offs_c = tl.arange(0, BLOCK_C)
        mask_c = offs_c < C
        b = tl.load(b_ptr + offs_c, mask=mask_c, other=0.0).to(xdt).to(tl.float32)
        rows = n.to(tl.int64) * C * S + offs_c[:, None].to(tl.int64) * S
        part = tl.zeros((BLOCK_C,), tl.float64)
        for i in range(SB_PER_PROG):
            offs_s = (j * SB_PER_PROG + i) * BLOCK_S + tl.arange(0, BLOCK_S)
            mask = mask_c[:, None] & (offs_s < S)[None, :]
            offs = rows + offs_s[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(gy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            # bias and leaky ReLU rounded to x.dtype, as the oracle computes them
            u = (x + b[:, None]).to(xdt).to(tl.float32)
            pos = u >= 0
            if PIXELNORM:
                a = tl.where(pos, u, (u * alpha).to(xdt).to(tl.float32))
                r = tl.rsqrt(tl.sum(a * a, axis=0) / C + eps)
                s = tl.sum(g * a, axis=0)
                ga = g * r[None, :] - a * (r * r * r * s / C)[None, :]
            else:
                ga = g
            ga = ga.to(xdt).to(tl.float32)
            gx = tl.where(pos, ga, (ga * alpha).to(xdt).to(tl.float32))
            tl.store(gx_ptr + offs, gx.to(xdt), mask=mask)
            part += tl.sum(tl.where(mask, gx, 0.0).to(tl.float64), axis=1)
        tl.store(ws_ptr + (n * tl.num_programs(1) + j).to(tl.int64) * C + offs_c, part,
                 mask=mask_c)

    @triton.jit
    def fused_grad_bias_kernel(ws_ptr, x_ptr, gb_ptr, C, R, BLOCK_R: tl.constexpr,
                               BLOCK_C: tl.constexpr):
        # workspace rows 0..R-1 in order, BLOCK_R at a time: a fixed summation order;
        # x_ptr is read for its dtype only, through which the sum is rounded
        offs_c = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        mask_c = offs_c < C
        acc = tl.zeros((BLOCK_R, BLOCK_C), tl.float64)
        for start in range(0, R, BLOCK_R):
            offs_r = start + tl.arange(0, BLOCK_R)
            acc += tl.load(ws_ptr + offs_r[:, None].to(tl.int64) * C + offs_c[None, :],
                           mask=(offs_r < R)[:, None] & mask_c[None, :], other=0.0)
        gb = tl.sum(acc, axis=0).to(tl.float32).to(x_ptr.dtype.element_ty)
        tl.store(gb_ptr + offs_c, gb.to(tl.float32), mask=mask_c)

    return fused_kernel, fused_grad_kernel, fused_grad_bias_kernel


@functools.lru_cache(maxsize=None)
def _slope(alpha_lr: float, dtype: torch.dtype) -> float:
    """The leaky-ReLU slope rounded to `dtype` (``in_dtype``), once per pair."""
    return in_dtype(alpha_lr, dtype)


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


class _Tiles(NamedTuple):
    block_c: int
    block_s: int
    programs_s: int   # programs along the voxels of one sample
    sb_per_prog: int  # voxel blocks per program (backward)
    num_warps: int


@functools.lru_cache(maxsize=1024)
def _forward_tiles(c: int, s: int) -> _Tiles:
    block_c = _next_pow2(c)
    block_s = max(16, min(_next_pow2(s), _TILE_ELEMS // block_c))
    return _Tiles(block_c, block_s, -(-s // block_s), 1,
                  8 if block_c * block_s >= 4096 else 4)


@functools.lru_cache(maxsize=1024)
def _grad_tiles(n: int, c: int, s: int) -> _Tiles:
    """The backward's tile, and how many voxel blocks each program walks: enough
    programs to fill the card (``_GRAD_PROGRAMS`` over the batch), few workspace rows."""
    block_c = _next_pow2(c)
    block_s = max(16, min(_next_pow2(s), _GRAD_TILE_ELEMS // block_c))
    blocks = -(-s // block_s)
    want = max(1, min(blocks, -(-_GRAD_PROGRAMS // n)))
    per_prog = -(-blocks // want)
    return _Tiles(block_c, block_s, -(-blocks // per_prog), per_prog,
                  8 if block_c * block_s >= 4096 else 4)


def _check_operands(name: str, x: torch.Tensor, b: torch.Tensor, *rest: torch.Tensor):
    tensors = (x, b, *rest)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name} needs its operands on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if x.ndim < 3 or b.shape != (x.shape[1],):
        raise ValueError(f"x must be (N, C, *spatial) and b (C,); got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    if any(t.shape != x.shape or t.dtype != x.dtype for t in rest):
        raise ValueError(f"{name}: gy must have x's shape and dtype")
    if not all(t.is_contiguous() for t in (x, *rest)):
        raise ValueError(f"{name} needs contiguous operands")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} builds no autograd graph: differentiate through "
                                  f"FusedBiasActPixelnorm")


def fused_bias_act_pixelnorm(x: torch.Tensor, b: torch.Tensor, alpha_lr: float,
                             pixelnorm: bool, eps: float = 1e-8) -> torch.Tensor:
    """Launch the forward kernel: x (N, C, *spatial) contiguous on a CUDA device, b (C,)
    (read in f32, unrounded, whatever x's dtype)."""
    _check_operands("fused_bias_act_pixelnorm", x, b)
    n, c = x.shape[:2]
    s = x[0, 0].numel()
    t = _forward_tiles(c, s)
    y = torch.empty_like(x)
    _triton_kernels()[0][(n, t.programs_s)](
        x, b.to(torch.float32).contiguous(), y, c, s, float(alpha_lr), float(eps),
        PIXELNORM=bool(pixelnorm), BLOCK_C=t.block_c, BLOCK_S=t.block_s,
        num_warps=t.num_warps)
    fused_bias_act_pixelnorm.launches += 1
    return y


fused_bias_act_pixelnorm.launches = 0


def fused_bias_act_pixelnorm_grad(x: torch.Tensor, b: torch.Tensor, gy: torch.Tensor,
                                  alpha_lr: float, pixelnorm: bool, eps: float = 1e-8):
    """Launch the backward kernel and its gb pass: x and gy (N, C, *spatial) of one dtype,
    contiguous on a CUDA device, b (C,).  Returns (gx in x.dtype, gb in b.dtype: summed in
    f64, rounded through x.dtype).  Counts one launch per call."""
    _check_operands("fused_bias_act_pixelnorm_grad", x, b, gy)
    n, c = x.shape[:2]
    s = x[0, 0].numel()
    t = _grad_tiles(n, c, s)
    gx = torch.empty_like(x)
    rows = n * t.programs_s
    ws = torch.empty((rows, c), dtype=torch.float64, device=x.device)
    gb = torch.empty(c, dtype=torch.float32, device=x.device)
    _, grad, bias = _triton_kernels()
    grad[(n, t.programs_s)](x, b.to(torch.float32).contiguous(), gy, gx, ws, c, s,
                            t.sb_per_prog, _slope(float(alpha_lr), x.dtype), float(eps),
                            PIXELNORM=bool(pixelnorm), BLOCK_C=t.block_c, BLOCK_S=t.block_s,
                            num_warps=t.num_warps)
    block_c = min(t.block_c, 64)
    bias[(-(-c // block_c),)](ws, x, gb, c, rows, BLOCK_R=_BIAS_BLOCK_R, BLOCK_C=block_c,
                              num_warps=4)
    fused_bias_act_pixelnorm_grad.launches += 1
    return gx, gb.to(b.dtype)


fused_bias_act_pixelnorm_grad.launches = 0


def _device_path(name: str, x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type in ("cpu", "meta"):
        return "plain"
    raise ValueError(f"{name} has no path for device {x.device}")


class FusedBiasActPixelnorm(torch.autograd.Function):
    """Primal from the forward kernel (or, on the CPU, its plain version); gradient from
    ``FusedBiasActPixelnormGrad``, recomputed from the inputs and differentiable again
    when the backward runs under ``create_graph``."""

    @staticmethod
    def forward(ctx, x, b, alpha_lr, pixelnorm):
        # the inputs themselves are saved, so a graph recorded in the backward reaches
        # their history; the kernel gets a contiguous copy where needed
        ctx.save_for_backward(x, b)
        ctx.alpha_lr, ctx.pixelnorm = alpha_lr, pixelnorm
        x = x.contiguous()
        if _device_path("bias_act_pixelnorm", x) == "cuda":
            return fused_bias_act_pixelnorm(x, b, alpha_lr, pixelnorm)
        return bias_act_pixelnorm_plain(x, b, alpha_lr, pixelnorm)

    @staticmethod
    def backward(ctx, gy):
        x, b = ctx.saved_tensors
        gx, gb = FusedBiasActPixelnormGrad.apply(x, b, gy, ctx.alpha_lr, ctx.pixelnorm)
        return (gx if ctx.needs_input_grad[0] else None,
                gb if ctx.needs_input_grad[1] else None, None, None)


class FusedBiasActPixelnormGrad(torch.autograd.Function):
    """(x, b, gy) -> (gx, gb), the VJP of the oracle: the backward kernel for CUDA
    tensors, its plain version for CPU and meta tensors.  Its own backward differentiates
    the closed form in torch ops, recording a graph under ``create_graph``."""

    @staticmethod
    def forward(ctx, x, b, gy, alpha_lr, pixelnorm):
        ctx.save_for_backward(x, b, gy)
        ctx.alpha_lr, ctx.pixelnorm = alpha_lr, pixelnorm
        x, gy = x.contiguous(), gy.contiguous()
        if _device_path("bias_act_pixelnorm_grad", x) == "cuda":
            return fused_bias_act_pixelnorm_grad(x, b, gy, alpha_lr, pixelnorm)
        return bias_act_pixelnorm_grad_plain(x, b, gy, alpha_lr, pixelnorm)

    @staticmethod
    def backward(ctx, ggx, ggb):
        saved = ctx.saved_tensors
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            # under create_graph the saved inputs keep their history, so the gradient
            # stays a function of them; otherwise a local graph is enough
            ins = [t if create and t.requires_grad else t.detach().requires_grad_(True)
                   for t in saved]
            outs = _grad_closed_form(*ins, ctx.alpha_lr, ctx.pixelnorm)
            pairs = [(o, g) for o, g in zip(outs, (ggx, ggb)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], ins, [g for _, g in pairs],
                                        create_graph=create, allow_unused=True)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def bias_act_pixelnorm(x: torch.Tensor, b: torch.Tensor, alpha_lr: float = 0.2,
                       pixelnorm: bool = True) -> torch.Tensor:
    """The fused op with its gradient: the kernels for CUDA tensors, the plain versions
    for CPU and meta tensors."""
    return FusedBiasActPixelnorm.apply(x, b, float(alpha_lr), bool(pixelnorm))
