"""Fused bias + leaky ReLU + pixel norm: the CUDA kernels (forward and backward), their
plain versions and the ``autograd.Function``s the generator calls.

Replaces ``saragan_tpu/ops/pallas_kernels.py::fused_bias_act_pixelnorm`` (entry ``:112``,
Pallas body ``_fused_kernel`` ``:55-98``, custom JVP ``_fused_jvp`` ``:123-131``), which
follows every generator conv:

    y = lrelu(x + b, alpha);  y = y * rsqrt(mean_c(y^2) + 1e-8)   per voxel

Both kernels are in ``csrc/fused_bias_act.cu`` (CUDA C++ for sm_90a, loaded with ctypes
through ``ops/_build.py``).  What bounds them on the H100: a few operations per byte, so
device memory; the forward reads x and writes y once, the backward reads x and gy and
writes gx once.  Persistent blocks walk items of TV voxels of one sample (every channel);
an item's rows land in shared memory through a two-stage ring of 16-byte ``cp.async``
copies, the thread that owns a voxel sums its channel terms in registers in the order
c = 0 .. C-1, and the block stores the rows back in 16-byte words.  The tiling is plain
Python (``fused_plan``), so the CPU tests reach it; a voxel's sums never depend on it, so
a sample's y and gx do not depend on N, on its slot or on the plan.

Rounding, as the reference settles it: the primal is the kernel's, everything in f32
(the f32 bias unrounded) and one rounding to x.dtype at the store;
``bias_act_pixelnorm_plain`` computes the same in torch ops.  The gradient is the VJP of
the reference's unfused oracle (``pallas_kernels.py:100-108``, here ``_oracle``), which
adds the bias and applies the leaky ReLU in x.dtype and takes the pixel-norm statistics
in f32, recomputed from the inputs.  In f32 the two are the same function.  Per voxel,
with u = x + b and a = lrelu(u) in x.dtype, g = gy in f32:

    r = rsqrt(mean_c a^2 + 1e-8),  s = sum_c g a,  ga = r g - a r^3 s / C  (to x.dtype)
    gx = where(u >= 0, ga, ga * alpha)  (x.dtype),   gb = sum_{n, voxels} gx

The backward kernel computes that closed form in one pass over x and gy and writes gx;
each block also sums gx per channel in f64 (its lanes' partials added in a fixed order)
into one workspace row, and the last block to finish (a ticket on a per-device counter)
adds the rows in row order into gb, with no atomic sum: one launch per call, and gx and
gb repeat bit for bit.  gb is rounded to f32 and then through x.dtype, as the oracle's is
(it adds the bias in x.dtype), by the kernel and by its plain version
``bias_act_pixelnorm_grad_plain`` alike, so their sums agree whatever order each takes.

``FusedBiasActPixelnorm`` pairs the forward kernel with ``FusedBiasActPixelnormGrad``,
whose forward is the backward kernel (its plain version on a CPU or meta tensor) and whose
own backward differentiates the closed form in torch ops, so the op is differentiable to
any order, as the reference's jnp tangent is.  The kernel wrappers build no graph
themselves; ``bias_act_pixelnorm`` applies the Function.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from saragan_tpu_torch.ops import _build
from saragan_tpu_torch.ops.conv3d_flat import _raise_on_error, _sm_count, _stream
from saragan_tpu_torch.ops.core import in_dtype


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
def _slope(alpha_lr: float, dtype: torch.dtype) -> float:
    """The leaky-ReLU slope rounded to `dtype` (``in_dtype``), once per pair."""
    return in_dtype(alpha_lr, dtype)


# --- tiling plan of csrc/fused_bias_act.cu ---

FUSED_THREADS = 256          # threads per block (the source's THREADS)
FUSED_BLOCKS_PER_SM = 2      # persistent blocks per SM (its __launch_bounds__ minimum)
FUSED_MAX_TV = 1024          # voxels per item: at most 4 per thread
FUSED_MAX_CPT = 4            # channel rows a thread sums in gb's pass
FUSED_MAX_CHANNELS = FUSED_MAX_CPT * FUSED_THREADS
FUSED_STAGE_BYTES = 32 << 10  # one ring stage (x, and gy in the backward) aims at this
# values a thread keeps in registers on the register path: y (forward), or u and g
# (backward) of each of its voxels and channels
FUSED_REGISTER_VALUES = {False: 64, True: 32}
MAX_SMEM = 232448            # shared memory one block can use (227 KB)
SM_SMEM = 233472             # shared memory of one SM (228 KB), 1 KB of it per block reserved
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


@dataclass(frozen=True)
class FusedPlan:
    """How ``csrc/fused_bias_act.cu`` runs one call at C channels and S voxels per
    channel row: items of `tv` voxels of one sample (`tiles` per sample; item i is
    sample i // tiles, voxels from (i % tiles) * tv), walked by ``blocks(n)`` persistent
    blocks, block k taking items k, k + grid, ...  In the backward's gb pass lane l
    (thread + m * FUSED_THREADS) adds channel l // lanes, voxels l % lanes, + lanes, ...
    Nothing here depends on N but the grid."""
    c: int
    s: int
    esize: int
    backward: bool
    tv: int         # voxels per item, a power of two
    tiles: int      # items per sample: ceil(S / tv)
    vpt: int        # voxels per thread: tv / FUSED_THREADS, at least 1
    rs: int         # shared row stride in elements: tv + one 16-byte word
    lanes: int      # backward: lanes per channel row in gb's pass (1 in the forward)
    async16: bool   # rows copied as 16-byte cp.async words, else element by element
    cu: int         # with pixel norm: C where a thread keeps its voxels' channels in
                    # registers (C = 16 or 32, 16-byte words, FUSED_REGISTER_VALUES), else 0
    smem: int       # bytes: two stages, the bias, per-voxel statistics, the backward's f64
                    # partials, a flag
    blocks_per_sm: int
    sms: int

    def blocks(self, n: int) -> int:
        """The grid, and the backward's workspace rows (one per block)."""
        return min(n * self.tiles, self.blocks_per_sm * self.sms)


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def _fused_smem(c: int, tv: int, esize: int, backward: bool) -> int:
    """Bytes of dynamic shared memory (the source's ``layout``)."""
    tensors = 2 if backward else 1
    stage = c * (tv + 16 // esize) * esize * tensors
    stat = _round16(2 * stage + 4 * c)
    part = _round16(stat + 4 * tv * tensors)
    flag = part + (8 * max(c, FUSED_THREADS) if backward else 0)
    return flag + 16


@functools.lru_cache(maxsize=4096)
def fused_plan(c: int, s: int, dtype: torch.dtype, sm_count: int, backward: bool = False,
               aligned: bool = True) -> FusedPlan:
    """The tiles of one call: x (N, C, *spatial) with S = prod(spatial), in `dtype` (f32
    or bf16).  An item holds about ``FUSED_STAGE_BYTES`` of rows (at least one 16-byte
    word per row, at most ``FUSED_MAX_TV`` voxels and no more than S needs); rows move as
    16-byte words where `aligned` (every operand's base on 16 bytes) and S * size is a
    multiple of 16, else element by element.  Cached."""
    if dtype not in _ESIZE:
        raise ValueError(f"the fused kernels take float32 or bfloat16, not {dtype}")
    if not 1 <= c <= FUSED_MAX_CHANNELS or s < 1:
        raise ValueError(f"the fused kernels take 1 to {FUSED_MAX_CHANNELS} channels and at "
                         f"least one voxel; got C={c}, S={s}")
    esize = _ESIZE[dtype]
    ve = 16 // esize
    tv = _pow2_floor(FUSED_STAGE_BYTES // (c * esize * (2 if backward else 1)))
    tv = max(ve, min(tv, FUSED_MAX_TV, _pow2_ceil(s)))
    rs = tv + ve
    lanes = min(_pow2_floor(FUSED_THREADS // c), tv) if backward and c <= FUSED_THREADS else 1
    smem = _fused_smem(c, tv, esize, backward)
    if smem > MAX_SMEM:
        raise ValueError(f"the fused kernels have no tiling that fits shared memory for C={c}")
    vpt = max(1, tv // FUSED_THREADS)
    async16 = bool(aligned) and (s * esize) % 16 == 0
    registers = c in (16, 32) and async16 and c * vpt <= FUSED_REGISTER_VALUES[backward]
    return FusedPlan(c=c, s=s, esize=esize, backward=backward, tv=tv, tiles=-(-s // tv),
                     vpt=vpt, rs=rs, lanes=lanes, async16=async16, cu=c if registers else 0,
                     smem=smem,
                     blocks_per_sm=max(1, min(FUSED_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))),
                     sms=int(sm_count))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("fused_bias_act")
    # pointers; bf16, n, c, s, alpha, eps; the plan's ints (forward: pixelnorm, tv, cu,
    # async16, blocks; backward: pixelnorm, tv, cu, lanes, async16, blocks); smem, stream
    shape = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
             ctypes.c_float]
    tail = [ctypes.c_longlong, ctypes.c_void_p]
    lib.saragan_fused_bias_act_fwd.argtypes = ([ctypes.c_void_p] * 3 + shape
                                               + [ctypes.c_int] * 5 + tail)
    lib.saragan_fused_bias_act_bwd.argtypes = ([ctypes.c_void_p] * 7 + shape
                                               + [ctypes.c_int] * 6 + tail)
    lib.saragan_fused_bias_act_fwd.restype = lib.saragan_fused_bias_act_bwd.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


_counters = {}  # (device index, stream) -> the backward's int32 ticket counter


def _counter(x: torch.Tensor, stream: int) -> torch.Tensor:
    """The backward's ticket counter for x's device and this stream: zeroed once; the
    last block of every launch sets it back to 0."""
    key = (x.device.index, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=x.device)
    return _counters[key]


def _check_operands(name: str, x: torch.Tensor, b: torch.Tensor, *rest: torch.Tensor):
    tensors = (x, b, *rest)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name} needs its operands on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if x.ndim < 3 or b.shape != (x.shape[1],):
        raise ValueError(f"x must be (N, C, *spatial) and b (C,); got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    if x.dtype not in _ESIZE:
        raise ValueError(f"{name} takes float32 or bfloat16 x, not {x.dtype}")
    if any(t.shape != x.shape or t.dtype != x.dtype for t in rest):
        raise ValueError(f"{name}: gy must have x's shape and dtype")
    if not all(t.is_contiguous() for t in (x, *rest)):
        raise ValueError(f"{name} needs contiguous operands")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} builds no autograd graph: differentiate through "
                                  f"FusedBiasActPixelnorm")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def fused_bias_act_pixelnorm(x: torch.Tensor, b: torch.Tensor, alpha_lr: float,
                             pixelnorm: bool, eps: float = 1e-8) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream: x (N, C, *spatial)
    contiguous on a CUDA device, f32 or bf16, b (C,) (read in f32, unrounded, whatever x's
    dtype)."""
    _check_operands("fused_bias_act_pixelnorm", x, b)
    n, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    p = fused_plan(c, s, x.dtype, _sm_count(x.device), False, _aligned(x))
    b32 = b.to(torch.float32).contiguous()
    lib = _library()
    err = lib.saragan_fused_bias_act_fwd(
        x.data_ptr(), b32.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), n, c, s,
        float(alpha_lr), float(eps), int(bool(pixelnorm)), p.tv, p.cu if pixelnorm else 0,
        int(p.async16), p.blocks(n), p.smem, _stream(x))
    _raise_on_error(lib, err, f"fused_bias_act forward launch for x {tuple(x.shape)} {x.dtype}")
    fused_bias_act_pixelnorm.launches += 1
    return y


fused_bias_act_pixelnorm.launches = 0


def fused_bias_act_pixelnorm_grad(x: torch.Tensor, b: torch.Tensor, gy: torch.Tensor,
                                  alpha_lr: float, pixelnorm: bool, eps: float = 1e-8):
    """Launch the backward kernel on PyTorch's current stream: x and gy (N, C, *spatial)
    of one dtype (f32 or bf16), contiguous on a CUDA device, b (C,).  Returns (gx in
    x.dtype, gb in b.dtype: summed in f64, rounded through x.dtype).  One launch per call;
    its f64 workspace (one row per block) comes from PyTorch's allocator."""
    _check_operands("fused_bias_act_pixelnorm_grad", x, b, gy)
    n, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    gx = torch.empty_like(x)
    if gx.numel() == 0:
        return gx, torch.zeros_like(b)
    stream = _stream(x)
    p = fused_plan(c, s, x.dtype, _sm_count(x.device), True, _aligned(x, gy))
    blocks = p.blocks(n)
    ws = torch.empty((blocks, c), dtype=torch.float64, device=x.device)
    gb = torch.empty(c, dtype=torch.float32, device=x.device)
    b32 = b.to(torch.float32).contiguous()
    lib = _library()
    err = lib.saragan_fused_bias_act_bwd(
        x.data_ptr(), b32.data_ptr(), gy.data_ptr(), gx.data_ptr(), gb.data_ptr(), ws.data_ptr(),
        _counter(x, stream).data_ptr(), int(x.dtype == torch.bfloat16), n, c, s,
        _slope(float(alpha_lr), x.dtype), float(eps), int(bool(pixelnorm)), p.tv,
        p.cu if pixelnorm else 0, p.lanes, int(p.async16), blocks, p.smem, stream)
    _raise_on_error(lib, err, f"fused_bias_act backward launch for x {tuple(x.shape)} {x.dtype}")
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
