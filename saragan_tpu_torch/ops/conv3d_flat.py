"""SAME stride-1 conv3d forward and weight gradient: the hand-written CUDA kernels and
their plain versions.

Replaces the ``pallas`` conv engine of the reference, ``saragan_tpu/ops/pallas_conv.py``:
``conv3d_flat`` (kernel ``_fwd_kernel``) by ``csrc/conv3d_fwd.cu`` and
``conv3d_flat_wgrad`` (kernel ``_wgrad_kernel``) by ``csrc/conv3d_wgrad.cu``, and the
pipelined variant ``conv3d_flat_v2`` (kernel ``_fwd_v2_kernel``) by
``csrc/conv3d_fwd_v2.cu``.  v2 is standalone, as in the reference, where no conv engine
reaches it (``saragan_tpu/ops/core.py:553``); the port's engines use kernels #1 and #2.  Each
source note says what bounds the kernel on the H100 and how its design differs from the
TPU kernel's flat-padded window.  The derivative algebra that uses them as forward,
dgrad and wgrad is ``ops/conv3d_grad.py``.

Layouts are the reference's: x and dy are NCDHW, w is ``(kd, kh, kw, C, F)``.  Kernel
sizes must be odd: SAME padding is then ``k // 2`` on both sides, which is also what the
reference's flat engine pads.  For even sizes that engine disagrees with SAME, so every
version here refuses them.  The kernels take f32 or bf16 (x, w and dy of one type) and
accumulate in f32, rounding once at the store.

``conv3d_flat`` and ``conv3d_flat_wgrad`` are the dispatchers: on a CUDA tensor they
launch the kernel (or raise), on a CPU or meta tensor they run the plain version.  Each
kernel wrapper and plain version keeps a plain integer count of its launches / calls so a
run can show which one served it; the kernel wrappers also count by shape, the forward
kernel's keyed by role as well ("forward" for the model's own convs, "dgrad" for those
the backward passes run).  A kernel wrapper
called directly under autograd refuses to build a graph: gradients go through the
``autograd.Function``s of ``ops/conv3d_grad.py``.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Tuple

import torch
import torch.nn.functional as F

from saragan_tpu_torch.ops import _build

_SUPPORTED_KW = (1, 3, 5, 7)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/elem.cuh


def _check_odd(kernel):
    if any(k % 2 == 0 for k in kernel):
        raise ValueError(f"conv3d_flat needs odd kernel sizes (SAME = k//2 per side); "
                         f"got {tuple(kernel)}")


def _check_shapes(x: torch.Tensor, w: torch.Tensor):
    if x.ndim != 5 or w.ndim != 5:
        raise ValueError(f"conv3d_flat takes x (N,C,D,H,W) and w (kd,kh,kw,C,F); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[3] != x.shape[1]:
        raise ValueError(f"weight in-channels {w.shape[3]} != input channels {x.shape[1]}")
    _check_odd(w.shape[:3])


def _check_wgrad_shapes(x: torch.Tensor, dy: torch.Tensor, kernel):
    if x.ndim != 5 or dy.ndim != 5 or len(kernel) != 3:
        raise ValueError(f"conv3d_flat_wgrad takes x (N,C,D,H,W), dy (N,F,D,H,W) and a 3-D "
                         f"kernel; got {tuple(x.shape)}, {tuple(dy.shape)}, {tuple(kernel)}")
    if x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} differ outside the "
                         f"channel axis")
    _check_odd(kernel)


def _check_cuda_operands(name, tensors):
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs its operands on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one type; got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} builds no autograd graph: differentiate through "
                                  f"ops.conv3d_grad.Conv3dC / Conv3dW")


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def conv3d_flat_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same SAME conv in torch ops, no cuDNN: pad, then sum the per-tap channel
    contractions of shifted slices, accumulated in f32 (f64 for f64 inputs)."""
    _check_shapes(x, w)
    conv3d_flat_plain.calls += 1
    return _conv_per_tap(x, w)


def _conv_per_tap(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n, _, d, h, wd = x.shape
    kd, kh, kw, _, f = w.shape
    acc_dtype = _acc_dtype(x.dtype)
    xp = F.pad(x.to(acc_dtype), (kw // 2, kw // 2, kh // 2, kh // 2, kd // 2, kd // 2))
    wa = w.to(acc_dtype)
    acc = torch.zeros((n, f, d, h, wd), dtype=acc_dtype, device=x.device)
    for i in range(kd):
        for j in range(kh):
            for k in range(kw):
                xs = xp[:, :, i:i + d, j:j + h, k:k + wd]
                acc += torch.einsum("ncdhw,cf->nfdhw", xs, wa[i, j, k])
    return acc.to(x.dtype)


conv3d_flat_plain.calls = 0


def conv3d_flat_v2_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same conv the way v2 contracts it, in torch ops: for C <= 32, per sample, the
    K shifted slices of the padded input stacked into one (K*C, D*H*W) im2col operand and
    one K*C-wide contraction with w reshaped to (K*C, F); per tap otherwise.  f32 (f64
    for f64 inputs) accumulation, one rounding to x.dtype."""
    _check_shapes(x, w)
    conv3d_flat_v2_plain.calls += 1
    n, c, d, h, wd = x.shape
    kd, kh, kw, _, f = w.shape
    if c > 32:
        return _conv_per_tap(x, w)
    acc_dtype = _acc_dtype(x.dtype)
    wk = w.to(acc_dtype).reshape(-1, f)
    y = torch.empty((n, f, d, h, wd), dtype=x.dtype, device=x.device)
    for s in range(n):  # one sample's operand at a time bounds the memory
        xp = F.pad(x[s].to(acc_dtype), (kw // 2, kw // 2, kh // 2, kh // 2, kd // 2, kd // 2))
        cols = torch.cat([xp[:, i:i + d, j:j + h, k:k + wd].reshape(c, -1)
                          for i in range(kd) for j in range(kh) for k in range(kw)])
        y[s] = (wk.t() @ cols).reshape(f, d, h, wd).to(x.dtype)
    return y


conv3d_flat_v2_plain.calls = 0


def conv3d_flat_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                            kernel: Tuple[int, int, int]) -> torch.Tensor:
    """dw[kz,ky,kx,c,f] = sum_{n,p} x[n,c,p+(kz,ky,kx)-k//2] dy[n,f,p] in torch ops: pad,
    then one channel contraction of a shifted slice per tap, in f32 (f64 for f64
    inputs), rounded once to x.dtype."""
    _check_wgrad_shapes(x, dy, kernel)
    conv3d_flat_wgrad_plain.calls += 1
    _, c, d, h, wd = x.shape
    kd, kh, kw = (int(k) for k in kernel)
    acc_dtype = _acc_dtype(x.dtype)
    xp = F.pad(x.to(acc_dtype), (kw // 2, kw // 2, kh // 2, kh // 2, kd // 2, kd // 2))
    dya = dy.to(acc_dtype)
    dw = torch.empty((kd, kh, kw, c, dy.shape[1]), dtype=acc_dtype, device=x.device)
    for i in range(kd):
        for j in range(kh):
            for k in range(kw):
                xs = xp[:, :, i:i + d, j:j + h, k:k + wd]
                dw[i, j, k] = torch.einsum("ncdhw,nfdhw->cf", xs, dya)
    return dw.to(x.dtype)


conv3d_flat_wgrad_plain.calls = 0


def _raise_on_error(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.saragan_cuda_error_string(err).decode()}")


def conv3d_flat_cuda(x: torch.Tensor, w: torch.Tensor, role: str = "forward") -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream.  `role` only labels the
    launch count ("forward" or "dgrad")."""
    _check_shapes(x, w)
    _check_cuda_operands("conv3d_flat_cuda", (x, w))
    if w.shape[2] not in _SUPPORTED_KW:
        raise ValueError(f"kernel width {w.shape[2]} not in {_SUPPORTED_KW}")
    n, c, d, h, wd = x.shape
    kd, kh, kw, _, f = w.shape
    y = torch.empty((n, f, d, h, wd), dtype=x.dtype, device=x.device)
    lib = _fwd_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.saragan_conv3d_fwd(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                                 y.data_ptr(), n, c, d, h, wd, kd, kh, kw, f, stream)
    _raise_on_error(lib, err, f"conv3d_fwd launch for x {tuple(x.shape)}, w {tuple(w.shape)}")
    conv3d_flat_cuda.launches += 1
    conv3d_flat_cuda.by_shape[(role, tuple(x.shape), tuple(w.shape), x.dtype)] += 1
    return y


conv3d_flat_cuda.launches = 0
conv3d_flat_cuda.by_shape = Counter()  # (role, x shape, w shape, dtype) -> launches


def conv3d_flat_v2_cuda(x: torch.Tensor, w: torch.Tensor, role: str = "forward") -> torch.Tensor:
    """Launch the pipelined forward kernel (``csrc/conv3d_fwd_v2.cu``) on PyTorch's
    current stream.  `role` only labels the launch count ("forward" or "dgrad")."""
    _check_shapes(x, w)
    _check_cuda_operands("conv3d_flat_v2_cuda", (x, w))
    if w.shape[2] not in _SUPPORTED_KW:
        raise ValueError(f"kernel width {w.shape[2]} not in {_SUPPORTED_KW}")
    n, c, d, h, wd = x.shape
    kd, kh, kw, _, f = w.shape
    y = torch.empty((n, f, d, h, wd), dtype=x.dtype, device=x.device)
    lib = _v2_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.saragan_conv3d_fwd_v2(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                                    y.data_ptr(), n, c, d, h, wd, kd, kh, kw, f, stream)
    _raise_on_error(lib, err, f"conv3d_fwd_v2 launch for x {tuple(x.shape)}, "
                              f"w {tuple(w.shape)}")
    conv3d_flat_v2_cuda.launches += 1
    conv3d_flat_v2_cuda.by_shape[(role, tuple(x.shape), tuple(w.shape), x.dtype)] += 1
    return y


conv3d_flat_v2_cuda.launches = 0
conv3d_flat_v2_cuda.by_shape = Counter()  # (role, x shape, w shape, dtype) -> launches


def conv3d_flat_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor,
                           kernel: Tuple[int, int, int]) -> torch.Tensor:
    """Launch the weight-gradient kernel (two passes, a fixed summation order) on
    PyTorch's current stream; its f32 workspace comes from PyTorch's allocator."""
    _check_wgrad_shapes(x, dy, kernel)
    _check_cuda_operands("conv3d_flat_wgrad_cuda", (x, dy))
    kd, kh, kw = (int(k) for k in kernel)
    if kw not in _SUPPORTED_KW:
        raise ValueError(f"kernel width {kw} not in {_SUPPORTED_KW}")
    n, c, d, h, wd = x.shape
    f = dy.shape[1]
    lib = _wgrad_library()
    floats = lib.saragan_conv3d_wgrad_workspace_floats(n, c, d, h, wd, kd, kh, kw, f)
    if floats < 0:
        raise ValueError(f"conv3d_wgrad does not take x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, kernel {(kd, kh, kw)}")
    ws = torch.empty(floats, dtype=torch.float32, device=x.device)
    dw = torch.empty((kd, kh, kw, c, f), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.saragan_conv3d_wgrad(_DTYPE_CODES[x.dtype], x.data_ptr(), dy.data_ptr(),
                                   dw.data_ptr(), ws.data_ptr(), floats, n, c, d, h, wd,
                                   kd, kh, kw, f, stream)
    _raise_on_error(lib, err, f"conv3d_wgrad launch for x {tuple(x.shape)}, dy "
                              f"{tuple(dy.shape)}")
    conv3d_flat_wgrad_cuda.launches += 1
    conv3d_flat_wgrad_cuda.by_shape[(tuple(x.shape), tuple(dy.shape), (kd, kh, kw),
                                     x.dtype)] += 1
    return dw


conv3d_flat_wgrad_cuda.launches = 0
conv3d_flat_wgrad_cuda.by_shape = Counter()  # (x shape, dy shape, kernel, dtype) -> launches


@functools.lru_cache(maxsize=None)
def _fwd_library() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_fwd")
    fn = lib.saragan_conv3d_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _v2_library() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_fwd_v2")
    fn = lib.saragan_conv3d_fwd_v2
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_library() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_wgrad")
    q = lib.saragan_conv3d_wgrad_workspace_floats
    q.argtypes = [ctypes.c_int] * 9
    q.restype = ctypes.c_longlong
    fn = lib.saragan_conv3d_wgrad
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _device_path(name, x):
    if x.is_cuda:
        return "cuda"
    if x.device.type in ("cpu", "meta"):
        return "plain"
    raise ValueError(f"{name} has no path for device {x.device}")


def conv3d_flat(x: torch.Tensor, w: torch.Tensor, role: str = "forward") -> torch.Tensor:
    """SAME stride-1 NCDHW conv with (kd,kh,kw,C,F) weights: the CUDA kernel for CUDA
    tensors, the plain version for CPU (and shape-only meta) tensors."""
    if _device_path("conv3d_flat", x) == "cuda":
        return conv3d_flat_cuda(x, w, role)
    return conv3d_flat_plain(x, w)


def conv3d_flat_v2(x: torch.Tensor, w: torch.Tensor, role: str = "forward") -> torch.Tensor:
    """The pipelined variant of ``conv3d_flat``, the same function: the v2 CUDA kernel for
    CUDA tensors, its plain version for CPU (and meta) tensors.  Standalone, as in the
    reference: no conv engine of the port routes through it."""
    if _device_path("conv3d_flat_v2", x) == "cuda":
        return conv3d_flat_v2_cuda(x, w, role)
    return conv3d_flat_v2_plain(x, w)


def conv3d_flat_wgrad(x: torch.Tensor, dy: torch.Tensor,
                      kernel: Tuple[int, int, int]) -> torch.Tensor:
    """The conv's weight gradient W(x, dy): the CUDA kernel for CUDA tensors, the plain
    version for CPU (and meta) tensors."""
    if _device_path("conv3d_flat_wgrad", x) == "cuda":
        return conv3d_flat_wgrad_cuda(x, dy, kernel)
    return conv3d_flat_wgrad_plain(x, dy, kernel)
