"""Minibatch standard-deviation statistic: the CUDA kernel, its plan and its plain version.

Replaces ``saragan_tpu/ops/pallas_kernels.py::minibatch_stddev_stat`` (Pallas body
``_mbstd_kernel``): for x of shape (N, ...) and G = min(group_size, N), the samples form
N / G groups, interleaved as the reference reshapes them (``reshape(G, groups, F)``, so
group m holds samples m, m + groups, m + 2 groups, ...).  Per group, in f32: the mean over
the group, the biased variance, ``sqrt(var + eps)``, then the mean over all F features.
The result is (groups, 1) f32.  As in the reference it is standalone: no discriminator of
either package calls it (the reference's ``minibatch_stddev_layer`` is plain jnp, and
this kernel has no gradient).

The kernel is ``csrc/minibatch_stddev.cu`` (CUDA C++ for sm_90a, loaded with ctypes
through ``ops/_build.py``).  What bounds it on the H100: one pass over the bytes of x with
a few operations per element, so device memory; at the small inputs, the launch.  A lane
reads its features of an item's G rows with one 16-byte load per row and keeps the
group's values in registers (G = 1, 2, 4, 8 are template sizes, any other G up to 8 runs
over 8 guarded rows; a larger G reads the rows twice); each item's f64 sum of the
per-feature stddevs lands in one workspace entry per (group, chunk), and the last block
to finish (a ticket counter) adds each group's entries in a fixed order.  One launch per
call, no atomic sum, so a rerun is bit-identical and the result does not depend on the
grid.  The workspace and the counter are cached per (device, stream).  The plan (vector
width, template G, vectors per item, grid) is plain Python, ``mbstd_plan``, so the CPU
tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from saragan_tpu_torch.ops import _build
from saragan_tpu_torch.ops.conv3d_flat import _raise_on_error, _sm_count, _stream

# --- the plan of csrc/minibatch_stddev.cu ---

MBSTD_THREADS = 256        # threads per block (the source's THREADS)
MBSTD_WARPS = MBSTD_THREADS // 32
MBSTD_CHUNK_VECTORS = 8    # vectors a lane takes of an item where the items fill the grid
MBSTD_TEMPLATE_G = (1, 2, 4, 8)
MBSTD_MAX_REG_G = 8        # the largest group a thread holds in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # the source's Dtype
_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _groups(x: torch.Tensor, group_size: int):
    n = x.shape[0]
    g = min(group_size, n)
    if g < 1 or n % g:
        raise ValueError(f"batch {n} is not a multiple of the group size {g}")
    return g, n // g


@dataclass(frozen=True)
class MbstdPlan:
    """How ``csrc/minibatch_stddev.cu`` runs one call: N samples of `feat` features in
    `groups` groups of `g`.  An item is `chunk` features (MBSTD_WARPS warps x 32 lanes x
    `cv` vectors of `vec` values) of one group; item i is group i // chunks, features from
    (i % chunks) * chunk; `blocks` blocks walk them, block b taking items b, b + blocks,
    ...  The workspace holds one f64 per item."""
    g: int
    groups: int
    feat: int
    vec: int      # values per load: 16 bytes' worth where rows start on 16 bytes, else 1
    gt: int       # the template G (1, 2, 4 or 8); 0: any G <= 8 (8 guarded rows in
                  # registers); -1: any G, the rows read twice
    cv: int       # vectors a lane takes of an item
    chunk: int
    chunks: int   # items per group
    items: int
    blocks: int


def mbstd_blocks_per_sm(gt: int, vec: int) -> int:
    """Blocks an SM holds (the source's ``__launch_bounds__``): 2 where a thread keeps more
    than 32 values of its group in registers (gt 0 or -1, a G that is not a template size,
    counts as 8), else 4."""
    return 2 if (gt if gt > 0 else MBSTD_MAX_REG_G) * vec > 32 else 4


@functools.lru_cache(maxsize=4096)
def mbstd_plan(n: int, feat: int, dtype: torch.dtype, group_size: int, sm_count: int,
               aligned: bool = True) -> MbstdPlan:
    """The plan of one call on x (n, ...) with `feat` features per sample in `dtype` (f32,
    bf16 or f16).  Rows move as 16-byte words where `aligned` (x's base on 16 bytes) and a
    row is a whole number of words, else element by element.  A lane takes
    MBSTD_CHUNK_VECTORS vectors of an item where the items still give every block of a
    full grid one, else the most of 4, 2, 1 that do (1 at the least): a small input spreads
    over more warps instead of one warp's chain of loads.  The grid is the fewest blocks
    that walk the items in as many rounds as a full grid would, so that no block takes
    more items than another but one.  Cached."""
    if dtype not in _DTYPES:
        raise ValueError(f"minibatch_stddev_stat takes f32, bf16 or f16, not {dtype}")
    if feat < 1:
        raise ValueError("minibatch_stddev_stat needs at least one feature per sample")
    g = min(group_size, n)
    if g < 1 or n % g:
        raise ValueError(f"batch {n} is not a multiple of the group size {g}")
    groups = n // g
    esize = _ESIZE[dtype]
    vec = 16 // esize if aligned and (feat * esize) % 16 == 0 else 1
    gt = g if g in MBSTD_TEMPLATE_G else 0 if g <= MBSTD_MAX_REG_G else -1
    grid = mbstd_blocks_per_sm(gt, vec) * int(sm_count)
    cv = next((c for c in (MBSTD_CHUNK_VECTORS, 4, 2)
               if groups * -(-feat // (MBSTD_THREADS * c * vec)) >= grid), 1)
    chunk = MBSTD_THREADS * cv * vec
    chunks = -(-feat // chunk)
    items = groups * chunks
    if items >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"minibatch_stddev_stat: {items} items exceed the kernel's int range")
    rounds = -(-items // grid)
    return MbstdPlan(g=g, groups=groups, feat=feat, vec=vec, gt=gt, cv=cv, chunk=chunk,
                     chunks=chunks, items=items, blocks=-(-items // rounds))


def minibatch_stddev_stat_plain(x: torch.Tensor, group_size: int = 4,
                                eps: float = 1e-8) -> torch.Tensor:
    """The statistic in torch ops, f32 (f64 for f64 inputs)."""
    g, groups = _groups(x, group_size)
    minibatch_stddev_stat_plain.calls += 1
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = x.reshape(g, groups, -1).to(acc)
    y = y - torch.mean(y, dim=0, keepdim=True)
    s = torch.sqrt(torch.mean(torch.square(y), dim=0) + eps)
    return torch.mean(s, dim=1, keepdim=True).float()


minibatch_stddev_stat_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("minibatch_stddev")
    # x, ws, counter, out; dtype, n, feat; g, vec, gt, cv, blocks; eps, stream
    lib.saragan_mbstd.argtypes = ([ctypes.c_void_p] * 4
                                  + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    lib.saragan_mbstd.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


_scratch_cache = {}  # (device index, stream) -> (f64 workspace, int32 ticket counter)


def _scratch(x: torch.Tensor, stream: int, entries: int):
    """The workspace (at least `entries` f64) and the ticket counter for x's device and
    this stream: the counter is zeroed once and the last block of every launch sets it
    back to 0; the workspace grows when a call needs more."""
    key = (x.device.index, stream)
    ws, counter = _scratch_cache.get(key, (None, None))
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=x.device)
    if ws is None or ws.numel() < entries:
        ws = torch.empty(entries, dtype=torch.float64, device=x.device)
    _scratch_cache[key] = (ws, counter)
    return ws, counter


def minibatch_stddev_stat_cuda(x: torch.Tensor, group_size: int = 4,
                               eps: float = 1e-8) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream: x (N, ...) contiguous on a CUDA
    device, f32, bf16 or f16; returns (groups, 1) f32.  One launch per call, counted."""
    if not x.is_cuda:
        raise ValueError(f"minibatch_stddev_stat_cuda needs a CUDA tensor; got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"minibatch_stddev_stat_cuda takes f32, bf16 or f16; got {x.dtype}")
    if x.ndim < 1 or not x.is_contiguous():
        raise ValueError("minibatch_stddev_stat_cuda needs a contiguous x of shape (N, ...)")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("minibatch_stddev_stat has no gradient (as in the reference)")
    n = x.shape[0]
    feat = x[0].numel() if n else 0
    p = mbstd_plan(n, feat, x.dtype, group_size, _sm_count(x.device), x.data_ptr() % 16 == 0)
    stream = _stream(x)
    ws, counter = _scratch(x, stream, p.items)
    out = torch.empty((p.groups, 1), dtype=torch.float32, device=x.device)
    lib = _library()
    err = lib.saragan_mbstd(x.data_ptr(), ws.data_ptr(), counter.data_ptr(), out.data_ptr(),
                            _DTYPES[x.dtype], n, feat, p.g, p.vec, p.gt, p.cv, p.blocks,
                            float(eps), stream)
    _raise_on_error(lib, err, f"minibatch_stddev launch for x {tuple(x.shape)} {x.dtype}")
    minibatch_stddev_stat_cuda.launches += 1
    return out


minibatch_stddev_stat_cuda.launches = 0


def minibatch_stddev_stat(x: torch.Tensor, group_size: int = 4,
                          eps: float = 1e-8) -> torch.Tensor:
    """The per-group statistic, (groups, 1) f32: the CUDA kernel for CUDA tensors, the
    plain version for CPU (and meta) tensors."""
    if x.is_cuda:
        return minibatch_stddev_stat_cuda(x, group_size, eps)
    if x.device.type in ("cpu", "meta"):
        return minibatch_stddev_stat_plain(x, group_size, eps)
    raise ValueError(f"minibatch_stddev_stat has no path for device {x.device}")
