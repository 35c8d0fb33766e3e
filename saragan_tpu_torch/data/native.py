"""The port's native host library through ctypes (counterpart of
``saragan_tpu/data/native.py``): the npy reader, the prefetch executor and the JPEG batch
decoder of ``csrc/host/*.cc``.

The library is built with g++ at first use (``ops/_build.py::build_host``) into
``saragan_tpu_torch/build/``; unlike the JAX module, nothing here returns ``None`` when it
is missing: it is built, or the build raises with the compiler's log.

* ``load_npy`` / ``load_npy_batch``: one file in its own dtype / N same-shape files into a
  float32 batch (dtype converted on a thread pool).  A file the C++ header parser does not
  take (big-endian, Fortran order, an unknown dtype) is read by ``np.load``, as the JAX
  module does.
* ``NativeBatchPrefetcher``: a C++ worker pool keeps ``depth`` batch jobs in flight (mmap
  read, dtype conversion, (x - mean) / std and the f16 / bf16 rounding, all off the GIL),
  consumed in submit order.  The shuffle / shard path selection stays in Python
  (``make_paths``).  Each batch lands in a torch tensor, pinned when asked, so a copy to
  the card does not block; bf16 travels as 16-bit words and becomes ``torch.bfloat16`` by
  ``.view`` (round to nearest even on the worker pool, the same bits as torch's cast).
* ``decode_jpeg_batch``: libjpeg decode, the PIL-compatible antialiased triangle resize,
  [-1, 1], CHW; ``have_jpeg()`` says whether the library was built against libjpeg.
  ``resize_triangle_plain`` is the resize's plain PyTorch version on uint8 images.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from saragan_tpu_torch.ops import _build

_DTYPES = {1: np.float32, 2: np.float64, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.uint8, 7: np.float16}

# the prefetcher's output codes (saragan_pf_submit_d)
OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The host library with its signatures declared (built first if needed)."""
    lib = _build.load_host_library()
    c_int, c_i64, c_p, c_f = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float
    paths_t = ctypes.POINTER(ctypes.c_char_p)
    sigs = {
        "saragan_npy_probe": (c_int, [ctypes.c_char_p, ctypes.POINTER(c_i64),
                                      ctypes.POINTER(c_int), ctypes.POINTER(c_int)]),
        "saragan_npy_read": (c_int, [ctypes.c_char_p, c_p, c_i64]),
        "saragan_npy_read_batch": (c_int, [paths_t, c_int, c_p, c_i64, c_int]),
        "saragan_pf_create": (c_p, [c_i64, c_int]),
        "saragan_pf_submit_d": (c_int, [c_p, paths_t, c_int, c_f, c_f, c_int, c_int]),
        "saragan_pf_next": (c_int, [c_p, c_p, c_i64]),
        "saragan_pf_destroy": (None, [c_p]),
        "saragan_have_jpeg": (c_int, []),
        "saragan_jpeg_batch": (c_int, [paths_t, c_int, c_p, c_int, c_int, c_int]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _paths(paths):
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def load_npy(path: str) -> np.ndarray:
    """One .npy file in its own dtype."""
    lib = library()
    shape, ndim, code = (ctypes.c_int64 * 8)(), ctypes.c_int(), ctypes.c_int()
    rc = lib.saragan_npy_probe(str(path).encode(), shape, ctypes.byref(ndim),
                               ctypes.byref(code))
    if rc != 0 or code.value not in _DTYPES:
        return np.load(path)
    out = np.empty(tuple(shape[i] for i in range(ndim.value)), _DTYPES[code.value])
    if lib.saragan_npy_read(str(path).encode(), out.ctypes.data, out.nbytes) != 0:
        return np.load(path)
    return out


def load_npy_batch(paths, out: np.ndarray, num_threads: int = 4) -> bool:
    """Fill a preallocated (N, ...) float32 C-contiguous array from N same-shape npy files
    on a C++ thread pool.  False on any mismatch (shape, unreadable file)."""
    if out.dtype != np.float32 or not out.flags.c_contiguous or out.shape[0] != len(paths):
        raise ValueError(f"out must be a C-contiguous float32 array of {len(paths)} items")
    if not paths:
        return True
    rc = library().saragan_npy_read_batch(_paths(paths), len(paths), out.ctypes.data,
                                          out.nbytes // out.shape[0], num_threads)
    return rc == 0


class NativeBatchPrefetcher:
    """Duck-types the Python ``Prefetcher`` (``next()`` / ``stop()``): batches of the
    paths ``make_paths()`` returns, as (N, *item_shape) tensors of ``out_dtype``, in
    submit order, ``depth`` jobs ahead on ``workers`` C++ threads."""

    def __init__(self, make_paths, item_shape, mean, stddev, depth: int = 3,
                 workers: int = 4, out_dtype: torch.dtype = torch.float32,
                 pin_memory: bool = False):
        self._handle = None
        if out_dtype not in OUT_CODES:
            raise ValueError(f"out_dtype {out_dtype} not in {list(OUT_CODES)}")
        if (mean is None) != (stddev is None):
            raise ValueError("data_mean and data_stddev must both be set or both unset")
        self._lib = library()
        self._make_paths = make_paths
        self._item_shape = tuple(int(s) for s in item_shape)
        self._out_dtype = out_dtype
        self._pin = pin_memory
        self._normalize = mean is not None
        self._mean = float(mean if mean is not None else 0.0)
        self._std = float(stddev if stddev is not None else 1.0)
        self._handle = self._lib.saragan_pf_create(math.prod(self._item_shape) * 4, workers)
        if not self._handle:
            raise RuntimeError(f"saragan_pf_create refused item shape {self._item_shape}")
        self._inflight = []  # batch sizes, FIFO
        for _ in range(depth):
            self._submit()

    def _submit(self):
        paths = list(self._make_paths())
        rc = self._lib.saragan_pf_submit_d(self._handle, _paths(paths), len(paths),
                                           self._mean, self._std, int(self._normalize),
                                           OUT_CODES[self._out_dtype])
        if rc != 0:
            raise RuntimeError(f"saragan_pf_submit_d rc={rc}")
        self._inflight.append(len(paths))

    def __next__(self) -> torch.Tensor:
        if self._handle is None:
            raise StopIteration
        n = self._inflight.pop(0)
        # 16-bit outputs arrive as raw words; bf16 becomes torch.bfloat16 by a view
        raw = torch.float32 if self._out_dtype == torch.float32 else torch.int16
        out = torch.empty((n,) + self._item_shape, dtype=raw, pin_memory=self._pin)
        rc = self._lib.saragan_pf_next(self._handle, out.data_ptr(),
                                       out.numel() * out.element_size())
        if rc != 0:
            self.stop()
            raise RuntimeError(f"native prefetch failed (rc={rc})")
        self._submit()
        return out if raw == self._out_dtype else out.view(self._out_dtype)

    def stop(self):
        if self._handle is not None:
            self._lib.saragan_pf_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        self.stop()


def have_jpeg() -> bool:
    """True when the host library was built against libjpeg."""
    return bool(library().saragan_have_jpeg())


def decode_jpeg_batch(paths, size: int, channels: int = 3,
                      num_threads: int = 4) -> Optional[np.ndarray]:
    """Decode and resize JPEGs with libjpeg and the C++ triangle resize -> (n, channels,
    size, size) float32 in [-1, 1].  None when a file fails to decode (a non-JPEG file):
    the caller switches to PIL, as the JAX package's pipeline does.  Raises when the
    library has no libjpeg decoder."""
    if not have_jpeg():
        raise RuntimeError("the host library was built without libjpeg "
                           f"({_build.JPEG_HEADER} not found)")
    out = np.empty((len(paths), channels, size, size), np.float32)
    if not paths:
        return out
    rc = library().saragan_jpeg_batch(_paths(paths), len(paths), out.ctypes.data, size,
                                      channels, num_threads)
    return out if rc == 0 else None


def _triangle_filter(in_size: int, out_size: int) -> list:
    """Per output index, (first input index, f32 weights) of PIL's antialiased triangle
    filter, computed as ``build_filter`` in ``csrc/host/saragan_jpeg.cc``: f64 taps stored
    in f32, then each f32 tap divided by the f64 total and stored in f32 again."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    rows = []
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = int(max(0.0, math.floor(center - fscale)))
        hi = int(min(in_size, math.ceil(center + fscale)))
        t = ((torch.arange(lo, hi, dtype=torch.float64) + 0.5 - center) / fscale).abs()
        taps = torch.where(t < 1.0, 1.0 - t, torch.zeros_like(t))
        total = float(taps.sum())
        taps = taps.float()
        if total > 0.0:
            taps = (taps.double() / total).float()
        rows.append((lo, taps))
    return rows


def resize_triangle_plain(img: torch.Tensor, size: int) -> torch.Tensor:
    """Plain PyTorch version of the C++ resize: uint8 (H, W, C) -> (C, size, size) f32 in
    [-1, 1].  The same passes in the same order (horizontal, then vertical, each a f32
    sum over the taps in increasing index, no fused multiply-add), so it matches the C++
    bit for bit."""
    h, w, c = img.shape
    src = img.to(torch.float32)
    tmp = torch.zeros(h, size, c)
    for i, (lo, taps) in enumerate(_triangle_filter(w, size)):
        for k, wk in enumerate(taps):
            tmp[:, i, :] += wk * src[:, lo + k, :]
    out = torch.zeros(size, size, c)
    for j, (lo, taps) in enumerate(_triangle_filter(h, size)):
        for k, wk in enumerate(taps):
            out[j] += wk * tmp[lo + k]
    return (out / 127.5 - 1.0).permute(2, 0, 1).contiguous()
