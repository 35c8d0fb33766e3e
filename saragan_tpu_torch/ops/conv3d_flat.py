"""SAME stride-1 conv3d forward and weight gradient: the hand-written CUDA kernels and
their plain versions.

Replaces the ``pallas`` conv engine of the reference, ``saragan_tpu/ops/pallas_conv.py``:
``conv3d_flat`` (kernel ``_fwd_kernel``) and ``conv3d_flat_wgrad`` (kernel
``_wgrad_kernel``), each by two CUDA kernels chosen by dtype, and the pipelined variant
``conv3d_flat_v2`` (kernel ``_fwd_v2_kernel``) by ``csrc/conv3d_fwd_v2.cu``:

* bf16 (the train step) goes to the tensor-core kernels, route ``"tc"``:
  ``csrc/conv3d_fwd_tc.cu`` and ``csrc/conv3d_wgrad_tc.cu`` (``mma.sync`` bf16, f32
  accumulators).  Their tiling plans are plain Python here (``conv_tc_plan``,
  ``wgrad_tc_plan``), so the CPU tests reach them; the C side re-checks a plan and refuses
  one it cannot run;
* f32 (serving, the f32 train step) stays on the CUDA-core kernels, route ``"simt"``:
  ``csrc/conv3d_fwd.cu`` and ``csrc/conv3d_wgrad.cu``.  Tensor cores in f32 would mean
  TF32, which the port keeps off on purpose.

v2 is standalone, as in the reference, where no conv engine reaches it
(``saragan_tpu/ops/core.py:553``); the port's engines use kernels #1 and #2.  Each source
note says what bounds the kernel on the H100 and how its design differs from the TPU
kernel's flat-padded window.  The derivative algebra that uses them as forward, dgrad and
wgrad is ``ops/conv3d_grad.py``.

Layouts are the reference's: x and dy are NCDHW, w is ``(kd, kh, kw, C, F)``.  Kernel
sizes must be odd: SAME padding is then ``k // 2`` on both sides, which is also what the
reference's flat engine pads.  For even sizes that engine disagrees with SAME, so every
version here refuses them.  x, w and dy share one type, f32 or bf16; every kernel
accumulates in f32 and rounds once at the store.

``conv3d_flat`` and ``conv3d_flat_wgrad`` are the dispatchers: on a CUDA tensor they
launch a kernel (or raise), on a CPU or meta tensor they run the plain version.  Each
kernel wrapper and plain version keeps a plain integer count of its launches / calls so a
run can show which one served it; the kernel wrappers also count by shape (the forward
kernel's keyed by role as well: "forward" for the model's own convs, "dgrad" for those
the backward passes run); ``launches_by_route`` reads the route ("tc" / "simt") off those
counts.  A kernel wrapper called directly
under autograd refuses to build a graph: gradients go through the ``autograd.Function``s
of ``ops/conv3d_grad.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from dataclasses import dataclass
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


# --- tiling plans of the tensor-core kernels (csrc/conv3d_fwd_tc.cu, conv3d_wgrad_tc.cu) ---

MAX_SMEM = 232448                  # shared memory one block can use on the H100
TWO_BLOCKS_SMEM = MAX_SMEM // 2 - 1024  # what lets two blocks share an SM
TC_STAGERS = {"regs": 0, "cpasync": 1}  # csrc/mma_bf16.cuh
MIN_BLOCKS = 2 * 132               # forward: 256-position boxes only where they fill the card
WGRAD_TARGET_BLOCKS = 4 * 132      # pass-1 blocks: four per SM
WGRAD_WORKSPACE_CAP = 8 << 20      # f32 partial sums (32 MB)


def _pow2_ceil(v: int) -> int:
    return 1 << (int(v) - 1).bit_length()


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tc_box(d: int, h: int, w: int, kernel, max_positions: int = 256) -> Tuple[int, int, int]:
    """The (BD, BH, BW) box of positions one tensor-core block stages: `max_positions`
    (256 or 128) where the sample's volume rounded up to powers of two holds them, else
    128, or 16 where it holds no more than 16.  Powers of two; the shape whose halo'd rows
    touch the fewest 32-byte sectors of device memory (plus the box's own positions) per
    position that lies in the volume, then the fewest staged rows, then the widest W."""
    kd, kh, kw = kernel
    room = _pow2_ceil(d) * _pow2_ceil(h) * _pow2_ceil(w)
    positions = 16 if room <= 16 else max_positions if room >= max_positions else 128
    best = None
    for lw in range(positions.bit_length()):
        for lh in range(positions.bit_length() - lw):
            bw, bh = 1 << lw, 1 << lh
            bd = positions // (bw * bh)
            useful = min(bd, d) * min(bh, h) * min(bw, w)
            rows = (bd + kd - 1) * (bh + kh - 1)
            # 16 bf16 per sector; +1 for a row that does not start on a sector
            sectors = -(-2 * (bw + kw - 1) // 32) + 1
            key = ((rows * sectors * 16 + positions) / useful, rows * (bw + kw - 1), -bw)
            if best is None or key < best[0]:
                best = (key, (bd, bh, bw))
    return best[1]


def _boxes(spatial, box) -> Tuple[int, int, int]:
    """Boxes along D, H and W that cover the volume."""
    return tuple(-(-v // b) for v, b in zip(spatial, box))


def _alignment(ptr: int) -> int:
    """The largest power of two up to 16 that divides a device address."""
    return 16 if ptr % 16 == 0 else ptr & -ptr


def _vector_width(w: int, bw: int, align: int) -> int:
    """Widest load of bf16 elements along W (8, 4, 2 or 1) that rows of width `w` from a
    base aligned to `align` bytes allow inside a box `bw` wide."""
    for ve in (8, 4, 2):
        if w % ve == 0 and ve <= bw and align % (2 * ve) == 0:
            return ve
    return 1


def _stage_elems(box, kernel, cc: int) -> int:
    """bf16 elements of one channels-last stage of the halo'd box, as
    csrc/mma_bf16.cuh::BoxGeo lays it."""
    (bd, bh, bw), (kd, kh, kw) = box, kernel
    return _round_up((bd + kd - 1) * (bh + kh - 1) * (bw + kw - 1) * (cc + 8), 8)


def _landing_elems(box, kernel, cc: int, ve: int) -> int:
    """bf16 elements of the cp.async stager's NCDHW landing buffer (BoxGeo.lnd_elems)."""
    (bd, bh, bw), (kd, kh, kw) = box, kernel
    nv = (bw + 2 * _round_up(kw // 2, ve)) // ve
    return cc * (bd + kd - 1) * (bh + kh - 1) * _round_up(nv * ve, 8)


# forward warp layouts by box positions (csrc/conv3d_fwd_tc.cu): 0, four warps along M; 1,
# four warps along N; 2, eight warps along M
_LAYOUTS = {128: 0, 16: 1, 256: 2}


@dataclass(frozen=True)
class ConvTcPlan:
    """How ``csrc/conv3d_fwd_tc.cu`` runs one conv: a block per (sample, box, f tile)."""
    box: Tuple[int, int, int]   # output positions per block (BD, BH, BW)
    boxes: Tuple[int, int, int]  # boxes along D, H, W
    cc: int       # input channels per staged chunk
    chunks: int
    ft: int       # output channels per block
    f_tiles: int
    layout: int   # 0: 128 positions, 4 warps along M; 1: 16, 4 along N; 2: 256, 8 along M
    nt: int       # n8 tiles per warp
    ve: int       # x vector width (elements)
    vw: int       # weight copy: 8 (16-byte cp.async) or 1 (plain loads)
    smem: int     # shared bytes per block
    blocks: int   # grid size, f tiles included


def conv_tc_plan(x_shape, w_shape, x_align: int = 16, w_align: int = 16) -> ConvTcPlan:
    """The forward kernel's plan for x (N,C,D,H,W) and w (kd,kh,kw,C,F); `*_align` are
    the operands' address alignments in bytes.  Prefers the widest output tile, then the
    largest channel chunk, that lets two blocks share an SM; else one block per SM.  The
    x box is staged through registers (the faster stager over the step's shapes,
    PERF.md).  Cached: the wrapper asks for every launch."""
    return _conv_tc_plan(tuple(int(v) for v in x_shape), tuple(int(v) for v in w_shape),
                         int(x_align), int(w_align))


@functools.lru_cache(maxsize=4096)
def _conv_tc_plan(x_shape, w_shape, x_align, w_align) -> ConvTcPlan:
    n, c, d, h, wd = x_shape
    kd, kh, kw, _, f = w_shape
    kernel = (kd, kh, kw)
    taps = kd * kh * kw
    box = tc_box(d, h, wd, kernel)
    if n * math.prod(_boxes((d, h, wd), box)) < MIN_BLOCKS:
        box = tc_box(d, h, wd, kernel, max_positions=128)  # more, smaller blocks
    layout = _LAYOUTS[math.prod(box)]
    ve = _vector_width(wd, box[2], x_align)
    vw = 8 if f % 8 == 0 and w_align % 16 == 0 else 1
    ft_per_nt = 32 if layout == 1 else 8  # warps along N or along M
    nts = (4, 2) if f > 2 * ft_per_nt else (2,)
    ccs = (32, 16) if _round_up(c, 16) >= 32 else (16,)
    fits = []
    for nt in nts:
        for cc in ccs:
            ft = ft_per_nt * nt
            ws = _round_up(taps * cc * (ft + 8), 8)
            smem = (_stage_elems(box, kernel, cc) + 2 * ws) * 2  # one x, two weight stages
            if smem <= MAX_SMEM:
                fits.append((smem > TWO_BLOCKS_SMEM, nt, cc, ft, smem))
    if not fits:
        raise ValueError(f"conv3d_fwd_tc has no tiling that fits shared memory for x "
                         f"{tuple(x_shape)}, w {tuple(w_shape)}")
    _, nt, cc, ft, smem = min(fits, key=lambda t: t[0])  # stable: the preferred order
    boxes = _boxes((d, h, wd), box)
    f_tiles = -(-f // ft)
    return ConvTcPlan(box=box, boxes=boxes, cc=cc, chunks=-(-c // cc), ft=ft, f_tiles=f_tiles,
                      layout=layout, nt=nt, ve=ve, vw=vw, smem=smem,
                      blocks=n * math.prod(boxes) * f_tiles)


@dataclass(frozen=True)
class WgradTcPlan:
    """How ``csrc/conv3d_wgrad_tc.cu`` runs one wgrad: pass-1 blocks per (split, c tile,
    f tile x tap group), each reducing `per_split` consecutive boxes."""
    box: Tuple[int, int, int]
    boxes: Tuple[int, int, int]
    ct: int           # input channels per block
    c_tiles: int
    ft: int           # output channels per block
    f_tiles: int
    tpb: int          # taps per block
    tap_groups: int
    tiles: int        # boxes over the batch
    splits: int
    per_split: int
    stager: str       # x stager: "regs" with 16 outputs per block, "cpasync" with 32
    ve: int
    ve_dy: int
    smem: int
    ws_floats: int    # f32 workspace: splits x taps x C x F


def wgrad_tc_plan(x_shape, dy_shape, kernel, x_align: int = 16,
                  dy_align: int = 16) -> WgradTcPlan:
    """The wgrad kernel's plan for x (N,C,D,H,W), dy (N,F,D,H,W) and a `kernel`-sized
    window.  The x stager follows the output tile: registers with 16 outputs per block,
    cp.async with 32, where the register stager's extra registers would leave one block
    of 256 threads per SM (PERF.md).  The split count is a function of the shapes alone,
    so a given problem always sums in the same order.  Cached."""
    return _wgrad_tc_plan(tuple(int(v) for v in x_shape), int(dy_shape[1]),
                          tuple(int(k) for k in kernel), int(x_align), int(dy_align))


@functools.lru_cache(maxsize=4096)
def _wgrad_tc_plan(x_shape, f, kernel, x_align, dy_align) -> WgradTcPlan:
    n, c, d, h, wd = x_shape
    taps = math.prod(kernel)
    box = tc_box(d, h, wd, kernel, max_positions=128)
    ve = _vector_width(wd, box[2], x_align)
    ve_dy = _vector_width(wd, box[2], dy_align)
    ft = 32 if f > 16 else 16
    # cp.async copies 4, 8 or 16 bytes: vectors of 2 elements or more
    stager = "cpasync" if ft == 32 and ve >= 2 else "regs"
    # jobs of a block, (tap, 16-channel tile) pairs, fill its 8 warps x 4
    ct16 = 1
    while 2 * ct16 * taps <= 32 and 32 * ct16 <= _round_up(c, 16):
        ct16 *= 2
    ct = 16 * ct16
    tpb = min(taps, 32 // ct16)
    c_tiles, f_tiles, tap_groups = -(-c // ct), -(-f // ft), -(-taps // tpb)
    boxes = _boxes((d, h, wd), box)
    tiles = n * math.prod(boxes)
    kcf = taps * c * f
    s = -(-WGRAD_TARGET_BLOCKS // (c_tiles * f_tiles * tap_groups))
    s = min(s, max(1, WGRAD_WORKSPACE_CAP // kcf), tiles)
    per_split = -(-tiles // s)
    splits = -(-tiles // per_split)
    lnd = _landing_elems(box, kernel, ct, ve) if stager == "cpasync" else 0
    smem = (2 * _stage_elems(box, kernel, ct) + 2 * _round_up(ft * (math.prod(box) + 8), 8)
            + lnd) * 2
    if smem > MAX_SMEM:
        raise ValueError(f"conv3d_wgrad_tc has no tiling that fits shared memory for x "
                         f"{tuple(x_shape)}, kernel {kernel}")
    return WgradTcPlan(box=box, boxes=boxes, ct=ct, c_tiles=c_tiles, ft=ft, f_tiles=f_tiles,
                       tpb=tpb, tap_groups=tap_groups, tiles=tiles, splits=splits,
                       per_split=per_split, stager=stager, ve=ve, ve_dy=ve_dy, smem=smem,
                       ws_floats=splits * kcf)


def conv_route(dtype: torch.dtype) -> str:
    """Which kernels serve a dtype: "tc" (tensor cores) for bf16, "simt" (CUDA cores)
    for f32."""
    return "tc" if dtype == torch.bfloat16 else "simt"


def launches_by_route(wrapper) -> Counter:
    """A kernel wrapper's launches by route, read off its ``by_shape`` counts, whose keys
    end with the dtype."""
    routes = Counter()
    for key, launches in wrapper.by_shape.items():
        routes[conv_route(key[-1])] += launches
    return routes


def _raise_on_error(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.saragan_cuda_error_string(err).decode()}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def conv3d_flat_cuda(x: torch.Tensor, w: torch.Tensor, role: str = "forward") -> torch.Tensor:
    """Launch the forward kernel of x's dtype (``conv_route``) on PyTorch's current
    stream.  `role` only labels the launch count ("forward" or "dgrad")."""
    _check_shapes(x, w)
    _check_cuda_operands("conv3d_flat_cuda", (x, w))
    n, c, d, h, wd = x.shape
    kd, kh, kw, _, f = w.shape
    route = conv_route(x.dtype)
    y = torch.empty((n, f, d, h, wd), dtype=x.dtype, device=x.device)
    if route == "tc":
        p = conv_tc_plan(x.shape, w.shape, _alignment(x.data_ptr()), _alignment(w.data_ptr()))
        lib = _fwd_tc_library()
        err = lib.saragan_conv3d_fwd_tc(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), n, c, d, h, wd, kd, kh, kw, f, *p.box,
            p.cc, p.ft, p.layout, p.nt, p.ve, p.vw, p.smem, _stream(x))
    else:
        if kw not in _SUPPORTED_KW:
            raise ValueError(f"kernel width {kw} not in {_SUPPORTED_KW}")
        lib = _fwd_library()
        err = lib.saragan_conv3d_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, c, d, h, wd,
                                     kd, kh, kw, f, _stream(x))
    _raise_on_error(lib, err, f"conv3d_fwd ({route}) launch for x {tuple(x.shape)}, "
                              f"w {tuple(w.shape)}")
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
    """Launch the weight-gradient kernel of x's dtype (``conv_route``; two passes, a fixed
    summation order) on PyTorch's current stream; its f32 workspace comes from PyTorch's
    allocator."""
    _check_wgrad_shapes(x, dy, kernel)
    _check_cuda_operands("conv3d_flat_wgrad_cuda", (x, dy))
    kd, kh, kw = (int(k) for k in kernel)
    n, c, d, h, wd = x.shape
    f = dy.shape[1]
    route = conv_route(x.dtype)
    dw = torch.empty((kd, kh, kw, c, f), dtype=x.dtype, device=x.device)
    if route == "tc":
        p = wgrad_tc_plan(x.shape, dy.shape, (kd, kh, kw), _alignment(x.data_ptr()),
                          _alignment(dy.data_ptr()))
        ws = torch.empty(p.ws_floats, dtype=torch.float32, device=x.device)
        lib = _wgrad_tc_library()
        err = lib.saragan_conv3d_wgrad_tc(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), ws.data_ptr(), p.ws_floats, n, c, d, h,
            wd, kd, kh, kw, f, *p.box, p.ct, p.ft, p.tpb, p.splits, p.per_split,
            TC_STAGERS[p.stager], p.ve, p.ve_dy, p.smem, _stream(x))
    else:
        if kw not in _SUPPORTED_KW:
            raise ValueError(f"kernel width {kw} not in {_SUPPORTED_KW}")
        lib = _wgrad_library()
        floats = lib.saragan_conv3d_wgrad_workspace_floats(n, c, d, h, wd, kd, kh, kw, f)
        if floats < 0:
            raise ValueError(f"conv3d_wgrad does not take x {tuple(x.shape)}, dy "
                             f"{tuple(dy.shape)}, kernel {(kd, kh, kw)}")
        ws = torch.empty(floats, dtype=torch.float32, device=x.device)
        err = lib.saragan_conv3d_wgrad(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                                       ws.data_ptr(), floats, n, c, d, h, wd, kd, kh, kw, f,
                                       _stream(x))
    _raise_on_error(lib, err, f"conv3d_wgrad ({route}) launch for x {tuple(x.shape)}, dy "
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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_tc_library() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_fwd_tc")
    fn = lib.saragan_conv3d_fwd_tc
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 18 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_tc_library() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_wgrad_tc")
    fn = lib.saragan_conv3d_wgrad_tc
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 15
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
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
