"""SAME stride-1 conv3d forward and weight gradient: the hand-written CUDA kernels and
their plain versions.

Replaces the ``pallas`` conv engine of the reference, ``saragan_tpu/ops/pallas_conv.py``:
``conv3d_flat`` (kernel ``_fwd_kernel``), ``conv3d_flat_wgrad`` (kernel ``_wgrad_kernel``)
and the pipelined variant ``conv3d_flat_v2`` (kernel ``_fwd_v2_kernel``), each by two CUDA
kernels chosen by dtype:

* bf16 (the train step) goes to the tensor-core kernels, route ``"tc"``:
  ``csrc/conv3d_fwd_tc.cu``, ``csrc/conv3d_wgrad_tc.cu`` and ``csrc/conv3d_fwd_v2_tc.cu``
  (``mma.sync`` bf16, f32 accumulators);
* f32 (serving, the f32 train step) goes to the CUDA-core kernels, route ``"simt"``:
  ``csrc/conv3d_fwd.cu``, ``csrc/conv3d_wgrad.cu`` and ``csrc/conv3d_fwd_v2.cu``.  Tensor
  cores in f32 would mean TF32, which the port keeps off on purpose.

Every kernel's tiling plan is plain Python here (``conv_tc_plan``, ``wgrad_tc_plan``,
``conv_simt_plan``, ``wgrad_simt_plan``, ``conv_v2_tc_plan``, ``conv_v2_simt_plan``), so
the CPU tests reach them; the C side re-checks a plan and refuses one it cannot run.

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
import dataclasses
import functools
import math
from collections import Counter
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from saragan_tpu_torch.ops import _build

_SUPPORTED_KW = (1, 3, 5, 7)
_DTYPES = (torch.float32, torch.bfloat16)  # what the kernels take


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
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
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


def _best_box(d: int, h: int, w: int, kernel, positions: int, per_sector: int,
              min_bw: int = 1) -> Tuple[int, int, int]:
    """The (BD, BH, BW) box of `positions` outputs (powers of two, BW >= `min_bw`) whose
    halo'd rows touch the fewest 32-byte sectors of device memory (`per_sector` elements
    each; plus the box's own positions) per position that lies in the volume, then the
    fewest staged elements, then the widest W."""
    kd, kh, kw = kernel
    best = None
    for lw in range(min_bw.bit_length() - 1, positions.bit_length()):
        for lh in range(positions.bit_length() - lw):
            bw, bh = 1 << lw, 1 << lh
            bd = positions // (bw * bh)
            useful = min(bd, d) * min(bh, h) * min(bw, w)
            rows = (bd + kd - 1) * (bh + kh - 1)
            # +1 for a row that does not start on a sector
            sectors = -(-(bw + kw - 1) // per_sector) + 1
            key = ((rows * sectors * per_sector + positions) / useful, rows * (bw + kw - 1), -bw)
            if best is None or key < best[0]:
                best = (key, (bd, bh, bw))
    return best[1]


def tc_box(d: int, h: int, w: int, kernel, max_positions: int = 256) -> Tuple[int, int, int]:
    """The box of positions one tensor-core block stages (``_best_box``, 16 bf16 per
    sector): `max_positions` (256 or 128) where the sample's volume rounded up to powers of
    two holds them, else 128, or 16 where it holds no more than 16."""
    room = _pow2_ceil(d) * _pow2_ceil(h) * _pow2_ceil(w)
    positions = 16 if room <= 16 else max_positions if room >= max_positions else 128
    return _best_box(d, h, w, kernel, positions, 16)


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


# --- tiling plan of the CUDA-core forward kernel (csrc/conv3d_fwd.cu) ---

# register tiles (outputs along W, output channels per thread), widest first, each with the
# least outputs (positions x F) a sample must have to take it: narrower tiles on smaller
# volumes, so that a batch still runs warps enough to hide latency
SIMT_TILES = {(8, 8): 1 << 19, (4, 4): 1 << 17, (4, 2): 1 << 14, (4, 1): 0}
SIMT_THREADS = {8: 256, 4: 128}  # most threads per block, by tile width
SIMT_BLOCKS_PER_SM = {8: 2, 4: 4}  # what the plan's shared memory leaves room for
SIMT_MAX_FT = 32                 # most output channels per block


def _simt_tile(outputs: int, w: int) -> Tuple[int, int]:
    """The widest register tile a sample of `outputs` outputs and width `w` takes (8 x 8
    only where W >= 8)."""
    for (vpt, fpt), least in SIMT_TILES.items():
        if outputs >= least and w >= vpt:
            return vpt, fpt
    return 4, 1


def simt_box(d: int, h: int, w: int, kernel, positions: int, vpt: int) -> Tuple[int, int, int]:
    """The box of `positions` outputs one CUDA-core block owns (``_best_box``, 8 floats
    per sector), BW a multiple of `vpt`."""
    return _best_box(d, h, w, kernel, positions, 8, vpt)


@dataclass(frozen=True)
class ConvSimtPlan:
    """How ``csrc/conv3d_fwd.cu`` runs one f32 conv: a block per (sample, box, f tile)."""
    box: Tuple[int, int, int]    # output positions per block (BD, BH, BW)
    boxes: Tuple[int, int, int]  # boxes along D, H, W (per sample)
    cc: int        # input channels per staged chunk
    chunks: int
    ft: int        # output channels per block
    f_tiles: int
    vpt: int       # consecutive W outputs per thread
    fpt: int       # output channels per thread
    threads: int
    vw: int        # weight copy: 4 (16-byte cp.async) or 1
    smem: int      # shared bytes per block: two stages of x box and weights, the row table


def conv_simt_plan(x_shape, w_shape, w_align: int = 16) -> ConvSimtPlan:
    """The CUDA-core forward kernel's plan for x (N,C,D,H,W) and w (kd,kh,kw,C,F);
    `w_align` is the weights' address alignment in bytes.  A function of one sample's
    shape: the batch size never enters it (nor does any sum order, which is fixed:
    channel by channel, tap by tap).  The register tile by a sample's outputs
    (``SIMT_TILES``); the box fitted to the volume; the largest channel chunk whose two
    stages leave room for ``SIMT_BLOCKS_PER_SM`` blocks.  Cached: the wrapper asks for
    every launch."""
    return _conv_simt_plan(tuple(int(v) for v in x_shape[1:]), tuple(int(v) for v in w_shape),
                           int(w_align))


@functools.lru_cache(maxsize=4096)
def _conv_simt_plan(sample_shape, w_shape, w_align) -> ConvSimtPlan:
    c, d, h, wd = sample_shape
    kd, kh, kw, _, f = w_shape
    kernel = (kd, kh, kw)
    taps = kd * kh * kw
    vpt, fpt = _simt_tile(d * h * wd * f, wd)
    ft = max(4, fpt, min(_pow2_ceil(f), SIMT_MAX_FT))
    room = _pow2_ceil(d) * _pow2_ceil(h) * max(_pow2_ceil(wd), vpt)
    positions = min(SIMT_THREADS[vpt] // (ft // fpt) * vpt, room)
    box = simt_box(d, h, wd, kernel, positions, vpt)
    sd, sh, rs = box[0] + kd - 1, box[1] + kh - 1, (box[2] + kw - 1) | 1
    budget = MAX_SMEM // SIMT_BLOCKS_PER_SM[vpt] - 1024
    cc = _pow2_ceil(c)
    while True:  # two stages and the row table (csrc/conv3d_fwd.cu: Geo)
        smem = 2 * (_round_up(cc * sd * sh * rs, 4) + taps * cc * ft) * 4 + cc * sd * sh * 8
        if smem <= budget or cc == 1:
            break
        cc //= 2
    if smem > MAX_SMEM:
        raise ValueError(f"conv3d_fwd has no tiling that fits shared memory for x "
                         f"{sample_shape}, w {tuple(w_shape)}")
    vw = 4 if f % 4 == 0 and w_align % 16 == 0 else 1
    return ConvSimtPlan(box=box, boxes=_boxes((d, h, wd), box), cc=cc, chunks=-(-c // cc),
                        ft=ft, f_tiles=-(-f // ft), vpt=vpt, fpt=fpt,
                        threads=(math.prod(box) // vpt) * (ft // fpt), vw=vw, smem=smem)


# --- tiling plans of the pipelined variant #3 (csrc/conv3d_fwd_v2_tc.cu, conv3d_fwd_v2.cu) ---

V2_STAGES = 3      # the ring of (item, chunk) stages in shared memory
H100_SMS = 132     # streaming multiprocessors: the wrappers ask the device (``_sm_count``)


def v2_tc_box(d: int, h: int, w: int, kernel) -> Tuple[int, int, int]:
    """The box of positions one tensor-core v2 work item owns: 256 positions where the
    sample's volume rounded up to powers of two holds them, 16 where it holds no more than
    16, else 128; of those shapes the one that stages the fewest positions (x is staged
    channels-last, so a staged position costs the same wherever it lies) per position in
    the volume, then the widest W."""
    room = _pow2_ceil(d) * _pow2_ceil(h) * _pow2_ceil(w)
    positions = 16 if room <= 16 else 256 if room >= 256 else 128
    kd, kh, kw = kernel
    best = None
    for lw in range(positions.bit_length()):
        for lh in range(positions.bit_length() - lw):
            bw, bh = 1 << lw, 1 << lh
            bd = positions // (bw * bh)
            useful = min(bd, d) * min(bh, h) * min(bw, w)
            key = ((bd + kd - 1) * (bh + kh - 1) * (bw + kw - 1) / useful, -bw)
            if best is None or key < best[0]:
                best = (key, (bd, bh, bw))
    return best[1]


@dataclass(frozen=True)
class ConvV2TcPlan:
    """How ``csrc/conv3d_fwd_v2_tc.cu`` runs one bf16 conv: `blocks` persistent blocks walk
    the work items (sample, box, f tile) in channel chunks, through a ring of
    ``V2_STAGES`` shared-memory stages."""
    box: Tuple[int, int, int]
    boxes: Tuple[int, int, int]
    cc: int        # input channels per chunk (16 or 32)
    chunks: int
    cp: int        # channels of the channels-last copy of x: C rounded up to 8
    ft: int        # output channels per item
    f_tiles: int
    layout: int    # as ConvTcPlan.layout
    nt: int        # n8 tiles per warp
    vw: int        # weight copy: 8 (16-byte cp.async) or 1 (plain loads)
    resident: int  # 1: one chunk; the block's weights are staged once, outside the ring
    smem: int      # shared bytes per block
    items: int     # n * boxes * f_tiles
    blocks: int    # the persistent grid: one or two blocks per SM


def conv_v2_tc_plan(x_shape, w_shape, w_align: int = 16, sms: int = H100_SMS) -> ConvV2TcPlan:
    """The tensor-core v2 kernel's plan for x (N,C,D,H,W) and w (kd,kh,kw,C,F); `w_align`
    is the weights' address alignment in bytes, `sms` the card's SM count.  The box, the
    chunk and the tiles come from one sample's shape alone, so the summation order (chunks
    in order, (tap, 16 channels) k steps within one) never depends on the batch; the batch
    sets only the item count and the grid.  Prefers, as ``conv_tc_plan`` does, the widest
    output tile, then the largest chunk, that lets two blocks share an SM.  Cached."""
    t = _v2_tc_tiling(tuple(int(v) for v in x_shape[1:]), tuple(int(v) for v in w_shape),
                      8 if int(w_shape[4]) % 8 == 0 and int(w_align) % 16 == 0 else 1)
    items = int(x_shape[0]) * t.items
    blocks = min(items, (2 if t.smem <= TWO_BLOCKS_SMEM else 1) * int(sms))
    if t.resident:  # each block keeps one f tile: the grid is a multiple of the f tiles
        blocks = max(t.f_tiles, blocks // t.f_tiles * t.f_tiles)
    return dataclasses.replace(t, items=items, blocks=blocks)


@functools.lru_cache(maxsize=4096)
def _v2_tc_tiling(sample_shape, w_shape, vw) -> ConvV2TcPlan:
    c, d, h, wd = sample_shape
    kd, kh, kw, _, f = w_shape
    kernel = (kd, kh, kw)
    taps = kd * kh * kw
    box = v2_tc_box(d, h, wd, kernel)
    layout = _LAYOUTS[math.prod(box)]
    ft_per_nt = 32 if layout == 1 else 8  # warps along N or along M
    nts = (4, 2) if f > 2 * ft_per_nt else (2,)
    ccs = (32, 16) if _round_up(c, 16) >= 32 else (16,)
    spos = (box[0] + kd - 1) * (box[1] + kh - 1) * (box[2] + kw - 1)  # the position table
    fits = []
    for nt in nts:
        for cc in ccs:
            ft = ft_per_nt * nt
            resident = int(c <= cc)
            ws = _round_up(taps * cc * (ft + 8), 8)
            stage = _stage_elems(box, kernel, cc) + (0 if resident else ws)
            smem = (resident * ws + V2_STAGES * stage) * 2 + 4 * spos
            if smem <= MAX_SMEM:
                fits.append((smem > TWO_BLOCKS_SMEM, nt, cc, ft, resident, smem))
    if not fits:
        raise ValueError(f"conv3d_fwd_v2_tc has no tiling that fits shared memory for x "
                         f"{sample_shape}, w {tuple(w_shape)}")
    _, nt, cc, ft, resident, smem = min(fits, key=lambda t: t[0])  # stable: preferred order
    boxes = _boxes((d, h, wd), box)
    return ConvV2TcPlan(box=box, boxes=boxes, cc=cc, chunks=-(-c // cc), cp=_round_up(c, 8),
                        ft=ft, f_tiles=-(-f // ft), layout=layout, nt=nt, vw=vw,
                        resident=resident, smem=smem, items=math.prod(boxes) * -(-f // ft),
                        blocks=0)


@dataclass(frozen=True)
class ConvV2SimtPlan:
    """How ``csrc/conv3d_fwd_v2.cu`` runs one f32 conv: `blocks` persistent blocks walk the
    work items (sample, box, f tile) in channel chunks, through a ring of ``V2_STAGES``
    shared-memory stages."""
    box: Tuple[int, int, int]
    boxes: Tuple[int, int, int]
    cc: int
    chunks: int
    ft: int
    f_tiles: int
    vpt: int
    fpt: int
    threads: int
    vw: int        # weight copy: 4 (16-byte cp.async) or 1
    smem: int      # the ring's stages and the row table
    items: int
    blocks: int


def conv_v2_simt_plan(x_shape, w_shape, w_align: int = 16,
                      sms: int = H100_SMS) -> ConvV2SimtPlan:
    """The CUDA-core v2 kernel's plan for x (N,C,D,H,W) and w (kd,kh,kw,C,F): the register
    tile and box of ``conv_simt_plan`` (one sample's shape alone), the largest channel
    chunk whose ``V2_STAGES`` stages leave room for ``SIMT_BLOCKS_PER_SM`` blocks, and a
    grid of that many blocks per SM.  Each output sums channel by channel, tap by tap,
    whatever the plan.  Cached."""
    tiling = _v2_simt_tiling(tuple(int(v) for v in x_shape[1:]),
                             tuple(int(v) for v in w_shape),
                             4 if int(w_shape[4]) % 4 == 0 and int(w_align) % 16 == 0 else 1)
    items = int(x_shape[0]) * tiling.items
    return dataclasses.replace(
        tiling, items=items, blocks=min(items, SIMT_BLOCKS_PER_SM[tiling.vpt] * int(sms)))


@functools.lru_cache(maxsize=4096)
def _v2_simt_tiling(sample_shape, w_shape, vw) -> ConvV2SimtPlan:
    c, d, h, wd = sample_shape
    kd, kh, kw, _, f = w_shape
    p = _conv_simt_plan(sample_shape, w_shape, 16)  # its tile, box and output tile
    taps = kd * kh * kw
    sd, sh, rs = p.box[0] + kd - 1, p.box[1] + kh - 1, (p.box[2] + kw - 1) | 1
    budget = MAX_SMEM // SIMT_BLOCKS_PER_SM[p.vpt] - 1024
    cc = _pow2_ceil(c)
    while True:  # the ring's stages and the row table (csrc/conv3d_fwd_v2.cu: Geo)
        smem = V2_STAGES * (_round_up(cc * sd * sh * rs, 4) + taps * cc * p.ft) * 4 + cc * sd * sh * 4
        if smem <= budget or cc == 1:
            break
        cc //= 2
    if smem > MAX_SMEM:
        raise ValueError(f"conv3d_fwd_v2 has no tiling that fits shared memory for x "
                         f"{sample_shape}, w {tuple(w_shape)}")
    return ConvV2SimtPlan(box=p.box, boxes=p.boxes, cc=cc, chunks=-(-c // cc), ft=p.ft,
                          f_tiles=p.f_tiles, vpt=p.vpt, fpt=p.fpt, threads=p.threads, vw=vw,
                          smem=smem, items=math.prod(p.boxes) * p.f_tiles, blocks=0)


# --- tiling plan of the CUDA-core wgrad kernel (csrc/conv3d_wgrad.cu) ---

WGRAD_SIMT_THREADS = 384  # most threads per block (csrc/conv3d_wgrad.cu: MAX_THREADS)
WGRAD_SIMT_FPT = 8        # outputs per thread
SM_THREADS = 2048         # resident threads per SM
SM_REGS = 65536           # registers per SM; the kernel holds at most 128 a thread
WGRAD_SIMT_WORKSPACE_CAP = 16 << 20  # f32 partial sums (64 MB)
WGRAD_REDUCE_GROUP = 32   # slots per partial sum of pass 2 (csrc/conv3d_wgrad.cu)


@dataclass(frozen=True)
class WgradSimtPlan:
    """How ``csrc/conv3d_wgrad.cu`` runs one f32 wgrad: pass-1 blocks per (split, c tile,
    f tile), each reducing `per_split` consecutive position boxes, its threads split into
    `pg` position groups, each (split, position group) into its own workspace slot."""
    box: Tuple[int, int, int]
    boxes: Tuple[int, int, int]
    ct: int          # input channels per block
    c_tiles: int
    ft: int          # output channels per block (8 per thread)
    f_tiles: int
    pg: int          # position groups per block
    ry: int          # tap rows (ky) per thread: 3 where kh % 3 == 0 and kw <= 3, else 1
    vpt: int         # W positions per inner step: 8 where the box is 8 wide or more, else 4
    threads: int
    tiles: int       # boxes over the batch
    splits: int
    per_split: int
    vx: int          # x copy: 4 floats (16-byte cp.async) or 1
    vdy: int         # dy copy: 4 floats or 1
    smem: int        # two stages of x and dy boxes, the row table
    ws_floats: int   # f32 workspace: (slots + groups) x taps x C x F, slots = splits x pg,
                     # groups of 32 slots summed first where there are more than 32


def _wgrad_x_stride(box, kernel) -> int:
    """Floats per staged channel of the CUDA-core wgrad's x box (csrc/conv3d_wgrad.cu:
    Geo.CS): rows of BW + 8 floats at a stride of an odd count of 16-byte words, an odd
    count of rows per plane, and the channel stride congruent to KD planes mod 8 words."""
    (bd, bh, bw), (kd, kh, _) = box, kernel
    sd, shs, rq = bd + kd - 1, (bh + kh - 1) | 1, (bw + 8) // 4 | 1
    box_q = sd * shs * rq
    return 4 * (box_q + (kd * shs * rq - box_q) % 8)


def wgrad_simt_plan(x_shape, dy_shape, kernel, x_align: int = 16,
                    dy_align: int = 16) -> WgradSimtPlan:
    """The CUDA-core wgrad kernel's plan for x (N,C,D,H,W), dy (N,F,D,H,W) and a
    `kernel`-sized window.  Box, tiles, position groups and split are functions of the
    shapes alone, so a given problem always sums in the same order; the operands'
    alignments pick only their copy widths.  Prefers blocks of at least 128 threads, then
    the most threads an SM holds at once (up to 384), then the fewest positions outside
    the volume, then the fewest staged x floats per position (the most cube-like box: in
    a sweep of boxes on the card, 4 x 4 x 16 was the fastest or within noise of it at the
    step's 32²-128² shapes, PERF.md), then the most channels and position groups.
    Cached."""
    tiling = _wgrad_simt_tiling(tuple(int(v) for v in x_shape), int(dy_shape[1]),
                                tuple(int(k) for k in kernel))
    wide = int(x_shape[4]) % 4 == 0
    return dataclasses.replace(tiling, vx=4 if wide and int(x_align) % 16 == 0 else 1,
                               vdy=4 if wide and int(dy_align) % 16 == 0 else 1)


@functools.lru_cache(maxsize=4096)
def _wgrad_simt_tiling(x_shape, f, kernel) -> WgradSimtPlan:
    n, c, d, h, wd = x_shape
    kd, kh, kw = kernel
    taps = kd * kh * kw
    ry = 3 if kh % 3 == 0 and kw <= 3 else 1
    ft = 32 if f > 16 else 16 if f > 8 else 8
    room = _pow2_ceil(d) * _pow2_ceil(h) * max(_pow2_ceil(wd), 4)
    cands = []
    for positions in {min(128, room), min(256, room)}:
        for lw in range(2, positions.bit_length()):  # BW >= 4
            for lh in range(positions.bit_length() - lw):
                box = (positions // (1 << (lw + lh)), 1 << lh, 1 << lw)
                useful = min(box[0], d) * min(box[1], h) * min(box[2], wd)
                rows = (box[0] + kd - 1) * (box[1] + kh - 1)
                staged = rows * (box[2] + 8)  # x floats staged per channel
                cs = _wgrad_x_stride(box, kernel)
                ct = min(_pow2_ceil(c), 64)
                while ct >= 1:
                    pg = box[0] * box[1]
                    while pg >= 1:
                        threads = (ft // WGRAD_SIMT_FPT) * pg * ct * kd * (kh // ry)
                        smem = 2 * (ct * cs + ft * positions) * 4 + ct * rows * 4
                        if threads <= WGRAD_SIMT_THREADS and smem <= MAX_SMEM:
                            per_sm = min(MAX_SMEM // (smem + 1024), SM_THREADS // threads,
                                         SM_REGS // (128 * threads))
                            key = (threads < 128, -min(per_sm * threads, 384),
                                   positions / useful, staged / useful, -ct, -pg, -box[2])
                            cands.append((key, box, ct, pg, threads, smem))
                        pg //= 2
                    ct //= 2
    if not cands:
        raise ValueError(f"conv3d_wgrad has no tiling that fits for x {tuple(x_shape)}, "
                         f"kernel {kernel}")
    _, box, ct, pg, threads, smem = min(cands, key=lambda t: t[0])
    c_tiles, f_tiles = -(-c // ct), -(-f // ft)
    boxes = _boxes((d, h, wd), box)
    tiles = n * math.prod(boxes)
    kcf = taps * c * f
    s = -(-WGRAD_TARGET_BLOCKS // (c_tiles * f_tiles))
    s = min(s, max(1, WGRAD_SIMT_WORKSPACE_CAP // (pg * kcf)), tiles)
    per_split = -(-tiles // s)
    splits = -(-tiles // per_split)
    groups = -(-splits * pg // WGRAD_REDUCE_GROUP)
    return WgradSimtPlan(box=box, boxes=boxes, ct=ct, c_tiles=c_tiles, ft=ft, f_tiles=f_tiles,
                         pg=pg, ry=ry, vpt=min(box[2], 8), threads=threads, tiles=tiles,
                         splits=splits,
                         per_split=per_split, vx=4, vdy=4, smem=smem,
                         ws_floats=(splits * pg + (groups if groups > 1 else 0)) * kcf)


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
        p = conv_simt_plan(x.shape, w.shape, _alignment(w.data_ptr()))
        lib = _fwd_library()
        err = lib.saragan_conv3d_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, c, d, h, wd,
                                     kd, kh, kw, f, *p.box, p.cc, p.ft, p.vpt, p.fpt, p.vw,
                                     p.smem, _stream(x))
    _raise_on_error(lib, err, f"conv3d_fwd ({route}) launch for x {tuple(x.shape)}, "
                              f"w {tuple(w.shape)}")
    conv3d_flat_cuda.launches += 1
    conv3d_flat_cuda.by_shape[(role, tuple(x.shape), tuple(w.shape), x.dtype)] += 1
    return y


conv3d_flat_cuda.launches = 0
conv3d_flat_cuda.by_shape = Counter()  # (role, x shape, w shape, dtype) -> launches


def conv3d_flat_v2_cuda(x: torch.Tensor, w: torch.Tensor, role: str = "forward") -> torch.Tensor:
    """Launch the pipelined forward kernel of x's dtype (``conv_route``: bf16
    ``csrc/conv3d_fwd_v2_tc.cu`` with its channels-last pass into a scratch buffer from
    PyTorch's allocator, f32 ``csrc/conv3d_fwd_v2.cu``) on PyTorch's current stream.
    `role` only labels the launch count ("forward" or "dgrad")."""
    _check_shapes(x, w)
    _check_cuda_operands("conv3d_flat_v2_cuda", (x, w))
    n, c, d, h, wd = x.shape
    kd, kh, kw, _, f = w.shape
    route = conv_route(x.dtype)
    y = torch.empty((n, f, d, h, wd), dtype=x.dtype, device=x.device)
    if route == "tc":
        p = conv_v2_tc_plan(x.shape, w.shape, _alignment(w.data_ptr()), _sm_count(x.device))
        xcl = torch.empty(n * d * h * wd * p.cp, dtype=x.dtype, device=x.device)
        lib = _v2_tc_library()
        err = lib.saragan_conv3d_fwd_v2_tc(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), xcl.data_ptr(), n, c, d, h, wd, kd, kh, kw,
            f, *p.box, p.cc, p.ft, p.layout, p.nt, p.vw, p.resident, p.blocks, p.smem,
            _stream(x))
    else:
        if kw not in _SUPPORTED_KW:
            raise ValueError(f"kernel width {kw} not in {_SUPPORTED_KW}")
        p = conv_v2_simt_plan(x.shape, w.shape, _alignment(w.data_ptr()), _sm_count(x.device))
        lib = _v2_library()
        err = lib.saragan_conv3d_fwd_v2(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, c, d, h,
                                        wd, kd, kh, kw, f, *p.box, p.cc, p.ft, p.vpt, p.fpt,
                                        p.vw, p.blocks, p.smem, _stream(x))
    _raise_on_error(lib, err, f"conv3d_fwd_v2 ({route}) launch for x {tuple(x.shape)}, "
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
        p = wgrad_simt_plan(x.shape, dy.shape, (kd, kh, kw), _alignment(x.data_ptr()),
                            _alignment(dy.data_ptr()))
        ws = torch.empty(p.ws_floats, dtype=torch.float32, device=x.device)
        lib = _wgrad_library()
        err = lib.saragan_conv3d_wgrad(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), ws.data_ptr(), p.ws_floats, n, c, d, h,
            wd, kd, kh, kw, f, *p.box, p.ct, p.ft, p.pg, p.ry, p.vpt, p.splits, p.per_split,
            p.vx, p.vdy, p.smem, _stream(x))
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
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
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
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 18 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _v2_tc_library() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_fwd_v2_tc")
    fn = lib.saragan_conv3d_fwd_v2_tc
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_library() -> ctypes.CDLL:
    lib = _build.load_library("conv3d_wgrad")
    fn = lib.saragan_conv3d_wgrad
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 18
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.saragan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.saragan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device: the v2 kernels' persistent grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
