"""Space-to-depth packing of the 3-D conv (counterpart of ``saragan_tpu/ops/core.py:441-545``,
the reference's ``s2d`` engine).

Folding each 2x2x2 block of voxels into the channels turns a SAME stride-1 conv of
x (N, C, D, H, W) into a conv of the folded (N, 8C, D/2, H/2, W/2) with a folded kernel
(kq, kq, kq, 8C, 8F): both maps are linear, so the rewrite is exact; each folded weight
entry is a copy of one entry of w or zero, and the folded conv sums eight times as many
terms, most of them zero.  The folded conv is the library's (cuDNN on the card) and
autograd differentiates the fold, the weight fold and the conv to any order.

Applicable (``s2d_applicable``) to a 3-D kernel larger than 1x1x1 whose every size is odd,
at most `max_cin` input channels and even spatial sizes: the reference's rule plus odd
kernels, because its expansion assumes k // 2 zeros before each axis, which is SAME
padding only for odd k (its even kernels diverge from the direct conv, ADVICE.md).  A conv
that is not applicable takes the direct conv.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def s2d_fold(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(N, C, D, H, W) -> (N, C f^3, D/f, H/f, W/f); folded channel c f^3 + (pz f^2 + py f +
    px), p the voxel's place in its block."""
    n, c, d, h, w = x.shape
    x = x.reshape(n, c, d // f, f, h // f, f, w // f, f).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(n, c * f ** 3, d // f, h // f, w // f)


def s2d_unfold(y: torch.Tensor, f: int = 2) -> torch.Tensor:
    """The inverse of ``s2d_fold``."""
    n, cf, db, hb, wb = y.shape
    y = y.reshape(n, cf // f ** 3, f, f, f, db, hb, wb).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return y.reshape(n, cf // f ** 3, db * f, hb * f, wb * f)


@functools.lru_cache(maxsize=None)
def s2d_expansion(k: int, f: int):
    """One axis's expansion E (kq, f, f, k) and the folded conv's padding (lo, hi): output
    voxel f zb + p reads x[f zb + p + dz - k // 2]; with p + dz - k // 2 = f q + r, r in
    [0, f), the folded tap is q, so E[j, p, r, dz] = 1 iff dz = f (j + q_min) + r - p +
    k // 2, the taps q spanning [q_min, q_max] (the reference's ``_s2d_expansion``)."""
    pad = k // 2
    vals = [p + dz - pad for p in range(f) for dz in range(k)]
    q_min = min(v // f for v in vals)
    q_max = max(v // f for v in vals)
    e = np.zeros((q_max - q_min + 1, f, f, k), np.float32)
    for j in range(e.shape[0]):
        for p in range(f):
            for r in range(f):
                dz = f * (j + q_min) + r - p + pad
                if 0 <= dz < k:
                    e[j, p, r, dz] = 1.0
    return e, (-q_min, q_max)


@functools.lru_cache(maxsize=None)
def _expansion_tensor(k: int, f: int, dtype: torch.dtype, device: torch.device):
    return torch.as_tensor(s2d_expansion(k, f)[0], dtype=dtype, device=device)


def s2d_fold_weight(w: torch.Tensor, f: int = 2):
    """(kd, kh, kw, C, F) -> the folded (kqd, kqh, kqw, C f^3, F f^3) in w's dtype, and the
    folded conv's (lo, hi) padding per axis."""
    kd, kh, kw, c, fo = w.shape
    ed, eh, ew = (_expansion_tensor(int(k), f, w.dtype, w.device) for k in (kd, kh, kw))
    wf = torch.einsum("aprd,bqse,gtuh,dehio->abgirsuopqt", ed, eh, ew, w)
    wf = wf.reshape(ed.shape[0], eh.shape[0], ew.shape[0], c * f ** 3, fo * f ** 3)
    return wf, tuple(s2d_expansion(int(k), f)[1] for k in (kd, kh, kw))


def s2d_applicable(x: torch.Tensor, w: torch.Tensor, max_cin: int) -> bool:
    """Whether ``conv3d_s2d`` takes the conv of x with w (module docstring)."""
    kernel = tuple(int(k) for k in w.shape[:3])
    return (x.ndim == 5 and math.prod(kernel) > 1 and all(k % 2 for k in kernel)
            and x.shape[1] <= max_cin and all(s % 2 == 0 for s in x.shape[2:]))


def conv3d_s2d(x: torch.Tensor, w: torch.Tensor, f: int = 2) -> torch.Tensor:
    """conv(x, w) == unfold(conv_folded(fold(x), fold_weight(w))) for an applicable conv;
    w (kd, kh, kw, C, F) of x's dtype."""
    wf, pads = s2d_fold_weight(w, f)
    # odd kernels fold to symmetric padding
    y = F.conv3d(s2d_fold(x, f), wf.permute(4, 3, 0, 1, 2), padding=[lo for lo, _ in pads])
    return s2d_unfold(y, f)
