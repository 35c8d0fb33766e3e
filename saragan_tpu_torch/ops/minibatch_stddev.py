"""Minibatch standard-deviation statistic: the Triton kernel and its plain version.

Replaces ``saragan_tpu/ops/pallas_kernels.py::minibatch_stddev_stat`` (Pallas body
``_mbstd_kernel``): for x of shape (N, ...) and G = min(group_size, N), the samples form
N / G groups, interleaved as the reference reshapes them (``reshape(G, groups, F)``, so
group m holds samples m, m + groups, m + 2 groups, ...).  Per group, in f32: the mean over
the group, the biased variance, ``sqrt(var + eps)``, then the mean over all F features.
The result is (groups, 1) f32.  As in the reference it is standalone: no discriminator of
either package calls it (the reference's ``minibatch_stddev_layer`` is plain jnp, and
this kernel has no gradient).

What bounds it on the H100: one pass over the bytes of x with a few operations per
element, so device memory.  A reduction, hence Triton.  Pass 1: program (m, j) loads the
G samples of group m over BLOCK_F features, reduces over the group and writes the block's
sum of the per-feature stddevs to a workspace.  Pass 2: program m sums its workspace row
in a fixed order and divides by F.  No atomics, so a rerun is bit-identical.
"""

from __future__ import annotations

import functools

import torch

_BLOCK_F = 1024
_BLOCK_R = 1024


def _groups(x: torch.Tensor, group_size: int):
    n = x.shape[0]
    g = min(group_size, n)
    if g < 1 or n % g:
        raise ValueError(f"batch {n} is not a multiple of the group size {g}")
    return g, n // g


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
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def mbstd_partial_kernel(x_ptr, ws_ptr, FEAT, GROUPS, NBLK, eps,
                             G: tl.constexpr, BLOCK_F: tl.constexpr):
        m = tl.program_id(0)
        j = tl.program_id(1)
        offs = j * BLOCK_F + tl.arange(0, BLOCK_F)
        mask = offs < FEAT
        s1 = tl.zeros((BLOCK_F,), tl.float32)
        for i in tl.static_range(G):
            row = (i * GROUPS + m).to(tl.int64) * FEAT
            s1 += tl.load(x_ptr + row + offs, mask=mask, other=0.0).to(tl.float32)
        mu = s1 / G
        s2 = tl.zeros((BLOCK_F,), tl.float32)
        for i in tl.static_range(G):
            row = (i * GROUPS + m).to(tl.int64) * FEAT
            d = tl.load(x_ptr + row + offs, mask=mask, other=0.0).to(tl.float32) - mu
            s2 += d * d
        sd = tl.sqrt(s2 / G + eps)
        sd = tl.where(mask, sd, 0.0)
        tl.store(ws_ptr + m * NBLK + j, tl.sum(sd, axis=0))

    @triton.jit
    def mbstd_reduce_kernel(ws_ptr, out_ptr, NBLK, FEAT, BLOCK_R: tl.constexpr):
        m = tl.program_id(0)
        acc = tl.zeros((BLOCK_R,), tl.float32)
        for start in range(0, NBLK, BLOCK_R):
            offs = start + tl.arange(0, BLOCK_R)
            acc += tl.load(ws_ptr + m * NBLK + offs, mask=offs < NBLK, other=0.0)
        tl.store(out_ptr + m, tl.sum(acc, axis=0) / FEAT)

    return mbstd_partial_kernel, mbstd_reduce_kernel


def minibatch_stddev_stat_triton(x: torch.Tensor, group_size: int = 4,
                                 eps: float = 1e-8) -> torch.Tensor:
    """Launch the two Triton passes: x (N, ...) contiguous on a CUDA device, f32 or bf16
    (f16 too); returns (groups, 1) f32.  Counts one launch per call."""
    if not x.is_cuda:
        raise ValueError(f"minibatch_stddev_stat_triton needs a CUDA tensor; got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"minibatch_stddev_stat_triton takes f32, bf16 or f16; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("minibatch_stddev_stat_triton needs a contiguous x")
    g, groups = _groups(x, group_size)
    feat = x[0].numel()
    nblk = -(-feat // _BLOCK_F)
    ws = torch.empty((groups, nblk), dtype=torch.float32, device=x.device)
    out = torch.empty((groups, 1), dtype=torch.float32, device=x.device)
    partial, reduce = _triton_kernels()
    partial[(groups, nblk)](x, ws, feat, groups, nblk, float(eps), G=g, BLOCK_F=_BLOCK_F,
                            num_warps=4)
    reduce[(groups,)](ws, out, nblk, feat, BLOCK_R=_BLOCK_R, num_warps=4)
    minibatch_stddev_stat_triton.launches += 1
    return out


minibatch_stddev_stat_triton.launches = 0


def minibatch_stddev_stat(x: torch.Tensor, group_size: int = 4,
                          eps: float = 1e-8) -> torch.Tensor:
    """The per-group statistic, (groups, 1) f32: the Triton kernel for CUDA tensors, the
    plain version for CPU (and meta) tensors."""
    if x.is_cuda:
        return minibatch_stddev_stat_triton(x, group_size, eps)
    if x.device.type in ("cpu", "meta"):
        return minibatch_stddev_stat_plain(x, group_size, eps)
    raise ValueError(f"minibatch_stddev_stat has no path for device {x.device}")
