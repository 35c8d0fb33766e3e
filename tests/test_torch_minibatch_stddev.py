"""Kernel #5 of the port, the minibatch standard-deviation statistic: its plain version
(what the dispatcher runs on a CPU tensor) against the JAX package's
``minibatch_stddev_stat`` in interpret mode, as the JAX package's own test runs it, and
against the channel the reference's ``minibatch_stddev_layer`` appends; and the CUDA
kernel's plan (``mbstd_plan``), with an emulation of the kernel's walk over it.

Tolerance: rtol 1e-6 in f32 (one mean over a few hundred features, summed in another
order); bf16 inputs are widened to f32 exactly by both, so the same."""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from saragan_tpu.ops.core import minibatch_stddev_layer
from saragan_tpu.ops.pallas_kernels import minibatch_stddev_stat as jax_mbstd
from saragan_tpu_torch.ops import minibatch_stddev as mb

torch.set_num_threads(1)


def _x(n, seed=0, shape=(3, 2, 4, 4)):
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_plain_matches_jax_kernel(n, dtype):
    x = _x(n, seed=n)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.astype(np.float32)).bfloat16()
    else:
        xt = torch.from_numpy(x)
    calls = mb.minibatch_stddev_stat_plain.calls
    ours = mb.minibatch_stddev_stat(xt, group_size=4)
    assert mb.minibatch_stddev_stat_plain.calls == calls + 1
    assert ours.shape == (n // 4, 1) and ours.dtype == torch.float32
    ref = np.asarray(jax_mbstd(jnp.asarray(x), group_size=4))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("n", [2, 8])
def test_equals_the_appended_channel_of_the_reference_layer(n):
    """Group m holds the interleaved samples m, m + groups, ...; the layer tiles the
    group's value over its samples (before its cast back to x's dtype, f32 here)."""
    x = _x(n, seed=3)
    stat = mb.minibatch_stddev_stat(torch.from_numpy(x), group_size=4).numpy()
    layer = np.asarray(minibatch_stddev_layer(jnp.asarray(x), group_size=4))
    groups = n // min(4, n)
    for i in range(n):
        np.testing.assert_allclose(layer[i, 3], np.full(layer.shape[2:], stat[i % groups, 0]),
                                   rtol=1e-6)


def test_bad_group_and_cpu_dispatch():
    with pytest.raises(ValueError, match="group size"):
        mb.minibatch_stddev_stat(torch.zeros(6, 2), group_size=4)
    launches = mb.minibatch_stddev_stat_cuda.launches
    mb.minibatch_stddev_stat(torch.zeros(4, 2))
    assert mb.minibatch_stddev_stat_cuda.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        mb.minibatch_stddev_stat_cuda(torch.zeros(4, 2))


# ---------------------------------------------------------------------------
# The kernel's plan (csrc/minibatch_stddev.cu runs only on the card): what each item,
# warp and lane covers, emulated in torch with the kernel's order of sums
# ---------------------------------------------------------------------------


def _emulate(x: torch.Tensor, p: "mb.MbstdPlan", eps: float = 1e-8) -> torch.Tensor:
    """The kernel's walk in f32/f64 torch ops: block b takes items b, b + blocks, ...;
    lane l of warp w of an item adds, over its cv vectors, the f32 sum of its vec
    features' stddevs in f64; the lanes, the warps and the last block's entries are added
    as the kernel does."""
    xf = x.reshape(x.shape[0], -1).float()
    ws = torch.full((p.items,), float("nan"), dtype=torch.float64)
    span = 32 * p.cv * p.vec  # one warp's share of an item
    seen = torch.zeros(p.groups, p.feat, dtype=torch.int64)
    for b in range(p.blocks):
        for item in range(b, p.items, p.blocks):
            m, c = divmod(item, p.chunks)
            warps = torch.zeros(mb.MBSTD_WARPS, dtype=torch.float64)
            for w in range(mb.MBSTD_WARPS):
                for u in range(p.cv):
                    for lane in range(32):
                        f = c * p.chunk + w * span + (u * 32 + lane) * p.vec
                        if f >= p.feat:
                            continue
                        assert f + p.vec <= p.feat  # a vector is whole or absent
                        seen[m, f:f + p.vec] += 1
                        v = xf[[i * p.groups + m for i in range(p.g)], f:f + p.vec]
                        mu = v.sum(0) / p.g
                        s = torch.sqrt(((v - mu) ** 2).sum(0) / p.g + eps)
                        warps[w] += float(s.sum())
            ws[item] = warps.sum()
    assert torch.equal(seen, torch.ones_like(seen))  # every feature once per group
    assert not ws.isnan().any()  # every item walked
    return (ws.view(p.groups, p.chunks).sum(1) / p.feat).float().view(-1, 1)


@pytest.mark.parametrize("n,shape,dtype,group,sms,aligned", [
    (8, (4, 8, 8), torch.float32, 4, 2, True), (16, (3, 5, 7), torch.bfloat16, 4, 1, True),
    (12, (2, 40, 40), torch.float16, 3, 1, True), (6, (5, 7), torch.float32, 6, 4, False),
    (20, (3, 9, 9), torch.bfloat16, 10, 2, True),
    (8, (64, 4, 4), torch.bfloat16, 8, 132, True), (4, (33,), torch.float32, 2, 1, True)])
def test_plan_covers_every_feature_once_and_its_walk_gives_the_statistic(
        n, shape, dtype, group, sms, aligned):
    x = torch.from_numpy(_x(n, seed=n, shape=shape)).to(dtype)
    feat = math.prod(shape)
    p = mb.mbstd_plan(n, feat, dtype, group, sms, aligned)
    esize = torch.empty((), dtype=dtype).element_size()
    assert p.vec == (16 // esize if aligned and feat * esize % 16 == 0 else 1)
    assert p.gt == (p.g if p.g in mb.MBSTD_TEMPLATE_G else 0 if p.g <= 8 else -1)
    assert p.chunk == mb.MBSTD_THREADS * p.cv * p.vec and p.chunks * p.chunk >= feat
    grid = mb.mbstd_blocks_per_sm(p.gt, p.vec) * sms
    assert 1 <= p.blocks <= min(grid, p.items)
    assert -(-p.items // p.blocks) == -(-p.items // grid)  # the rounds of a full grid
    np.testing.assert_allclose(_emulate(x, p).numpy(),
                               mb.minibatch_stddev_stat_plain(x, group).numpy(), rtol=1e-6)


@pytest.mark.parametrize("n,feat,dtype,cv", [
    (16, 16 * 32 * 128 * 128, torch.float32, 8), (16, 16 * 32 * 128 * 128, torch.bfloat16, 8),
    (8, 16 * 32 * 128 * 128, torch.bfloat16, 8), (8, 256 * 4 * 4, torch.float32, 1),
    (16, 256 * 4 * 4, torch.bfloat16, 1), (8, 32 * 16 * 64 * 64, torch.bfloat16, 2)])
def test_plan_at_the_phase6_discriminator_sizes(n, feat, dtype, cv):
    """Eight vectors a lane where the items fill every block of a full H100 grid; at the
    smallest activation one, so its few features spread over more warps; the rounds
    balanced (no block takes more than one item more than another)."""
    p = mb.mbstd_plan(n, feat, dtype, 4, 132)
    assert (p.g, p.gt, p.cv) == (4, 4, cv)
    assert p.vec == 16 // torch.empty((), dtype=dtype).element_size()
    grid = mb.mbstd_blocks_per_sm(4, p.vec) * 132
    rounds = -(-p.items // grid)
    assert p.blocks <= grid and -(-p.items // p.blocks) == rounds
    assert p.items > (rounds - 1) * p.blocks
    if cv == mb.MBSTD_CHUNK_VECTORS:
        assert p.items >= grid


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="group size"):
        mb.mbstd_plan(6, 8, torch.float32, 4, 132)
    with pytest.raises(ValueError, match="feature"):
        mb.mbstd_plan(4, 0, torch.float32, 4, 132)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        mb.mbstd_plan(4, 8, torch.float64, 4, 132)
    # a group of 8 keeps 64 bf16 values a thread in registers: two blocks an SM
    assert mb.mbstd_blocks_per_sm(8, 8) == 2 and mb.mbstd_blocks_per_sm(4, 8) == 4
    assert mb.mbstd_blocks_per_sm(0, 8) == 2 and mb.mbstd_blocks_per_sm(0, 4) == 4
    assert mb.mbstd_blocks_per_sm(-1, 8) == 2 and mb.mbstd_blocks_per_sm(-1, 4) == 4
    assert mb.mbstd_plan(32, 1 << 10, torch.float32, 16, 132).gt == -1
    assert mb.mbstd_plan(16, 1 << 24, torch.bfloat16, 8, 132).blocks <= 2 * 132
    assert mb.mbstd_plan(12, 1 << 20, torch.float32, 3, 132).gt == 0
