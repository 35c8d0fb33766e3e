"""The fused op's CUDA tiling plan (``ops/fused_bias_act.py::fused_plan``) on the CPU:
its items cover every (sample, voxel) once, its 16-byte words are aligned, it fits the
card's shared memory and register budget, a sample's tiles do not depend on N, the
backward's workspace rows are the ones its finish reads, and an emulation of the
kernels' item walk and gb partition in torch ops matches the plain versions."""

import math

import numpy as np
import pytest
import torch

from saragan_tpu_torch.ops import fused_bias_act as fba

torch.set_num_threads(1)

H100_SMS = 132
# (C, S) of the phase-6 flagship generator's eleven calls, then odd shapes
FLAGSHIP = [(256, 16), (256, 128), (64, 1024), (64, 8192), (32, 65536), (16, 524288)]
ODD = [(1, 9), (20, 21), (33, 35), (300, 9), (512, 35), (512, 128), (1, 1000), (16, 1)]
DTYPES = [torch.float32, torch.bfloat16]


def _items(plan, n, block):
    """(sample, first voxel) of each item block `block` walks, in its order."""
    return [(i // plan.tiles, (i % plan.tiles) * plan.tv)
            for i in range(block, n * plan.tiles, plan.blocks(n))]


def _gb_lane(plan, lane):
    """The (channel, first voxel) gb's lane `lane` sums in every item; None if idle."""
    c, j = divmod(lane, plan.lanes)
    return (c, j) if c < plan.c else None


def _coverage(plan, n):
    hits = np.zeros((n, plan.s), np.int32)
    for block in range(plan.blocks(n)):
        for sample, v0 in _items(plan, n, block):
            hits[sample, v0:min(v0 + plan.tv, plan.s)] += 1
    return hits


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c,s", FLAGSHIP + ODD)
def test_items_cover_every_voxel_once(c, s, dtype, backward):
    for n, sms in ((1, H100_SMS), (8, H100_SMS), (3, 2)):
        plan = fba.fused_plan(c, s, dtype, sms, backward)
        assert (_coverage(plan, n) == 1).all()
        # every block of the grid has an item: the grid never exceeds the items
        assert 1 <= plan.blocks(n) <= n * plan.tiles
        assert all(_items(plan, n, block) for block in range(plan.blocks(n)))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c,s", FLAGSHIP + ODD)
def test_vector_words_are_aligned(c, s, dtype, backward):
    plan = fba.fused_plan(c, s, dtype, H100_SMS, backward)
    esize = plan.esize
    # a row of the item is whole 16-byte words, and so is a shared row's stride
    assert (plan.tv * esize) % 16 == 0 and (plan.rs * esize) % 16 == 0
    assert plan.rs == plan.tv + 16 // esize
    # 16-byte copies only where every channel row starts on 16 bytes
    assert plan.async16 == ((s * esize) % 16 == 0)
    assert not fba.fused_plan(c, s, dtype, H100_SMS, backward, aligned=False).async16
    # the flagship's shapes all take the 16-byte path
    if (c, s) in FLAGSHIP:
        assert plan.async16


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c,s", FLAGSHIP + ODD + [(1024, 7), (1024, 4096)])
def test_shared_memory_and_registers_within_budget(c, s, dtype, backward):
    plan = fba.fused_plan(c, s, dtype, H100_SMS, backward)
    assert plan.smem <= fba.MAX_SMEM == 232448
    assert plan.blocks_per_sm * (plan.smem + 1024) <= fba.SM_SMEM
    # __launch_bounds__(THREADS, 2) caps a thread at 128 registers: the SM holds them
    assert fba.FUSED_THREADS * max(plan.blocks_per_sm, 2) * 128 <= 65536
    # per-thread state: VPT voxels' sums, FUSED_MAX_CPT f64 partials
    assert plan.vpt in (1, 2, 4) and plan.tv <= fba.FUSED_MAX_TV
    assert plan.vpt == max(1, plan.tv // fba.FUSED_THREADS)
    assert c * plan.lanes <= fba.FUSED_MAX_CPT * fba.FUSED_THREADS
    assert plan.lanes <= plan.tv
    stage = c * plan.rs * plan.esize * (2 if backward else 1)
    assert plan.smem >= 2 * stage + 4 * c
    # the register path: C = 16 or 32 values of each of the thread's voxels, 16-byte words
    if plan.cu:
        assert plan.cu == c in (16, 32) and plan.async16
        assert plan.cu * plan.vpt <= fba.FUSED_REGISTER_VALUES[backward]
    if (c, s) in FLAGSHIP and c in (16, 32):
        assert plan.cu == c


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fba.fused_plan(16, 64, torch.float16, H100_SMS)
    with pytest.raises(ValueError, match="channels"):
        fba.fused_plan(fba.FUSED_MAX_CHANNELS + 1, 64, torch.float32, H100_SMS)
    with pytest.raises(ValueError, match="channels"):
        fba.fused_plan(0, 64, torch.float32, H100_SMS)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("c,s", FLAGSHIP + ODD)
def test_a_samples_tiles_do_not_depend_on_n(c, s, backward):
    """The plan takes no N: a sample's items (first voxels) are the same alone and in a
    batch of 8, and the kernels sum every voxel's channels in the order 0 .. C-1."""
    for dtype in DTYPES:
        plan = fba.fused_plan(c, s, dtype, H100_SMS, backward)

        def tiles(n, sample):
            return sorted(v0 for block in range(plan.blocks(n))
                          for k, v0 in _items(plan, n, block) if k == sample)

        alone = tiles(1, 0)
        assert alone == list(range(0, s, plan.tv))
        assert all(tiles(8, k) == alone for k in (0, 3, 7))


@pytest.mark.parametrize("c,s", FLAGSHIP + ODD + [(1024, 7)])
def test_workspace_rows_are_the_rows_the_finish_reads(c, s):
    """One row per block, written by that block alone, and the finish reads rows
    0 .. blocks - 1; the lanes of gb's pass give every channel `lanes` lanes whose
    partials fit the shared array the block adds them from."""
    for dtype in DTYPES:
        plan = fba.fused_plan(c, s, dtype, H100_SMS, True)
        for n in (1, 8):
            blocks = plan.blocks(n)
            written = [block for block in range(blocks) if _items(plan, n, block)]
            assert written == list(range(blocks))
        lanes = [_gb_lane(plan, t + m * fba.FUSED_THREADS)
                 for t in range(fba.FUSED_THREADS) for m in range(fba.FUSED_MAX_CPT)]
        per_channel = np.zeros(c, np.int64)
        for lane in lanes:
            if lane is not None:
                per_channel[lane[0]] += 1
                assert lane[0] * plan.lanes + lane[1] < max(c, fba.FUSED_THREADS)
        assert (per_channel == plan.lanes).all()


def _rows(t, n, c):
    return t.reshape(n, c, -1)


def _emulate_forward(x, b, alpha, pixelnorm, plan):
    """The forward kernel's walk in torch ops: item by item, each voxel's sum over
    channels 0 .. C-1 in that order, the tail past S zero-filled and not stored."""
    n, c = x.shape[:2]
    xs, y = _rows(x, n, c).float(), torch.empty_like(_rows(x, n, c))
    for block in range(plan.blocks(n)):
        for sample, v0 in _items(plan, n, block):
            tile = torch.zeros(c, plan.tv)
            valid = min(plan.tv, plan.s - v0)
            tile[:, :valid] = xs[sample, :, v0:v0 + valid]
            v = tile + b.float()[:, None]
            v = torch.where(v >= 0, v, v * alpha)
            if pixelnorm:
                acc = torch.zeros(plan.tv)
                for ch in range(c):
                    acc = acc + v[ch] * v[ch]
                v = v * torch.rsqrt(acc / c + 1e-8)
            y[sample, :, v0:v0 + valid] = v[:, :valid].to(x.dtype)
    return y.reshape(x.shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 4, 8, 8), (3, 20, 3, 7), (2, 33, 5, 7), (1, 1, 21)])
@pytest.mark.parametrize("pixelnorm", [True, False])
def test_emulated_forward_walk_matches_plain_and_a_sample_alone(shape, dtype, pixelnorm):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=shape[1]).astype(np.float32))
    s = math.prod(shape[2:])
    plan = fba.fused_plan(shape[1], s, dtype, 2)
    ours = _emulate_forward(x, b, 0.2, pixelnorm, plan)
    ref = fba.bias_act_pixelnorm_plain(x, b, 0.2, pixelnorm)
    if dtype == torch.float32:
        torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-6)
    else:
        assert (ours.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    alone = _emulate_forward(x[-1:], b, 0.2, pixelnorm, plan)
    assert torch.equal(alone, ours[-1:])


def _emulate_gb(gx, plan, dtype):
    """The backward kernel's gb: lane (c, j) of each block adds voxels j, j + lanes, ... of
    its items in f64 (the kernel in four interleaved sums, added in a fixed order); the
    block adds its lanes in lane order into its workspace row; the finish adds the rows in
    row order, rounds to f32 and then through x's dtype."""
    n, c = gx.shape[:2]
    g64 = _rows(gx, n, c).double()
    rows = []
    for block in range(plan.blocks(n)):
        part = torch.zeros(c, plan.lanes, dtype=torch.float64)
        for sample, v0 in _items(plan, n, block):
            valid = min(plan.tv, plan.s - v0)
            seg = g64[sample, :, v0:v0 + valid]
            for j in range(min(plan.lanes, valid)):
                part[:, j] += seg[:, j::plan.lanes].sum(dim=1)
        row = torch.zeros(c, dtype=torch.float64)
        for j in range(plan.lanes):
            row = row + part[:, j]
        rows.append(row)
    total = torch.zeros(c, dtype=torch.float64)
    for row in rows:
        total = total + row
    return total.float().to(dtype).float()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,sms", [((2, 16, 4, 8, 8), 2), ((8, 256, 1, 4, 4), 132),
                                       ((3, 20, 3, 9), 1), ((2, 33, 5, 7), 3),
                                       ((4, 64, 8, 16), 5), ((2, 300, 3, 3), 2)])
@pytest.mark.parametrize("pixelnorm", [True, False])
def test_emulated_gb_partition_matches_plain(shape, sms, dtype, pixelnorm):
    rng = np.random.default_rng(len(shape) + shape[1])
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=shape[1]).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    gx, gb = fba.bias_act_pixelnorm_grad_plain(x, b, gy, 0.2, pixelnorm)
    plan = fba.fused_plan(shape[1], math.prod(shape[2:]), dtype, sms, True)
    assert plan.blocks(shape[0]) > 1 or shape[0] * plan.tiles == 1
    assert torch.equal(_emulate_gb(gx, plan, dtype), gb)
