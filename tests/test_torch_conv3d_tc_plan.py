"""The conv kernels' tiling plans (``ops/conv3d_flat.py``: the tensor-core forward and
wgrad, the CUDA-core forward) at every conv and wgrad shape the flagship pgan 'xs' train
step launches at phases 1-8, batches 8 and 16, and at the serving forward's, and the
dispatch by dtype: bf16 to the tensor-core route ("tc"), f32 to the CUDA-core route
("simt").  The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here their plans, which the C side re-checks, and the wrappers' routing are held with a
stubbed library."""

import dataclasses
import math
from collections import Counter

import numpy as np
import pytest
import torch

from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import conv3d_grad as cg
from saragan_tpu_torch.tools import profile_training
from saragan_tpu_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(1)

# the flagship configuration (bench.py:99-119) grown to 8 phases: 4x4 -> 1024x1024 planes,
# so the 'xs' table's 8-filter phases 7 and 8 are reached
FINAL_SHAPE = "(1, 256, 1024, 1024)"


def step_shapes(phase, batch, monkeypatch):
    """(x, w) of every forward and dgrad, and (x, dy, kernel) of every wgrad, that one
    `flat` train step launches: the step runs on the meta device, shapes only."""
    convs, wgrads = Counter(), Counter()
    conv, wgrad = cg.conv3d_flat, cg.conv3d_flat_wgrad

    def conv_spy(x, w, role="forward"):
        convs[(tuple(x.shape), tuple(w.shape))] += 1
        return conv(x, w, role)

    def wgrad_spy(x, dy, kernel):
        wgrads[(tuple(x.shape), tuple(dy.shape), tuple(kernel))] += 1
        return wgrad(x, dy, kernel)

    monkeypatch.setattr(cg, "conv3d_flat", conv_spy)
    monkeypatch.setattr(cg, "conv3d_flat_wgrad", wgrad_spy)
    monkeypatch.setattr(profile_training, "BENCH_CFG",
                        dict(profile_training.BENCH_CFG, final_shape=FINAL_SHAPE))
    cfg = profile_training.bench_train_config(phase, batch)
    arch = get_architecture("pgan")
    state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0), phase=phase,
                                       cfg=cfg, device="meta")
    real = torch.empty(cfg.current_shape(phase, batch), device="meta")
    step = make_train_step(arch, cfg, phase, go, do, conv_engine="flat")
    step(state, real, None, 0.5, 1e-3, 1e-3)
    return convs, wgrads


def covers_once(extent, box, boxes):
    """The boxes [i*box, (i+1)*box) for i < boxes, cut at `extent`, cover 0..extent-1
    exactly once."""
    count = np.zeros(boxes * box, dtype=np.int64)
    for i in range(boxes):
        count[i * box:(i + 1) * box] += 1
    return bool((count[:extent] == 1).all()) and (boxes - 1) * box < extent


def check_box(box, spatial, sizes=(16, 128, 256)):
    assert all(b > 0 and b & (b - 1) == 0 for b in box), box
    assert math.prod(box) in sizes
    if math.prod(box) == 16:  # only where a whole sample has no more than 16 positions
        assert math.prod(1 << (v - 1).bit_length() for v in spatial) <= 16


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("phase", range(1, 9))
def test_plans_fit_and_cover_every_flagship_shape(phase, batch, monkeypatch):
    convs, wgrads = step_shapes(phase, batch, monkeypatch)
    assert convs and wgrads
    for xs, ws in convs:
        n, c, d, h, wd = xs
        f = ws[-1]
        p = cf.conv_tc_plan(xs, ws)
        assert p.smem <= cf.MAX_SMEM
        check_box(p.box, (d, h, wd))
        assert p.layout == {128: 0, 16: 1, 256: 2}[math.prod(p.box)]
        assert p.ft == (32 if p.layout == 1 else 8) * p.nt and p.nt in (2, 4)
        if p.layout == 2:  # 256-position boxes only where they fill the card
            assert p.blocks >= cf.MIN_BLOCKS * p.f_tiles
        assert p.cc % 16 == 0 and p.chunks == -(-c // p.cc)
        assert p.f_tiles == -(-f // p.ft)
        for extent, b, nb in zip((d, h, wd), p.box, p.boxes):
            assert covers_once(extent, b, nb)
        assert p.blocks == n * math.prod(p.boxes) * p.f_tiles < 2 ** 31
        check_simt_plan(xs, ws)
    for xs, dys, k in wgrads:
        n, c, d, h, wd = xs
        f = dys[1]
        p = cf.wgrad_tc_plan(xs, dys, k)
        assert p.smem <= cf.MAX_SMEM
        check_box(p.box, (d, h, wd), sizes=(16, 128))
        for extent, b, nb in zip((d, h, wd), p.box, p.boxes):
            assert covers_once(extent, b, nb)
        # the splits cut the batch's boxes into consecutive chunks, none empty
        assert p.tiles == n * math.prod(p.boxes)
        assert (p.splits - 1) * p.per_split < p.tiles <= p.splits * p.per_split
        # a block's jobs fill at most its 8 warps x 4
        assert p.ct % 16 == 0 and p.tpb * (p.ct // 16) <= 32
        assert p.tap_groups * p.tpb >= math.prod(k) and p.c_tiles * p.ct >= c
        assert p.f_tiles * p.ft >= f and p.ft in (16, 32)
        assert p.ws_floats == p.splits * math.prod(k) * c * f
        # the summation order is a function of the shapes alone: alignment (and with it
        # the stager) changes neither the split nor the tiles
        for align in (2, 4, 16):
            q = cf.wgrad_tc_plan(xs, dys, k, align, align)
            assert (q.splits, q.per_split, q.box, q.ct, q.ft, q.tpb) == \
                   (p.splits, p.per_split, p.box, p.ct, p.ft, p.tpb)


@pytest.mark.parametrize("spatial,kernel,max_positions,box", [
    ((1, 4, 4), (1, 3, 3), 256, (1, 4, 4)),      # a whole phase-1 sample: 16 positions
    ((2, 8, 8), (1, 3, 3), 256, (2, 8, 8)),      # a whole phase-2 sample
    ((32, 128, 128), (3, 3, 3), 256, (4, 2, 32)),
    ((32, 128, 128), (3, 3, 3), 128, (2, 2, 32)),
    ((3, 5, 37), (3, 3, 3), 256, (2, 4, 32)),
])
def test_box_shape_follows_the_plane(spatial, kernel, max_positions, box):
    assert cf.tc_box(*spatial, kernel, max_positions) == box


def test_every_position_lies_in_one_box_on_ragged_volumes():
    for spatial in ((3, 5, 37), (5, 7, 9), (1, 4, 4), (2, 9, 9), (7, 1, 3)):
        box = cf.tc_box(*spatial, (3, 3, 3))
        boxes = [-(-v // b) for v, b in zip(spatial, box)]
        count = np.zeros(spatial, dtype=np.int64)
        for i in range(boxes[0]):
            for j in range(boxes[1]):
                for k in range(boxes[2]):
                    count[i * box[0]:(i + 1) * box[0], j * box[1]:(j + 1) * box[1],
                          k * box[2]:(k + 1) * box[2]] += 1
        assert (count == 1).all(), spatial


@pytest.mark.parametrize("w,align,ve", [(128, 16, 8), (128, 8, 4), (128, 2, 1), (4, 16, 4),
                                        (6, 16, 2), (7, 16, 1), (9, 16, 1)])
def test_vector_width_follows_alignment_and_width(w, align, ve):
    bw = cf.tc_box(1, 8, w, (1, 3, 3))[2]
    assert cf._vector_width(w, bw, align) == ve
    assert cf.conv_tc_plan((1, 16, 1, 8, w), (1, 3, 3, 16, 16), align, 16).ve == ve
    # cp.async copies at least 4 bytes: with 2-byte vectors the wgrad stages through registers
    q = cf.wgrad_tc_plan((1, 16, 1, 8, w), (1, 32, 1, 8, w), (1, 3, 3), align, align)
    assert q.stager == ("cpasync" if q.ve >= 2 else "regs")


def test_alignment_of_a_narrowed_view():
    x = torch.zeros(2, 3, 5, 7, 9, dtype=torch.bfloat16)
    assert cf._alignment(x.data_ptr()) == 16
    assert cf._alignment(x[1:].data_ptr()) == 2  # 3*5*7*9 elements of 2 bytes in
    assert cf._alignment(x.data_ptr() + 4) == 4


def test_odd_channels_and_outputs_are_padded_not_refused():
    for c, f in ((4, 8), (8, 4), (5, 7), (256, 8)):
        p = cf.conv_tc_plan((2, c, 4, 16, 16), (3, 3, 3, c, f))
        assert p.cc >= 16 and p.ft >= 16 and p.vw == (8 if f % 8 == 0 else 1)
        q = cf.wgrad_tc_plan((2, c, 4, 16, 16), (2, f, 4, 16, 16), (3, 3, 3))
        assert q.ct >= 16 and q.ft >= 16


def check_simt_plan(xs, ws):
    """The CUDA-core forward's plan: shared memory within its budget, a thread count the
    kernel takes, the box covering the volume once, and no dependence on the batch."""
    n, c, d, h, wd = xs
    p = cf.conv_simt_plan(xs, ws)
    assert (p.vpt, p.fpt) in cf.SIMT_TILES
    assert p.smem <= cf.MAX_SMEM // cf.SIMT_BLOCKS_PER_SM[p.vpt] - 1024 or p.cc == 1
    assert p.smem <= cf.MAX_SMEM
    rows = p.cc * (p.box[0] + ws[0] - 1) * (p.box[1] + ws[1] - 1)
    assert p.smem == 2 * 4 * (cf._round_up(rows * ((p.box[2] + ws[2] - 1) | 1), 4)
                              + math.prod(ws[:3]) * p.cc * p.ft) + 8 * rows
    assert p.threads == math.prod(p.box) // p.vpt * (p.ft // p.fpt) <= cf.SIMT_THREADS[p.vpt]
    assert p.box[2] % p.vpt == 0 and p.ft % p.fpt == 0 and 4 <= p.ft <= max(4, cf.SIMT_MAX_FT)
    assert p.chunks == -(-c // p.cc) and p.f_tiles == -(-ws[-1] // p.ft)
    for extent, b, nb in zip((d, h, wd), p.box, p.boxes):
        assert covers_once(extent, b, nb)
    # the batch never enters the plan (nor, with it, any summation order)
    for batch in (1, 8, 16, n + 3):
        assert cf.conv_simt_plan((batch, *xs[1:]), ws) == p
    return p


def _masked_share_of_worst_block(spatial, box):
    """The share of the last block's positions (the last along every axis, the most
    masked) that lie outside the volume."""
    inside = 1.0
    for extent, b in zip(spatial, box):
        inside *= (extent - (-(-extent // b) - 1) * b) / b
    return 1 - inside


# the phase-6 batch-8 serving forward's six convs (f32, the CUDA-core route)
SERVING_CONVS = [((8, 256, 1, 4, 4), (1, 3, 3, 256, 256)), ((8, 256, 2, 8, 8), (1, 3, 3, 256, 256)),
                 ((8, 64, 4, 16, 16), (3, 3, 3, 64, 64)), ((8, 64, 8, 32, 32), (3, 3, 3, 64, 64)),
                 ((8, 32, 16, 64, 64), (3, 3, 3, 32, 32)),
                 ((8, 16, 32, 128, 128), (3, 3, 3, 16, 16))]


@pytest.mark.parametrize("xs,ws", SERVING_CONVS)
def test_simt_plan_fits_the_serving_planes(xs, ws):
    p = check_simt_plan(xs, ws)
    # no block more than half masked: on the 4x4 and 8x8 planes the box fits the plane
    assert _masked_share_of_worst_block(xs[2:], p.box) <= 0.5
    if xs[3:] in ((4, 4), (8, 8)):
        assert p.box[1] <= xs[3] and p.box[2] <= xs[4] and p.vpt == 4
    # the widest register tile whose least outputs per sample the sample has
    outputs = math.prod(xs[2:]) * ws[-1]
    assert outputs >= cf.SIMT_TILES[(p.vpt, p.fpt)]
    wider = list(cf.SIMT_TILES)[:list(cf.SIMT_TILES).index((p.vpt, p.fpt))]
    assert all(outputs < cf.SIMT_TILES[t] for t in wider)


@pytest.mark.parametrize("spatial,kernel,positions,vpt,box", [
    ((1, 4, 4), (1, 3, 3), 16, 4, (1, 4, 4)),
    ((2, 8, 8), (1, 3, 3), 64, 4, (1, 8, 8)),
    ((32, 128, 128), (3, 3, 3), 1024, 8, (8, 4, 32)),
    ((3, 5, 37), (3, 3, 3), 64, 4, (2, 2, 16)),
])
def test_simt_box_shape_follows_the_plane(spatial, kernel, positions, vpt, box):
    assert cf.simt_box(*spatial, kernel, positions, vpt) == box


def test_simt_plan_weight_copy_follows_alignment_and_f():
    xs = (2, 16, 4, 16, 16)
    assert cf.conv_simt_plan(xs, (3, 3, 3, 16, 32)).vw == 4
    assert cf.conv_simt_plan(xs, (3, 3, 3, 16, 30)).vw == 1
    p, q = cf.conv_simt_plan(xs, (3, 3, 3, 16, 32), 8), cf.conv_simt_plan(xs, (3, 3, 3, 16, 32))
    assert p.vw == 1 and p == cf.ConvSimtPlan(**{**vars(q), "vw": 1})


class _StubLibrary:
    """Stands in for the ctypes handle of a kernel library: records each call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 1 << 20 if name.endswith("workspace_floats") else 0
        return fn


@pytest.fixture
def stubbed(monkeypatch):
    """The six conv libraries stubbed, operand checks that need CUDA tensors skipped."""
    libs = {name: _StubLibrary() for name in ("fwd", "fwd_tc", "wgrad", "wgrad_tc", "v2",
                                                "v2_tc")}
    for name, lib in libs.items():
        monkeypatch.setattr(cf, f"_{name}_library", lambda lib=lib: lib)
    monkeypatch.setattr(cf, "_check_cuda_operands", lambda name, tensors: None)
    monkeypatch.setattr(cf, "_stream", lambda x: 0)
    monkeypatch.setattr(cf, "_sm_count", lambda device: cf.H100_SMS)
    for fn in (cf.conv3d_flat_cuda, cf.conv3d_flat_wgrad_cuda, cf.conv3d_flat_v2_cuda):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "by_shape", Counter())
    return libs


def test_forward_routes_bf16_to_tensor_cores_and_f32_to_cuda_cores(stubbed):
    x, w = torch.zeros(2, 16, 4, 16, 16), torch.zeros(3, 3, 3, 16, 32)
    cf.conv3d_flat_cuda(x.bfloat16(), w.bfloat16(), "dgrad")
    cf.conv3d_flat_cuda(x, w)
    assert cf.launches_by_route(cf.conv3d_flat_cuda) == {"tc": 1, "simt": 1}
    assert cf.conv3d_flat_cuda.launches == 2
    assert cf.conv3d_flat_cuda.by_shape[("dgrad", tuple(x.shape), tuple(w.shape),
                                         torch.bfloat16)] == 1
    [(name, args)] = stubbed["fwd_tc"].calls
    p = cf.conv_tc_plan(x.shape, w.shape)
    assert name == "saragan_conv3d_fwd_tc"
    assert args[3:] == (2, 16, 4, 16, 16, 3, 3, 3, 32, *p.box, p.cc, p.ft, p.layout, p.nt,
                        p.ve, p.vw, p.smem, 0)
    [(name, args)] = stubbed["fwd"].calls
    q = cf.conv_simt_plan(x.shape, w.shape)
    assert name == "saragan_conv3d_fwd" and args[3:] == (2, 16, 4, 16, 16, 3, 3, 3, 32, *q.box,
                                                         q.cc, q.ft, q.vpt, q.fpt, q.vw,
                                                         q.smem, 0)


def test_wgrad_routes_bf16_to_tensor_cores_and_f32_to_cuda_cores(stubbed):
    x, dy = torch.zeros(2, 16, 4, 16, 16), torch.zeros(2, 32, 4, 16, 16)
    dw = cf.conv3d_flat_wgrad_cuda(x.bfloat16(), dy.bfloat16(), (3, 3, 3))
    assert dw.shape == (3, 3, 3, 16, 32) and dw.dtype == torch.bfloat16
    cf.conv3d_flat_wgrad_cuda(x, dy, (3, 3, 3))
    assert cf.launches_by_route(cf.conv3d_flat_wgrad_cuda) == {"tc": 1, "simt": 1}
    [(name, args)] = stubbed["wgrad_tc"].calls
    p = cf.wgrad_tc_plan(x.shape, dy.shape, (3, 3, 3))
    assert name == "saragan_conv3d_wgrad_tc"
    assert args[4:] == (p.ws_floats, 2, 16, 4, 16, 16, 3, 3, 3, 32, *p.box, p.ct, p.ft, p.tpb,
                        p.splits, p.per_split, cf.TC_STAGERS[p.stager], p.ve, p.ve_dy, p.smem,
                        0)
    [(name, args)] = stubbed["wgrad"].calls
    q = cf.wgrad_simt_plan(x.shape, dy.shape, (3, 3, 3))
    assert name == "saragan_conv3d_wgrad"
    assert args[4:] == (q.ws_floats, 2, 16, 4, 16, 16, 3, 3, 3, 32, *q.box, q.ct, q.ft, q.pg,
                        q.ry, q.vpt, q.splits, q.per_split, q.vx, q.vdy, q.smem, 0)
    assert not stubbed["fwd"].calls and not stubbed["fwd_tc"].calls


def test_forward_plan_is_one_tiling_at_every_alignment():
    """The forward stages x through registers at every alignment, so x's address moves
    only the vector width: no landing buffer, no other tiling."""
    xs, ws = (8, 32, 16, 64, 64), (3, 3, 3, 32, 64)
    p = cf.conv_tc_plan(xs, ws)
    assert p.smem == 2 * (cf._stage_elems(p.box, (3, 3, 3), p.cc)
                          + 2 * cf._round_up(27 * p.cc * (p.ft + 8), 8))
    for align, ve in ((2, 1), (4, 2), (8, 4)):
        q = cf.conv_tc_plan(xs, ws, align)
        assert q.ve == ve and q == cf.ConvTcPlan(**{**vars(p), "ve": ve})


@pytest.mark.parametrize("f,align,stager", [(16, 16, "regs"), (32, 16, "cpasync"),
                                            (64, 16, "cpasync"), (32, 2, "regs")])
def test_wgrad_stager_follows_the_output_tile(f, align, stager):
    """Registers with 16 outputs per block; cp.async with 32, where the register stager's
    registers would hold a block of 256 threads to one per SM; registers wherever cp.async
    cannot copy (2-byte vectors)."""
    p = cf.wgrad_tc_plan((8, 16, 8, 32, 32), (8, f, 8, 32, 32), (3, 3, 3), align, align)
    assert p.stager == stager


# --- kernel #3 (conv3d_flat_v2) and the f32 wgrad (#2, CUDA cores) ---

def check_v2_plans(xs, ws):
    """Both v2 plans: shared memory and threads within the card's limits, the box covering
    the volume once, the grid persistent, and the tiling (and with it every summation
    order) a function of one sample's shape."""
    n, c, d, h, wd = xs
    f = ws[-1]
    p = cf.conv_v2_tc_plan(xs, ws)
    assert p.smem <= cf.MAX_SMEM and 32 * (8 if p.layout == 2 else 4) <= 1024
    check_box(p.box, (d, h, wd))
    assert p.layout == {128: 0, 16: 1, 256: 2}[math.prod(p.box)]
    assert p.ft == (32 if p.layout == 1 else 8) * p.nt and p.nt in (2, 4)
    assert p.cc in (16, 32) and p.chunks == -(-c // p.cc) and p.cp == -(-c // 8) * 8
    assert p.resident == (p.chunks == 1) and p.f_tiles == -(-f // p.ft)
    wstage = cf._round_up(math.prod(ws[:3]) * p.cc * (p.ft + 8), 8)
    ring = 3 * (cf._stage_elems(p.box, ws[:3], p.cc) + (0 if p.resident else wstage))
    spos = math.prod(b + k - 1 for b, k in zip(p.box, ws[:3]))
    assert p.smem == 2 * (ring + p.resident * wstage) + 4 * spos
    for extent, b, nb in zip((d, h, wd), p.box, p.boxes):
        assert covers_once(extent, b, nb)
    assert p.items == n * math.prod(p.boxes) * p.f_tiles < 2 ** 31
    assert 1 <= p.blocks <= min(p.items, 2 * cf.H100_SMS)
    if p.resident:  # each block keeps one f tile
        assert p.blocks % p.f_tiles == 0
    q = cf.conv_v2_simt_plan(xs, ws)
    assert q.smem <= cf.MAX_SMEM // cf.SIMT_BLOCKS_PER_SM[q.vpt] - 1024 or q.cc == 1
    assert q.smem <= cf.MAX_SMEM and q.threads <= cf.SIMT_THREADS[q.vpt] <= 1024
    simt = cf.conv_simt_plan(xs, ws)
    assert (q.box, q.ft, q.vpt, q.fpt, q.threads) == (simt.box, simt.ft, simt.vpt, simt.fpt,
                                                      simt.threads)
    rows = q.cc * (q.box[0] + ws[0] - 1) * (q.box[1] + ws[1] - 1)
    assert q.smem == 3 * 4 * (cf._round_up(rows * ((q.box[2] + ws[2] - 1) | 1), 4)
                              + math.prod(ws[:3]) * q.cc * q.ft) + 4 * rows
    assert q.items == n * math.prod(q.boxes) * q.f_tiles
    assert 1 <= q.blocks <= min(q.items, cf.SIMT_BLOCKS_PER_SM[q.vpt] * cf.H100_SMS)
    for batch in (1, 8, 16, n + 3):
        for plan, other in ((p, cf.conv_v2_tc_plan((batch, *xs[1:]), ws)),
                            (q, cf.conv_v2_simt_plan((batch, *xs[1:]), ws))):
            assert dataclasses.replace(other, items=plan.items, blocks=plan.blocks) == plan
    return p, q


def check_wgrad_simt_plan(xs, dys, k):
    n, c, d, h, wd = xs
    f = dys[1]
    p = cf.wgrad_simt_plan(xs, dys, k)
    assert p.smem <= cf.MAX_SMEM and 0 < p.threads <= cf.WGRAD_SIMT_THREADS <= 1024
    assert all(b > 0 and b & (b - 1) == 0 for b in p.box) and p.box[2] >= 4
    for extent, b, nb in zip((d, h, wd), p.box, p.boxes):
        assert covers_once(extent, b, nb)
    assert p.ry == (3 if k[1] % 3 == 0 and k[2] <= 3 else 1)
    assert p.vpt == (8 if p.box[2] >= 8 else 4)
    assert p.threads == p.ft // 8 * p.pg * p.ct * k[0] * (k[1] // p.ry)
    assert p.pg <= p.box[0] * p.box[1] and p.c_tiles * p.ct >= c and p.f_tiles * p.ft >= f
    assert p.tiles == n * math.prod(p.boxes)
    assert (p.splits - 1) * p.per_split < p.tiles <= p.splits * p.per_split
    slots = p.splits * p.pg
    groups = -(-slots // 32)
    assert p.ws_floats == (slots + (groups if groups > 1 else 0)) * math.prod(k) * c * f
    assert slots * math.prod(k) * c * f <= 16 << 20 or p.splits == 1
    # the split (and so the summation order) is a function of the shapes alone: the
    # operands' alignments pick only their copy widths
    for x_align, dy_align in ((4, 16), (16, 8), (4, 4), (16, 16)):
        q = cf.wgrad_simt_plan(xs, dys, k, x_align, dy_align)
        assert dataclasses.replace(q, vx=p.vx, vdy=p.vdy) == p
        assert q.vx == (4 if wd % 4 == 0 and x_align == 16 else 1)
        assert q.vdy == (4 if wd % 4 == 0 and dy_align == 16 else 1)
    return p


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("phase", range(1, 9))
def test_v2_and_f32_wgrad_plans_fit_every_flagship_shape(phase, batch, monkeypatch):
    """Every forward and dgrad shape of the flagship step at phases 1-8 gets both v2 plans,
    every wgrad shape the f32 wgrad's plan."""
    convs, wgrads = step_shapes(phase, batch, monkeypatch)
    for xs, ws in convs:
        check_v2_plans(xs, ws)
    for xs, dys, k in wgrads:
        check_wgrad_simt_plan(xs, dys, k)


@pytest.mark.parametrize("xs,ws", SERVING_CONVS)
def test_v2_plans_fit_the_serving_planes(xs, ws):
    p, _ = check_v2_plans(xs, ws)
    # the 4x4 and 8x8 planes: one box per sample, not a mostly empty one
    if xs[3:] in ((4, 4), (8, 8)):
        assert p.boxes == (1, 1, 1)


@pytest.mark.parametrize("spatial,kernel,box", [
    ((1, 4, 4), (1, 3, 3), (1, 4, 4)),
    ((2, 8, 8), (1, 3, 3), (2, 8, 8)),
    ((32, 128, 128), (3, 3, 3), (8, 4, 8)),
    ((3, 5, 37), (3, 3, 3), (2, 4, 32)),
])
def test_v2_tc_box_stages_the_fewest_positions(spatial, kernel, box):
    assert cf.v2_tc_box(*spatial, kernel) == box


def test_v2_tc_keeps_the_weights_resident_only_with_one_chunk():
    one = cf.conv_v2_tc_plan((8, 16, 16, 64, 64), (3, 3, 3, 16, 48))
    assert one.resident == 1 and one.chunks == 1 and one.blocks % one.f_tiles == 0
    many = cf.conv_v2_tc_plan((8, 64, 16, 64, 64), (3, 3, 3, 64, 48))
    assert many.resident == 0 and many.chunks > 1


def test_odd_channels_and_outputs_take_a_v2_plan():
    for c, f in ((1, 1), (4, 24), (24, 4), (48, 256), (256, 48)):
        p = cf.conv_v2_tc_plan((2, c, 4, 16, 16), (3, 3, 3, c, f))
        assert p.cp % 8 == 0 and p.cp >= c and p.vw == (8 if f % 8 == 0 else 1)
        q = cf.conv_v2_simt_plan((2, c, 4, 16, 16), (3, 3, 3, c, f))
        assert q.vw == (4 if f % 4 == 0 else 1)
        w = cf.wgrad_simt_plan((2, c, 4, 16, 16), (2, f, 4, 16, 16), (3, 3, 3))
        assert w.ft >= 8 and w.ct >= 1


@pytest.mark.parametrize("kernel", [(1, 5, 7), (3, 3, 5), (5, 5, 1), (7, 3, 3)])
def test_f32_wgrad_plan_takes_wide_kernels_one_tap_row_per_thread(kernel):
    p = check_wgrad_simt_plan((2, 8, 6, 9, 20), (2, 12, 6, 9, 20), kernel)
    assert p.ry == (3 if kernel[1] % 3 == 0 and kernel[2] <= 3 else 1)


def test_v2_and_f32_wgrad_refuse_what_their_kernels_cannot_run(stubbed):
    x = torch.zeros(2, 4, 3, 8, 8)
    with pytest.raises(ValueError, match="odd"):
        cf.conv3d_flat_v2_cuda(x, torch.zeros(2, 3, 3, 4, 4))
    with pytest.raises(ValueError, match="odd"):
        cf.conv3d_flat_wgrad_cuda(x, torch.zeros(2, 4, 3, 8, 8), (3, 4, 3))
    with pytest.raises(ValueError, match="kernel width"):
        cf.conv3d_flat_v2_cuda(x, torch.zeros(3, 3, 9, 4, 4))
    with pytest.raises(ValueError, match="kernel width"):
        cf.conv3d_flat_wgrad_cuda(x, torch.zeros(2, 4, 3, 8, 8), (3, 3, 9))
    # weights that no shared-memory tiling holds
    with pytest.raises(ValueError, match="shared memory"):
        cf.conv_v2_tc_plan((1, 256, 8, 8, 8), (7, 7, 7, 256, 256))
    with pytest.raises(ValueError, match="shared memory"):
        cf.conv_v2_simt_plan((1, 4, 8, 8, 8), (9, 9, 9, 4, 64))
    assert not any(lib.calls for lib in stubbed.values())


def test_v2_routes_bf16_to_tensor_cores_and_f32_to_cuda_cores(stubbed):
    x, w = torch.zeros(2, 16, 4, 16, 16), torch.zeros(3, 3, 3, 16, 32)
    y = cf.conv3d_flat_v2_cuda(x.bfloat16(), w.bfloat16(), "dgrad")
    assert y.shape == (2, 32, 4, 16, 16) and y.dtype == torch.bfloat16
    cf.conv3d_flat_v2_cuda(x, w)
    assert cf.launches_by_route(cf.conv3d_flat_v2_cuda) == {"tc": 1, "simt": 1}
    [(name, args)] = stubbed["v2_tc"].calls
    p = cf.conv_v2_tc_plan(x.shape, w.shape)
    assert name == "saragan_conv3d_fwd_v2_tc"
    assert args[4:] == (2, 16, 4, 16, 16, 3, 3, 3, 32, *p.box, p.cc, p.ft, p.layout, p.nt, p.vw,
                        p.resident, p.blocks, p.smem, 0)
    [(name, args)] = stubbed["v2"].calls
    q = cf.conv_v2_simt_plan(x.shape, w.shape)
    assert name == "saragan_conv3d_fwd_v2"
    assert args[3:] == (2, 16, 4, 16, 16, 3, 3, 3, 32, *q.box, q.cc, q.ft, q.vpt, q.fpt, q.vw,
                        q.blocks, q.smem, 0)
    assert not stubbed["fwd"].calls and not stubbed["fwd_tc"].calls
