"""The tensor-core conv kernels' tiling plans (``ops/conv3d_flat.py``) at every conv and
wgrad shape the flagship pgan 'xs' train step launches at phases 1-8, batches 8 and 16,
and the dispatch by dtype: bf16 to the tensor-core route ("tc"), f32 to the CUDA-core
route ("simt").  The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here their plans, which the C side re-checks, and the wrappers' routing are held with a
stubbed library."""

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
    """The four conv libraries stubbed, operand checks that need CUDA tensors skipped."""
    libs = {name: _StubLibrary() for name in ("fwd", "fwd_tc", "wgrad", "wgrad_tc")}
    for name, lib in libs.items():
        monkeypatch.setattr(cf, f"_{name}_library", lambda lib=lib: lib)
    monkeypatch.setattr(cf, "_check_cuda_operands", lambda name, tensors: None)
    monkeypatch.setattr(cf, "_stream", lambda x: 0)
    for fn in (cf.conv3d_flat_cuda, cf.conv3d_flat_wgrad_cuda):
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
    assert name == "saragan_conv3d_fwd" and args[3:] == (2, 16, 4, 16, 16, 3, 3, 3, 32, 0)


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
    assert [n for n, _ in stubbed["wgrad"].calls] == ["saragan_conv3d_wgrad_workspace_floats",
                                                      "saragan_conv3d_wgrad"]
    assert stubbed["wgrad"].calls[1][1][4:] == (1 << 20, 2, 16, 4, 16, 16, 3, 3, 3, 32, 0)
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
