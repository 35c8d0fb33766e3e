"""The port's hand-written kernels against their plain versions on the card (the f32
CUDA-core conv through each register tile, the bf16 tensor-core convs, on ragged,
misaligned and small shapes, the wgrad's two stagers through its 16- and 32-output tiles,
the f32 wgrad, the fused op's forward and backward kernels at C from 1 to 512 and N = 1,
a sample alone against its slot in a batch, misaligned views and one launch per call;
the standalone #3, through both routes, and #5 too), the conv's derivative algebra
against cuDNN's double backward in f32 and bf16, one train step under ``flat``, and a
two-step CLI trainer run.

Needs an NVIDIA GPU and nvcc; skipped without them.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math
import time

import pytest
import torch

import torch.nn.functional as F

from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.ops import minibatch_stddev as mb
from saragan_tpu_torch.ops.conv3d_grad import conv3d_c, flip_swap
from saragan_tpu_torch.train.step import init_train_state, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ragged shapes: channels that are not multiples of the staged chunk or the per-block
# filter tile, volumes that are not multiples of the output box
@pytest.mark.parametrize("x_shape,w_shape", [
    ((2, 5, 3, 5, 37), (3, 3, 3, 5, 7)),
    ((1, 3, 4, 17, 33), (1, 3, 3, 3, 20)),
    ((2, 4, 5, 6, 7), (3, 1, 3, 4, 3)),
    ((1, 9, 2, 40, 70), (1, 1, 5, 9, 17)),
    ((1, 2, 7, 9, 9), (5, 3, 7, 2, 33)),
])
def test_conv3d_kernel_matches_plain(cuda, x_shape, w_shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(x_shape, generator=g, device=cuda)
    w = torch.randn(w_shape, generator=g, device=cuda) * 0.2
    launches = cf.conv3d_flat_cuda.launches
    y = cf.conv3d_flat(x, w)
    torch.cuda.synchronize()
    assert cf.conv3d_flat_cuda.launches == launches + 1
    ref = cf.conv3d_flat_plain(x, w)
    assert (y - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# the CUDA-core kernel (f32): C, F in {4, 16, 32, 64, 256}, 4x4, 8x8 and ragged planes,
# 1x3x3 and 3x3x3 kernels, both register tiles (8x8 where a sample has 2^19 outputs)
SIMT_CASES = [  # (n, c, f, (d, h, w), kernel)
    (8, 256, 256, (1, 4, 4), (1, 3, 3)),
    (3, 256, 256, (2, 8, 8), (1, 3, 3)),
    (1, 4, 16, (2, 4, 4), (1, 3, 3)),
    (2, 64, 64, (4, 16, 16), (3, 3, 3)),
    (1, 16, 32, (3, 9, 9), (3, 3, 3)),
    (2, 32, 4, (5, 7, 37), (3, 3, 3)),
    (1, 16, 16, (16, 64, 64), (3, 3, 3)),
    (1, 4, 64, (9, 33, 70), (3, 3, 3)),
    (2, 256, 32, (3, 12, 20), (1, 3, 3)),
]


@pytest.mark.parametrize("n,c,f,spatial,kernel", SIMT_CASES)
def test_cuda_core_kernel_matches_plain_and_repeats_bit_for_bit(cuda, n, c, f, spatial, kernel):
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((n, c, *spatial), generator=g, device=cuda)
    w = torch.randn((*kernel, c, f), generator=g, device=cuda) * (2.0 / (c * math.prod(kernel))) ** 0.5
    simt = cf.launches_by_route(cf.conv3d_flat_cuda)["simt"]
    y, again = cf.conv3d_flat_cuda(x, w), cf.conv3d_flat_cuda(x, w)
    torch.cuda.synchronize()
    assert cf.launches_by_route(cf.conv3d_flat_cuda)["simt"] == simt + 2
    assert torch.equal(y, again)
    assert _rel_err(y, cf.conv3d_flat_plain(x, w)) <= 1e-4
    # a sample's outputs do not depend on the batch it is computed in
    assert torch.equal(cf.conv3d_flat_cuda(x[n - 1:].contiguous(), w), y[n - 1:])


def test_cuda_core_kernel_runs_both_register_tiles(cuda):
    tiles = {cf.conv_simt_plan((n, c, *spatial), (*kernel, c, f)).vpt
             for n, c, f, spatial, kernel in SIMT_CASES}
    assert tiles == {4, 8}


def test_cuda_core_kernel_coalesced_batch_equals_samples_alone(cuda):
    """The serving pattern: eight samples in one batch, bit-equal to each run alone."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn((8, 32, 16, 64, 64), generator=g, device=cuda)
    w = torch.randn((3, 3, 3, 32, 32), generator=g, device=cuda) * 0.05
    y = cf.conv3d_flat_cuda(x, w)
    for i in (0, 5):
        assert torch.equal(cf.conv3d_flat_cuda(x[i:i + 1].contiguous(), w), y[i:i + 1])


def test_conv3d_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(1, 2, 3, 4, 5, device=cuda)
    with pytest.raises(TypeError):
        cf.conv3d_flat_cuda(x.double(), torch.randn(3, 3, 3, 2, 2, device=cuda).double())
    with pytest.raises(ValueError, match="odd"):
        cf.conv3d_flat_cuda(x, torch.randn(2, 3, 3, 2, 2, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        cf.conv3d_flat_cuda(x.transpose(3, 4), torch.randn(3, 3, 3, 2, 2, device=cuda))
    w = torch.randn(3, 3, 3, 2, 2, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="autograd graph"):
        cf.conv3d_flat_cuda(x, w)
    with pytest.raises(TypeError):
        cf.conv3d_flat_cuda(x.bfloat16(), torch.randn(3, 3, 3, 2, 2, device=cuda))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 300, 3, 3), (2, 16, 3, 5, 7),
                                   (1, 256, 1, 4, 4), (1, 1, 3, 7), (3, 1, 2, 8, 8),
                                   (2, 512, 2, 4, 4), (1, 512, 35), (1, 300, 2, 8, 8)])
@pytest.mark.parametrize("pixelnorm", [True, False])
def test_fused_kernel_matches_plain(cuda, shape, pixelnorm):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda)
    b = torch.randn(shape[1], generator=g, device=cuda)
    launches = fba.fused_bias_act_pixelnorm.launches
    y = fba.bias_act_pixelnorm(x, b, 0.2, pixelnorm)
    assert fba.fused_bias_act_pixelnorm.launches == launches + 1
    torch.testing.assert_close(y, fba.bias_act_pixelnorm_plain(x, b, 0.2, pixelnorm),
                               rtol=1e-5, atol=1e-6)


def _rel_err(y, ref):
    return (y.float() - ref.float()).abs().max().item() / max(ref.float().abs().max().item(), 1e-30)


SHAPES = [((2, 5, 3, 5, 37), (3, 3, 3, 5, 7)), ((1, 3, 4, 17, 33), (1, 3, 3, 3, 20)),
          ((2, 4, 5, 6, 7), (3, 1, 3, 4, 3)), ((1, 70, 2, 9, 9), (1, 3, 3, 70, 17))]


@pytest.mark.parametrize("x_shape,w_shape", SHAPES)
def test_conv3d_kernel_bf16_matches_plain(cuda, x_shape, w_shape):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(x_shape, generator=g, device=cuda).bfloat16()
    w = (torch.randn(w_shape, generator=g, device=cuda) * 0.2).bfloat16()
    y = cf.conv3d_flat(x, w)
    assert y.dtype == torch.bfloat16
    assert _rel_err(y, cf.conv3d_flat_plain(x, w)) <= 1e-2


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("x_shape,w_shape", SHAPES)
def test_wgrad_kernel_matches_plain_and_repeats_bit_for_bit(cuda, x_shape, w_shape, dtype,
                                                            limit):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(x_shape, generator=g, device=cuda).to(dtype)
    dy = torch.randn((x_shape[0], w_shape[-1], *x_shape[2:]), generator=g,
                     device=cuda).to(dtype)
    launches = cf.conv3d_flat_wgrad_cuda.launches
    dw = cf.conv3d_flat_wgrad(x, dy, w_shape[:3])
    again = cf.conv3d_flat_wgrad(x, dy, w_shape[:3])
    torch.cuda.synchronize()
    assert cf.conv3d_flat_wgrad_cuda.launches == launches + 2
    assert dw.shape == w_shape and dw.dtype == dtype
    assert _rel_err(dw, cf.conv3d_flat_wgrad_plain(x, dy, w_shape[:3])) <= limit
    assert torch.equal(dw, again)


# im2col (C <= 32) with plain loads in bf16 (odd W), per tap over three channel chunks,
# and the narrow-plane tile (W <= 8)
V2_SHAPES = [((2, 5, 3, 5, 37), (3, 3, 3, 5, 7)), ((1, 70, 2, 9, 16), (1, 3, 3, 70, 17)),
             ((2, 16, 4, 8, 8), (3, 3, 3, 16, 16))]


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("x_shape,w_shape", V2_SHAPES)
def test_conv3d_v2_kernel_matches_plain_and_repeats(cuda, x_shape, w_shape, dtype, limit):
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(x_shape, generator=g, device=cuda).to(dtype)
    w = (torch.randn(w_shape, generator=g, device=cuda) * 0.2).to(dtype)
    launches = cf.conv3d_flat_v2_cuda.launches
    y = cf.conv3d_flat_v2(x, w)
    again = cf.conv3d_flat_v2(x, w)
    torch.cuda.synchronize()
    assert cf.conv3d_flat_v2_cuda.launches == launches + 2
    assert y.dtype == dtype and torch.equal(y, again)
    assert _rel_err(y, cf.conv3d_flat_v2_plain(x, w)) <= limit
    assert _rel_err(y, cf.conv3d_flat_cuda(x, w)) <= limit


# kernel #3 through both routes (bf16: tensor cores; f32: CUDA cores) and the f32 wgrad
# (#2): C, F in {1, 4, 16, 24, 48, 256}, ragged planes, kw in {1, 3, 5, 7}
V2_CASES = [  # (n, c, f, (d, h, w), kernel)
    (2, 1, 4, (3, 5, 37), (3, 3, 3)),
    (1, 4, 1, (2, 9, 9), (1, 3, 5)),
    (2, 16, 24, (4, 16, 16), (3, 3, 3)),
    (1, 24, 16, (3, 7, 13), (3, 1, 7)),
    (2, 48, 48, (2, 12, 20), (1, 3, 1)),
    (1, 256, 256, (1, 4, 4), (1, 3, 3)),
    (3, 256, 16, (2, 8, 8), (1, 3, 3)),
    (1, 16, 256, (3, 9, 9), (3, 3, 3)),
    (2, 24, 4, (5, 33, 70), (3, 5, 3)),
    (1, 48, 1, (7, 40, 37), (3, 3, 3)),
    (2, 16, 16, (8, 32, 32), (3, 3, 3)),
]


def _v2_operands(g, n, c, f, spatial, kernel, dtype, cuda):
    x = torch.randn((n, c, *spatial), generator=g, device=cuda).to(dtype)
    w = (torch.randn((*kernel, c, f), generator=g, device=cuda)
         * (2.0 / (c * math.prod(kernel))) ** 0.5).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n,c,f,spatial,kernel", V2_CASES)
def test_v2_kernel_matches_plain_and_kernel1_and_repeats_bit_for_bit(cuda, dtype, limit, n, c, f,
                                                                    spatial, kernel):
    g = torch.Generator(device=cuda).manual_seed(15)
    x, w = _v2_operands(g, n, c, f, spatial, kernel, dtype, cuda)
    route = cf.conv_route(dtype)
    launches = cf.launches_by_route(cf.conv3d_flat_v2_cuda)[route]
    y, again = cf.conv3d_flat_v2_cuda(x, w), cf.conv3d_flat_v2_cuda(x, w)
    torch.cuda.synchronize()
    assert cf.launches_by_route(cf.conv3d_flat_v2_cuda)[route] == launches + 2
    assert y.dtype == dtype and torch.isfinite(y).all().item() and torch.equal(y, again)
    assert _rel_err(y, cf.conv3d_flat_v2_plain(x, w)) <= limit
    assert _rel_err(y, cf.conv3d_flat_cuda(x, w)) <= limit
    # a sample's outputs do not depend on the batch it is computed in
    assert torch.equal(cf.conv3d_flat_v2_cuda(x[n - 1:].contiguous(), w), y[n - 1:])


@pytest.mark.parametrize("n,c,f,spatial,kernel", V2_CASES)
def test_f32_wgrad_kernel_matches_plain_and_repeats_bit_for_bit(cuda, n, c, f, spatial, kernel):
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((n, c, *spatial), generator=g, device=cuda)
    dy = torch.randn((n, f, *spatial), generator=g, device=cuda)
    simt = cf.launches_by_route(cf.conv3d_flat_wgrad_cuda)["simt"]
    dw, again = cf.conv3d_flat_wgrad_cuda(x, dy, kernel), cf.conv3d_flat_wgrad_cuda(x, dy, kernel)
    torch.cuda.synchronize()
    assert cf.launches_by_route(cf.conv3d_flat_wgrad_cuda)["simt"] == simt + 2
    assert dw.shape == (*kernel, c, f) and torch.equal(dw, again)
    assert _rel_err(dw, cf.conv3d_flat_wgrad_plain(x, dy, kernel)) <= 1e-4


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.float32, 2),
                                          (torch.bfloat16, 1), (torch.bfloat16, 4)])
def test_v2_and_f32_wgrad_take_misaligned_views(cuda, dtype, offset):
    """Contiguous views `offset` elements into their storage: the weights' and dy's
    narrower copies, the same results."""
    g = torch.Generator(device=cuda).manual_seed(17)
    shape, kernel, f = (2, 16, 3, 16, 16), (3, 3, 3), 32
    wshape, dshape = (*kernel, 16, f), (2, f, 3, 16, 16)

    def view(shape_, scale=1.0):
        buf = (torch.randn(math.prod(shape_) + offset, generator=g, device=cuda) * scale).to(dtype)
        return buf[offset:].view(shape_)

    x, w, dy = view(shape), view(wshape, 0.1), view(dshape)
    assert w.data_ptr() % 16 != 0
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    y = cf.conv3d_flat_v2_cuda(x, w)
    assert _rel_err(y, cf.conv3d_flat_v2_plain(x, w)) <= limit
    assert torch.equal(y, cf.conv3d_flat_v2_cuda(x.clone(), w.clone()))
    if dtype == torch.float32:
        dw = cf.conv3d_flat_wgrad_cuda(x, dy, kernel)
        assert _rel_err(dw, cf.conv3d_flat_wgrad_plain(x, dy, kernel)) <= 1e-4
        assert torch.equal(dw, cf.conv3d_flat_wgrad_cuda(x.clone(), dy.clone(), kernel))


# the tensor-core kernels (bf16): C, F from 4 to 256, 4x4, 8x8 and ragged (5, 7, 9) planes,
# 1x3x3 and 3x3x3 kernels, batch 1 and 16
TC_CASES = [  # (n, c, f, (d, h, w), kernel)
    (1, 4, 8, (2, 4, 4), (1, 3, 3)),
    (16, 8, 4, (1, 4, 4), (1, 3, 3)),
    (2, 16, 16, (4, 8, 8), (3, 3, 3)),
    (1, 32, 64, (3, 5, 5), (3, 3, 3)),
    (2, 64, 32, (2, 7, 7), (3, 3, 3)),
    (1, 256, 256, (1, 4, 4), (1, 3, 3)),
    (16, 256, 256, (2, 8, 8), (1, 3, 3)),
    (1, 16, 256, (3, 9, 9), (3, 3, 3)),
    (2, 256, 64, (4, 16, 16), (3, 3, 3)),
    (16, 16, 32, (4, 16, 16), (3, 3, 3)),
    (16, 16, 16, (8, 32, 32), (3, 3, 3)),    # 256-position boxes, eight warps
    (8, 8, 32, (7, 40, 37), (3, 3, 3)),      # the same on a ragged volume
]


def _tc_operands(g, n, c, f, spatial, kernel, cuda):
    x = torch.randn((n, c, *spatial), generator=g, device=cuda).bfloat16()
    w = (torch.randn((*kernel, c, f), generator=g, device=cuda)
         * (2.0 / (c * math.prod(kernel))) ** 0.5).bfloat16()
    dy = torch.randn((n, f, *spatial), generator=g, device=cuda).bfloat16()
    return x, w, dy


def _tc_launches():
    return (cf.launches_by_route(cf.conv3d_flat_cuda)["tc"],
            cf.launches_by_route(cf.conv3d_flat_wgrad_cuda)["tc"])


@pytest.mark.parametrize("n,c,f,spatial,kernel", TC_CASES)
def test_tensor_core_kernels_match_plain_and_repeat_bit_for_bit(cuda, n, c, f, spatial, kernel):
    g = torch.Generator(device=cuda).manual_seed(10)
    x, w, dy = _tc_operands(g, n, c, f, spatial, kernel, cuda)
    wd = flip_swap(w)
    routes = _tc_launches()
    for name, run, plain in (
            ("forward", lambda: cf.conv3d_flat_cuda(x, w), lambda: cf.conv3d_flat_plain(x, w)),
            ("dgrad", lambda: cf.conv3d_flat_cuda(dy, wd, "dgrad"),
             lambda: cf.conv3d_flat_plain(dy, wd)),
            ("wgrad", lambda: cf.conv3d_flat_wgrad_cuda(x, dy, kernel),
             lambda: cf.conv3d_flat_wgrad_plain(x, dy, kernel))):
        out, again = run(), run()
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and torch.isfinite(out).all().item(), name
        assert torch.equal(out, again), f"{name}: two runs differ"
        assert _rel_err(out, plain()) <= 1e-2, name
    assert _tc_launches() == (routes[0] + 4, routes[1] + 2)


@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_tensor_core_kernels_take_misaligned_views(cuda, offset):
    """A contiguous view `offset` elements into its storage (as one half of a batch cut
    with narrow can be): narrower loads, the same result."""
    g = torch.Generator(device=cuda).manual_seed(11)
    shape, dshape, kernel = (2, 16, 3, 16, 16), (2, 32, 3, 16, 16), (3, 3, 3)
    xbuf = torch.randn(math.prod(shape) + offset, generator=g, device=cuda).bfloat16()
    dbuf = torch.randn(math.prod(dshape) + offset, generator=g, device=cuda).bfloat16()
    x, dy = xbuf[offset:].view(shape), dbuf[offset:].view(dshape)
    assert x.is_contiguous() and x.data_ptr() % 16 == (2 * offset) % 16
    w = (torch.randn((*kernel, 16, 32), generator=g, device=cuda) * 0.1).bfloat16()
    y = cf.conv3d_flat_cuda(x, w)
    assert _rel_err(y, cf.conv3d_flat_plain(x, w)) <= 1e-2
    assert torch.equal(y, cf.conv3d_flat_cuda(x.clone(), w))
    dw = cf.conv3d_flat_wgrad_cuda(x, dy, kernel)
    assert _rel_err(dw, cf.conv3d_flat_wgrad_plain(x, dy, kernel)) <= 1e-2
    assert torch.equal(dw, cf.conv3d_flat_wgrad_cuda(x.clone(), dy.clone(), kernel))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 16, 4, 8, 8), (16, 3, 5, 7)])
def test_minibatch_stddev_kernel_matches_plain_and_repeats(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    launches = mb.minibatch_stddev_stat_cuda.launches
    s = mb.minibatch_stddev_stat(x)
    again = mb.minibatch_stddev_stat(x)
    torch.cuda.synchronize()
    assert mb.minibatch_stddev_stat_cuda.launches == launches + 2
    assert s.shape == (shape[0] // 4, 1) and torch.equal(s, again)
    torch.testing.assert_close(s, mb.minibatch_stddev_stat_plain(x), rtol=1e-5, atol=0)


# group sizes outside the kernel's template sizes (1, 2, 4, 8): up to 8 over guarded rows
# in registers, above 8 the loop that reads the rows twice; f16, element loads (rows not
# on 16 bytes, a misaligned view) and a larger input, whose plan takes eight vectors a
# lane, too
@pytest.mark.parametrize("shape,dtype,group", [
    ((12, 16, 8, 32, 32), torch.float32, 3), ((10, 3, 5, 7), torch.bfloat16, 5),
    ((16, 64, 4, 4), torch.float16, 16), ((6, 5, 7), torch.float16, 6),
    ((20, 8, 16, 16), torch.bfloat16, 10), ((14, 3, 33), torch.float32, 7),
    ((16, 64, 8, 8), torch.bfloat16, 8), ((4, 16, 32, 64, 64), torch.float32, 2),
    ((3, 33), torch.float32, 4)])
@pytest.mark.parametrize("offset", [0, 1])
def test_minibatch_stddev_kernel_any_group_size(cuda, shape, dtype, group, offset):
    g = torch.Generator(device=cuda).manual_seed(10)
    buf = torch.randn(math.prod(shape) + offset, generator=g, device=cuda).to(dtype)
    x = buf[offset:].view(shape)
    launches = mb.minibatch_stddev_stat_cuda.launches
    s = mb.minibatch_stddev_stat_cuda(x, group)
    again = mb.minibatch_stddev_stat_cuda(x.clone(), group)
    torch.cuda.synchronize()
    assert mb.minibatch_stddev_stat_cuda.launches == launches + 2
    assert torch.equal(s, again)
    ref = mb.minibatch_stddev_stat_plain(x, group)
    assert (s - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_minibatch_stddev_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        mb.minibatch_stddev_stat_cuda(torch.zeros(4, 8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        mb.minibatch_stddev_stat_cuda(torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match="group size"):
        mb.minibatch_stddev_stat_cuda(torch.zeros(6, 4, device=cuda))


def test_gp_pattern_through_the_kernels_matches_cudnn_double_backward(cuda):
    """tests/test_pallas_conv.py:46-63 on the card, f32, TF32 off."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 3, 4, 6, 6, generator=g, device=cuda)
    w0 = torch.randn(3, 3, 3, 3, 5, generator=g, device=cuda) * 0.3

    def gp(conv):
        xt, wt = x.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(torch.tanh(conv(xt, wt)).sum(), xt, create_graph=True)
        return torch.autograd.grad(gx.square().sum(), wt)[0]

    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        ref = gp(lambda a, b: F.conv3d(a, b.permute(4, 3, 0, 1, 2), padding="same"))
        launches = cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches
        ours = gp(conv3d_c)
    assert cf.conv3d_flat_cuda.launches > launches[0]
    assert cf.conv3d_flat_wgrad_cuda.launches > launches[1]
    torch.testing.assert_close(ours, ref, rtol=1e-3, atol=1e-3)


def test_gp_pattern_in_bf16_through_the_tensor_cores_matches_cudnn(cuda):
    """The same pattern in bf16: the penalty's double backward runs the tensor-core
    forward, dgrad and wgrad with `uw`-shaped weights; cuDNN's bf16 double backward is the
    yardstick, within 2e-2 of max|ref| (bf16 rounds every intermediate)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(2, 16, 4, 8, 8, generator=g, device=cuda).bfloat16()
    w0 = (torch.randn(3, 3, 3, 16, 32, generator=g, device=cuda) * 0.05).bfloat16()

    def gp(conv):
        xt, wt = x.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(torch.tanh(conv(xt, wt)).float().sum(), xt,
                                    create_graph=True)
        return torch.autograd.grad(gx.float().square().sum(), wt)[0]

    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        ref = gp(lambda a, b: F.conv3d(a, b.permute(4, 3, 0, 1, 2), padding="same"))
        routes = _tc_launches()
        ours = gp(conv3d_c)
    assert all(now > before for now, before in zip(_tc_launches(), routes))
    assert ours.dtype == torch.bfloat16
    assert _rel_err(ours, ref) <= 2e-2


def test_fused_backward_matches_plain_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 16, 3, 8, 8, generator=g, device=cuda, requires_grad=True)
    b = torch.randn(16, generator=g, device=cuda, requires_grad=True)
    gy = torch.randn(2, 16, 3, 8, 8, generator=g, device=cuda)
    ours = torch.autograd.grad(fba.bias_act_pixelnorm(x, b), (x, b), gy)
    ref = torch.autograd.grad(fba.bias_act_pixelnorm_plain(x, b, 0.2, True), (x, b), gy)
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


def _gb_tol(gx):
    """Per channel: gb sums N * S terms, so two f32 orders of that sum differ by a
    multiple of eps * ||gx_c||_2, not of |gb_c|."""
    return 1e-5 * gx.double().square().sum([0, *range(2, gx.ndim)]).sqrt()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pixelnorm", [((2, 16, 3, 8, 8), True), ((8, 256, 1, 4, 4), True),
                                             ((2, 33, 5, 7), True), ((1, 16, 4, 64, 64), True),
                                             ((2, 20, 3, 9), False), ((1, 1, 4, 9), True),
                                             ((3, 1, 2, 8, 8), True), ((2, 300, 3, 7), True),
                                             ((1, 512, 4, 8), True), ((2, 512, 2, 4, 4), True),
                                             ((1, 300, 2, 8, 8), False)])
def test_fused_backward_kernel_matches_plain_and_repeats(cuda, shape, pixelnorm, dtype):
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(shape[1], generator=g, device=cuda)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    launches = fba.fused_bias_act_pixelnorm_grad.launches
    gx, gb = fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, pixelnorm)
    gx2, gb2 = fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, pixelnorm)
    torch.cuda.synchronize()
    assert fba.fused_bias_act_pixelnorm_grad.launches == launches + 2
    assert gx.dtype == dtype and gb.dtype == torch.float32
    assert torch.equal(gx, gx2) and torch.equal(gb, gb2)
    rgx, rgb = fba.bias_act_pixelnorm_grad_plain(x, b, gy, 0.2, pixelnorm)
    if dtype == torch.float32:
        torch.testing.assert_close(gx, rgx, rtol=1e-5, atol=1e-6)
        assert ((gb - rgb).abs().double() <= 1e-5 * rgb.abs() + _gb_tol(gx)).all()
    else:
        assert _rel_err(gx, rgx) <= 1e-2 and _rel_err(gb, rgb) <= 1e-2


def test_fused_backward_runs_the_kernel_not_the_plain_version(cuda):
    x = torch.randn(2, 16, 3, 8, 8, device=cuda, requires_grad=True)
    b = torch.randn(16, device=cuda, requires_grad=True)
    counts = (fba.fused_bias_act_pixelnorm_grad.launches, fba.bias_act_pixelnorm_grad_plain.calls)
    torch.autograd.grad(fba.bias_act_pixelnorm(x, b).square().sum(), (x, b))
    assert (fba.fused_bias_act_pixelnorm_grad.launches,
            fba.bias_act_pixelnorm_grad_plain.calls) == (counts[0] + 1, counts[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 16, 4, 32, 32), (8, 64, 2, 8, 8), (8, 256, 1, 4, 4),
                                   (8, 33, 5, 7), (8, 300, 2, 4, 4)])
def test_fused_kernels_sample_alone_equals_its_slot_in_the_batch(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(shape[1], generator=g, device=cuda)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    y = fba.fused_bias_act_pixelnorm(x, b, 0.2, True)
    gx, _ = fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)
    for k in (0, 5, 7):
        assert torch.equal(fba.fused_bias_act_pixelnorm(x[k:k + 1], b, 0.2, True), y[k:k + 1])
        gx1, _ = fba.fused_bias_act_pixelnorm_grad(x[k:k + 1], b, gy[k:k + 1], 0.2, True)
        assert torch.equal(gx1, gx[k:k + 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_take_misaligned_views(cuda, dtype):
    """A contiguous view that starts off a 16-byte boundary goes element by element."""
    g = torch.Generator(device=cuda).manual_seed(17)
    shape = (2, 16, 4, 16, 16)
    n = math.prod(shape)
    x = torch.randn(n + 1, generator=g, device=cuda).to(dtype)[1:].view(shape)
    gy = torch.randn(n + 1, generator=g, device=cuda).to(dtype)[1:].view(shape)
    b = torch.randn(16, generator=g, device=cuda)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    y = fba.fused_bias_act_pixelnorm(x, b, 0.2, True)
    ref = fba.bias_act_pixelnorm_plain(x, b, 0.2, True)
    gx, gb = fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)
    rgx, rgb = fba.bias_act_pixelnorm_grad_plain(x, b, gy, 0.2, True)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gx, rgx, rtol=1e-5, atol=1e-6)
        assert ((gb - rgb).abs().double() <= 1e-5 * rgb.abs() + _gb_tol(gx)).all()
    else:
        assert _rel_err(y, ref) <= 1e-2 and _rel_err(gx, rgx) <= 1e-2 and _rel_err(gb, rgb) <= 1e-2
    # the aligned copy takes the 16-byte path and gives the same values
    assert torch.equal(fba.fused_bias_act_pixelnorm(x.clone(), b, 0.2, True), y)
    assert torch.equal(fba.fused_bias_act_pixelnorm_grad(x.clone(), b, gy.clone(), 0.2, True)[0], gx)


def test_fused_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(2, 16, 4, 8, device=cuda)
    b = torch.randn(16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fba.fused_bias_act_pixelnorm(x.transpose(2, 3), b, 0.2, True)
    with pytest.raises(ValueError, match="contiguous"):
        fba.fused_bias_act_pixelnorm_grad(x.transpose(2, 3), b, x.transpose(2, 3), 0.2, True)
    with pytest.raises(ValueError, match="dtype"):
        fba.fused_bias_act_pixelnorm_grad(x, b, x.bfloat16(), 0.2, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fba.fused_bias_act_pixelnorm(x.half(), b, 0.2, True)
    with pytest.raises(ValueError, match="b \\(C,\\)"):
        fba.fused_bias_act_pixelnorm(x, b[:8], 0.2, True)
    with pytest.raises(NotImplementedError, match="autograd graph"):
        fba.fused_bias_act_pixelnorm(x, b.clone().requires_grad_(True), 0.2, True)


def test_fused_kernels_launch_once_per_call(cuda):
    from saragan_tpu_torch.tools.profile_training import launch_counts

    x = torch.randn(2, 16, 4, 16, 16, device=cuda).bfloat16()
    gy = torch.randn_like(x)
    b = torch.randn(16, device=cuda)
    fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)  # the counter exists
    for fn, name in ((lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True), "fused_fwd_kernel"),
                     (lambda: fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True),
                      "fused_bwd_kernel")):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.02)  # device events a little off the call stay inside the trace
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        kernels, launch_calls = launch_counts(prof)
        assert launch_calls == 1 and kernels == 1
        assert any(name in e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase2_train_step_runs_on_the_kernels(cuda, dtype):
    cfg = Config(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 8, 32, 32)",
                 latent_dim=16, filter_spec=[[16, 16], [16, 8], [8, 8]], loss_fn="wgan",
                 gp_weight=10.0, use_pallas_fusion=True, compute_dtype=dtype).finalize()
    arch = get_architecture("pgan")
    state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0), phase=2,
                                       cfg=cfg, device=cuda)
    step = make_train_step(arch, cfg, 2, go, do, conv_engine="flat")
    real = torch.randn(4, 1, 2, 8, 8, generator=torch.Generator(device=cuda).manual_seed(6),
                       device=cuda)
    def launches(role):
        return sum(n for k, n in cf.conv3d_flat_cuda.by_shape.items() if k[0] == role)

    roles = {role: launches(role) for role in ("forward", "dgrad")}
    counts = (cf.conv3d_flat_wgrad_cuda.launches, fba.fused_bias_act_pixelnorm.launches,
              cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls,
              fba.bias_act_pixelnorm_plain.calls)
    new, m = step(state, real, torch.Generator(device=cuda).manual_seed(7), 0.5, 1e-3, 1e-3)
    torch.cuda.synchronize()
    # the same counts as the CPU run of tests/test_torch_train_step.py (G: 2 convs that are
    # not 1x1x1, D: 3; the penalty's inner gradient launches no wgrad)
    assert launches("forward") - roles["forward"] == 8
    assert launches("dgrad") - roles["dgrad"] == 11
    assert cf.conv3d_flat_wgrad_cuda.launches - counts[0] == 8
    assert fba.fused_bias_act_pixelnorm.launches - counts[1] == 3
    assert (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls,
            fba.bias_act_pixelnorm_plain.calls) == counts[2:]
    assert all(torch.isfinite(v).item() for v in (m.gen_loss, m.disc_loss, m.gp_loss))
    assert any(not torch.equal(new.d_params[k], state.d_params[k]) for k in state.d_params)
    assert any(not torch.equal(new.g_params[k], state.g_params[k]) for k in state.g_params)


def test_two_step_cli_trainer_run_at_phase_2(cuda, tmp_path):
    """The CLI trains two steps at phase 2 (one mixing, one stabilizing) under `flat`,
    through the kernels and no plain version, and writes model_2.npz."""
    import json

    import numpy as np

    from saragan_tpu_torch.cli import main

    rng = np.random.default_rng(0)
    (tmp_path / "data" / "8x8").mkdir(parents=True)
    for i in range(6):
        np.save(tmp_path / "data" / "8x8" / f"{i}.npy",
                rng.normal(size=(8, 8, 8)).astype(np.float32))
    spec = tmp_path / "filters.json"
    spec.write_text(json.dumps({"filter_spec": [[16, 16], [16, 8]]}))
    counts = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches,
              fba.fused_bias_act_pixelnorm.launches, cf.conv3d_flat_plain.calls,
              cf.conv3d_flat_wgrad_plain.calls, fba.bias_act_pixelnorm_plain.calls)
    main(["pgan", str(tmp_path / "data"), "--start_shape", "(1, 4, 4, 4)",
          "--final_shape", "(1, 16, 16, 16)", "--starting_phase", "2", "--ending_phase", "2",
          "--latent_dim", "16", "--filter_spec", str(spec), "--base_batch_size", "4",
          "--mixing_nimg", "2", "--stabilizing_nimg", "2", "--noise_stddev", "0",
          "--g_lr", "1e-3", "--d_lr", "1e-3", "--loss_fn", "wgan", "--gp_weight", "10",
          "--conv_engine", "flat", "--use_pallas_fusion", "--compute_dtype", "bfloat16",
          "--summary_small_every_nsteps", "2", "--validation_fraction", "0",
          "--test_fraction", "0", "--logdir", str(tmp_path / "logs")])
    torch.cuda.synchronize()
    assert cf.conv3d_flat_cuda.launches > counts[0]
    assert cf.conv3d_flat_wgrad_cuda.launches > counts[1]
    assert fba.fused_bias_act_pixelnorm.launches > counts[2]
    assert (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls,
            fba.bias_act_pixelnorm_plain.calls) == counts[3:]
    assert (tmp_path / "logs" / "model_2.npz").is_file()
    events = [json.loads(line) for line in open(tmp_path / "logs" / "events.jsonl")]
    losses = [e["value"] for e in events if e["tag"] in ("Loss/d_loss", "Loss/g_loss")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len([e for e in events if e["tag"].startswith("Timing/step_ms")]) == 2
