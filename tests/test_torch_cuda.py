"""The port's hand-written kernels against their plain versions on the card (the f32
CUDA-core conv through each register tile, the bf16 tensor-core convs, on ragged,
misaligned and small shapes, the wgrad's two stagers through its 16- and 32-output tiles,
the f32 wgrad, the fused op's forward and backward kernels at C from 1 to 512 and N = 1,
a sample alone against its slot in a batch, misaligned views and one launch per call;
#3 through both routes and behind ``Conv3dC`` under ``flat_v2``, and the standalone #5),
the conv's derivative algebra against cuDNN's double backward in f32 and bf16, one train step under ``flat``, each
other family's f32 gradients under ``flat`` against ``direct``, a two-step CLI
trainer run, every optimizer's update against the CPU's, a two-trial HPO study of the
flagship configuration on the kernels, and the tools: an artifact exported and served on
the card against the live generator, the data-preparation pyramid against the CPU and
the network smoke test on the kernels; the fused op at the 2-D run's shapes (C = 512 on
4^2 to 32^2, C = 64 on 256^2), a 2-D step on it with no conv kernel, and the native
prefetcher's pinned batches.

Needs an NVIDIA GPU and nvcc; skipped without them.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math
import time
from collections import Counter

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


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_conv3d_c_under_flat_v2_matches_its_plain_version(cuda, dtype, limit):
    """``Conv3dC`` under ``flat_v2`` (kernel #3 for forward and dgrad, the library's
    wgrad) on the card against the same algebra on the CPU, where #3 is its plain
    version: forward and dgrad within `limit` of max|CPU|, #3 launched for both roles and
    #1 never."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 16, 4, 8, 8, generator=g).to(dtype)
    w = (torch.randn(3, 3, 3, 16, 24, generator=g) * 0.05).to(dtype)
    dy = torch.randn(2, 24, 4, 8, 8, generator=g).to(dtype)
    algebra = ("flat_v2", "library", "f32")

    def run(device):
        xt = x.to(device).requires_grad_(True)
        y = conv3d_c(xt, w.to(device), algebra)
        (dx,) = torch.autograd.grad(y, xt, dy.to(device))
        return y.detach().cpu().float(), dx.cpu().float()

    ref = run("cpu")
    before = Counter(role for role, *_ in cf.conv3d_flat_v2_cuda.by_shape.elements())
    v1 = cf.conv3d_flat_cuda.launches
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        ours = run(cuda)
    after = Counter(role for role, *_ in cf.conv3d_flat_v2_cuda.by_shape.elements())
    assert after["forward"] > before["forward"] and after["dgrad"] > before["dgrad"]
    assert cf.conv3d_flat_cuda.launches == v1
    for a, b in zip(ours, ref):
        assert (a - b).abs().max() <= limit * b.abs().max()


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


@pytest.mark.parametrize("arch", ["pgan2", "pgandeep", "stylegan", "stylegan2", "surfgan"])
def test_family_f32_gradients_flat_as_close_to_f64_as_direct(cuda, arch):
    """Each family's f32 gradients of one step at phase 2 (stylegan2: 1) under `flat`
    (the kernels) and `direct` (cuDNN, TF32 off), from one state and one set of draws
    (the style families' noise and mixing included), against the same step computed in
    f64 under `direct`.  Per variable, the kernels' largest gradient error is at most
    3e-3 of the network's largest gradient, or twice cuDNN's f32 error on that variable
    where that is larger: a variable that f32 rounding moves alike in both engines
    (stylegan G's constant-input noise strength, 1.07e-2 of the largest gradient under
    either on an H100) sets no limit for the other variables.  The
    f32 kernels hold each output within 1e-4 * max|y| of their plain versions (measured
    1.5e-5 to 3.3e-5, PERF.md section 6); a scalar's gradient that sums such outputs over
    every voxel, a noise strength's over 4 x 256 x 64 terms, gathers that as a random
    walk, about 256 x 1.5e-5 * max|dy| (stylegan2's read 1.32e-3 of the network's largest
    gradient on an H100, cuDNN 8e-7).  Under `flat` #1, #1' and #2 run and no plain
    version; surfgan's head conv takes C = 257."""
    from saragan_tpu_torch import losses
    from saragan_tpu_torch.train.step import make_grads_fn, style_phase

    phase = 1 if arch == "stylegan2" else 2
    cfg = Config(architecture=arch, start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)",
                 starting_phase=phase, ending_phase=phase, latent_dim=16, network_size="xxs",
                 loss_fn="wgan", gp_weight=10.0).finalize()
    a = get_architecture(arch)
    state, _ = init_train_state(a, torch.Generator().manual_seed(0), phase=phase, cfg=cfg,
                                device=cuda)
    real = torch.randn(cfg.current_shape(phase, 4),
                       generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    draws = losses.draw_inputs(torch.Generator(device=cuda).manual_seed(2), 4, 16,
                               real.shape[1:], torch.float32, cuda,
                               style_phase=style_phase(a, phase))
    f64 = draws._replace(**{f: getattr(draws, f).double() for f in ("z", "gamma", "z_mix")
                            if getattr(draws, f) is not None})
    grads = {}
    for engine, dtype, dr in (("direct", torch.float64, f64), ("direct", torch.float32, draws),
                              ("flat", torch.float32, draws)):
        c = Config(**{**cfg.__dict__, "compute_dtype": str(dtype).split(".")[-1]})
        before = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches,
                  cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls)
        (g, d), out = make_grads_fn(a, c, phase, conv_engine=engine)(
            state.g_params, state.d_params, real.to(dtype), dr, 0.5)
        torch.cuda.synchronize()
        after = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches,
                 cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls)
        launched = [x - y for x, y in zip(after, before)]
        if engine == "flat":
            assert launched[0] > 0 and launched[1] > 0 and launched[2:] == [0, 0], launched
        else:
            assert launched == [0, 0, 0, 0], launched
        assert torch.isfinite(out.disc_loss).item() and torch.isfinite(out.gen_loss).item()
        grads[(engine, dtype)] = (g, d)
    for net in (0, 1):
        exact = grads[("direct", torch.float64)][net]
        top = max(v.abs().max().item() for v in exact.values())
        err = {engine: {k: (grads[(engine, torch.float32)][net][k] - v).abs().max().item() / top
                        for k, v in exact.items()} for engine in ("flat", "direct")}
        worst = {engine: max(e.items(), key=lambda kv: kv[1]) for engine, e in err.items()}
        over = {k: (e, err["direct"][k]) for k, e in err["flat"].items()
                if e > 2 * err["direct"][k]}
        print(f"{arch} {'GD'[net]}: f32 error / largest gradient, per variable: flat worst "
              f"{worst['flat']}, direct worst {worst['direct']}; flat past twice direct: "
              f"{max(over.items(), key=lambda kv: kv[1][0]) if over else None}")
        assert all(e <= 3e-3 for e, _ in over.values()), (net, over)


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


# ---------------------------------------------------------------------------
# The big-volume phases: the kernels at phase 8's full resolution (C = 8 at 128x512x512),
# on tensors of more than 2^31 elements, and the offload step's memory
# ---------------------------------------------------------------------------

BIG = (128, 512, 512)


def _within(out, ref, limit=1e-2):
    err = (out.float() - ref.float()).abs().max().item()
    return err <= limit * ref.float().abs().max().item() and torch.isfinite(out).all().item()


@pytest.mark.parametrize("kernel", ["forward", "dgrad", "wgrad", "fused", "fused_grad"])
def test_kernels_at_the_phase8_shape_match_plain(cuda, kernel):
    """#1, #1' (the forward on flipped, io-swapped weights), #2 and #4 forward and
    backward at phase 8's full-resolution shape in bf16 (C = F = 8, 3x3x3), against their
    plain versions within 1e-2 of max|plain|, as at phase 6."""
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn((1, 8, *BIG), generator=g, device=cuda, dtype=torch.bfloat16)
    other = torch.randn((1, 8, *BIG), generator=g, device=cuda, dtype=torch.bfloat16)
    b = torch.randn(8, generator=g, device=cuda)
    if kernel in ("forward", "dgrad"):
        w = torch.randn((3, 3, 3, 8, 8), generator=g, device=cuda) * (2 / 216) ** 0.5
        w = w.bfloat16() if kernel == "forward" else flip_swap(w.bfloat16())
        pairs = [(cf.conv3d_flat_cuda(x, w, kernel), cf.conv3d_flat_plain(x, w))]
    elif kernel == "wgrad":
        pairs = [(cf.conv3d_flat_wgrad_cuda(x, other, (3, 3, 3)),
                  cf.conv3d_flat_wgrad_plain(x, other, (3, 3, 3)))]
    elif kernel == "fused":
        pairs = [(fba.fused_bias_act_pixelnorm(x, b, 0.2, True),
                  fba.bias_act_pixelnorm_plain(x, b, 0.2, True))]
    else:
        pairs = list(zip(fba.fused_bias_act_pixelnorm_grad(x, b, other, 0.2, True),
                         fba.bias_act_pixelnorm_grad_plain(x, b, other, 0.2, True)))
    torch.cuda.synchronize()
    for out, ref in pairs:
        assert _within(out, ref)


@pytest.mark.parametrize("kernel,dtype", [
    ("forward", torch.bfloat16), ("forward", torch.float32), ("wgrad", torch.bfloat16),
    ("fused", torch.bfloat16), ("fused_grad", torch.bfloat16)])
def test_kernels_past_2_31_elements_match_plain_sample_by_sample(cuda, kernel, dtype):
    """N = 9, C = 8, 128x512x512: 2.42e9 elements a tensor, past 2^31 (4.8 GB in bf16,
    9.7 GB in f32), so the last samples lie past every 32-bit element offset.  Each
    sample's output against the plain version of that sample alone (1e-2 of max|plain|
    in bf16, 1e-4 in f32); the weight gradient against the sum of the samples' plain
    gradients in f32, the bias gradient against the f64 sum of the samples' plain gx and
    against the sum of their f32 plain gradients on the bias rounded to bf16."""
    n, limit = 9, 1e-2 if dtype == torch.bfloat16 else 1e-4
    g = torch.Generator(device=cuda).manual_seed(22)
    x = torch.randn((n, 8, *BIG), generator=g, device=cuda, dtype=dtype)
    assert x.numel() > 2 ** 31
    b = torch.randn(8, generator=g, device=cuda)
    if kernel == "forward":
        w = (torch.randn((3, 3, 3, 8, 8), generator=g, device=cuda) * (2 / 216) ** 0.5).to(dtype)
        y = cf.conv3d_flat_cuda(x, w)
        torch.cuda.synchronize()
        for i in range(n):
            assert _within(y[i:i + 1], cf.conv3d_flat_plain(x[i:i + 1], w), limit), i
    elif kernel == "fused":
        y = fba.fused_bias_act_pixelnorm(x, b, 0.2, True)
        torch.cuda.synchronize()
        for i in range(n):
            assert _within(y[i:i + 1], fba.bias_act_pixelnorm_plain(x[i:i + 1], b, 0.2, True)), i
    else:
        gy = torch.randn((n, 8, *BIG), generator=g, device=cuda, dtype=dtype)
        if kernel == "wgrad":
            dw = cf.conv3d_flat_wgrad_cuda(x, gy, (3, 3, 3))
            torch.cuda.synchronize()
            ref = sum(cf.conv3d_flat_wgrad_plain(x[i:i + 1].float(), gy[i:i + 1].float(),
                                                 (3, 3, 3)) for i in range(n))
            assert _within(dw, ref)
        else:
            gx, gb = fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)
            torch.cuda.synchronize()
            # gb is the f64 sum of gx over the batch's voxels, rounded once through bf16.
            # gb sums 3e8 terms of either sign down to about 1e-4 of their magnitudes, so
            # an f32 reference must take b as the kernel does, rounded to x's dtype: with
            # b unrounded every voxel's u moves and the channels' sums drift apart by
            # several per cent of max|gb| (printed for the record, pytest -s)
            gb_sum = torch.zeros(8, dtype=torch.float64, device=cuda)
            gb_f32 = {"b in bf16": torch.zeros_like(gb), "b in f32": torch.zeros_like(gb)}
            for i in range(n):
                rgx, _ = fba.bias_act_pixelnorm_grad_plain(x[i:i + 1], b, gy[i:i + 1], 0.2, True)
                assert _within(gx[i:i + 1], rgx), i
                gb_sum += rgx.double().sum(dim=[0, 2, 3, 4])
                for name, bias in (("b in bf16", b.to(dtype).float()), ("b in f32", b)):
                    gb_f32[name] += fba.bias_act_pixelnorm_grad_plain(
                        x[i:i + 1].float(), bias, gy[i:i + 1].float(), 0.2, True)[1]
            print(f"gb past 2^31 elements: kernel {gb.tolist()}, f64 sum of the plain bf16 gx "
                  f"{gb_sum.tolist()}, f32 plain " + ", ".join(
                      f"({name}) {v.tolist()}" for name, v in gb_f32.items()))
            assert _within(gb, gb_sum.float().to(dtype).float())
            assert _within(gb, gb_f32["b in bf16"])


def test_f32_forward_takes_a_sample_past_2_31_elements(cuda):
    """#1 in f32 on one sample of C * D * H * W = 2^31 elements (C = 64 at 128x512x512,
    8.6 GB): its row table once held each staged row's offset from the sample's start in
    32 bits and refused such a sample; the offsets are formed in 64 bits now."""
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((1, 64, *BIG), generator=g, device=cuda)
    w = torch.randn((3, 3, 3, 64, 8), generator=g, device=cuda) * (2 / (27 * 64)) ** 0.5
    y = cf.conv3d_flat_cuda(x, w)
    torch.cuda.synchronize()
    assert _within(y, cf.conv3d_flat_plain(x, w), 1e-4)


def test_offload_step_peak_below_the_plain_step_at_phase_7(cuda):
    """Phase 7 (64x256x256), batch 2, bf16: the single_chip_big_volume step's peak device
    memory is below that of the same configuration without remat_offload, and it parks
    the block taps in host memory."""
    import dataclasses

    from saragan_tpu_torch.tools.profile_training import bench_train_config, probe

    cfg = bench_train_config(7, 2, single_chip_big_volume=True)
    rows = {name: probe(c, 7, 2, 1, cuda) for name, c in (
        ("offload", cfg), ("plain", dataclasses.replace(cfg, remat_offload=False)))}
    assert not rows["offload"]["oom"] and not rows["plain"]["oom"]
    assert rows["offload"]["finite"] and rows["plain"]["finite"]
    assert rows["offload"]["peak_mib"] < rows["plain"]["peak_mib"]
    assert rows["offload"]["host_mib"] > 0 == rows["plain"]["host_mib"]


# ---------------------------------------------------------------------------
# The HPO slice: every optimizer's update on the card, and a study of the flagship
# configuration whose trials run on the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["Adam", "SGD", "Momentum", "Adadelta", "RAdam", "LAMB",
                                  "LARS", "AdamW"])
def test_optimizer_update_on_the_card_matches_the_cpu(cuda, name):
    """Three updates of a conv weight, a bias, a noise strength, a spectral vector and an
    all-zero weight, the same gradients on the card and on the CPU: parameters and every
    slot within 1e-6 relative (the trust ratio's norms sum in another order)."""
    from saragan_tpu_torch.optim.factory import make_optimizer

    g = torch.Generator().manual_seed(0)
    params = {"g/conv/weight": torch.randn(3, 3, 3, 64, 64, generator=g),
              "g/conv/bias": torch.zeros(64), "g/conv/noise_strength": torch.zeros(()),
              "d/dense/weight": torch.randn(512, 256, generator=g),
              "d/dense/weight_u": torch.randn(1, 256, generator=g),
              "d/zero/weight": torch.zeros(4, 4)}
    opt = make_optimizer(name, beta1=0.1, beta2=0.9, rho=0.9, momentum=0.8, weight_decay=0.05)
    states = {dev: (dict((k, v.to(dev)) for k, v in params.items()), None)
              for dev in ("cpu", "cuda")}
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 10.0 ** -step for k, v in params.items()}
        grads["d/dense/weight_u"].zero_()
        grads["d/zero/weight"].zero_()
        for dev, (p, s) in states.items():
            s = opt.init(p) if s is None else s
            states[dev] = opt.update({k: v.to(dev) for k, v in grads.items()}, s, p, 1e-2)
    (p_cpu, s_cpu), (p_gpu, s_gpu) = states["cpu"], states["cuda"]
    assert s_gpu.count == s_cpu.count == 3 and s_gpu.slots.keys() == s_cpu.slots.keys()
    pairs = [(p_gpu[k], p_cpu[k]) for k in params]
    pairs += [(s_gpu.slots[s][k], s_cpu.slots[s][k]) for s in s_cpu.slots for k in params]
    for gpu, cpu in pairs:
        assert gpu.device.type == "cuda"
        torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-6, atol=1e-7)


def test_two_trial_study_of_the_flagship_config_runs_the_kernels(cuda, tmp_path):
    """Two trials of an in-process study (the harness, random sampler) of the flagship
    configuration (pgan 'xs', WGAN-GP, bf16, the fused op, `flat`) at phase 4 (batch 32,
    8x32x32), 32 + 32 images, each trial drawing its optimizer: both COMPLETE, #1, #2 and
    #4 launched, no plain version, and the second trial leaves the device memory at the
    level it found (the first may leave the process's cuBLAS workspace behind)."""
    import numpy as np

    from saragan_tpu_torch.hpo import harness

    rng = np.random.default_rng(0)
    (tmp_path / "data" / "32x32").mkdir(parents=True)
    for i in range(40):
        np.save(tmp_path / "data" / "32x32" / f"{i}.npy",
                rng.normal(size=(8, 32, 32)).astype(np.float32))
    cfg = Config(architecture="pgan", dataset_path=str(tmp_path / "data"),
                 start_shape="(1, 1, 4, 4)", final_shape="(1, 128, 512, 512)",
                 starting_phase=4, ending_phase=4, latent_dim=256, network_size="xs",
                 base_batch_size=256, mixing_nimg=32, stabilizing_nimg=32, loss_fn="wgan",
                 gp_weight=10.0, noise_stddev=0.0, g_lr=1e-3, d_lr=1e-3, optimizer=None,
                 compute_dtype="bfloat16", use_pallas_fusion=True, conv_engine="flat",
                 grad_histograms=False, optuna_ntrials=2, optuna_sampler="random",
                 logdir=str(tmp_path / "logs"))
    levels = []

    def objective(trial, run_cfg):
        torch.cuda.synchronize()
        levels.append(torch.cuda.memory_allocated())
        return harness.default_objective(trial, run_cfg, device="cuda")

    counts = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches,
              fba.fused_bias_act_pixelnorm.launches, fba.fused_bias_act_pixelnorm_grad.launches)
    plain = (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls,
             fba.bias_act_pixelnorm_plain.calls, fba.bias_act_pixelnorm_grad_plain.calls)
    study = harness.run(cfg, objective)
    torch.cuda.synchronize()
    levels.append(torch.cuda.memory_allocated())
    assert [t.state for t in study.trials] == ["COMPLETE", "COMPLETE"]
    assert all(t.params["optimizer"] in ("Adam", "SGD", "Adadelta") for t in study.trials)
    after = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches,
             fba.fused_bias_act_pixelnorm.launches, fba.fused_bias_act_pixelnorm_grad.launches)
    assert all(a > b for a, b in zip(after, counts)), (after, counts)
    assert (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls,
            fba.bias_act_pixelnorm_plain.calls, fba.bias_act_pixelnorm_grad_plain.calls) == plain
    assert levels[2] == levels[1], levels


@pytest.mark.parametrize("name", ["pgan", "surfgan"])
def test_artifact_exported_on_the_card_equals_the_live_generator(cuda, tmp_path, name):
    """A phase-3 generator exported on the card (the artifact holds no hand-written
    kernel) equals the live generator under ``direct`` bit for bit, runs no kernel of the
    port, and moved to the CPU (``load_exported(device="cpu")``) agrees with the card
    within 1e-4 * max|card|."""
    import dataclasses

    import numpy as np

    from saragan_tpu_torch.core import filter_params
    from saragan_tpu_torch.ops.core import LayerNoise
    from saragan_tpu_torch.tools import export_model

    cfg = Config(architecture=name, start_shape="(1, 4, 4, 4)", final_shape="(1, 32, 32, 32)",
                 starting_phase=3, ending_phase=3, latent_dim=32, network_size="xs").finalize()
    arch = get_architecture(name)
    g = filter_params(arch.init(torch.Generator().manual_seed(0), phase=3, cfg=cfg,
                                device=cuda), "generator")
    g = {k: (torch.full_like(v, 0.3) if "noise_strength" in k else v) for k, v in g.items()}
    path = export_model.save_exported(str(tmp_path / "g.pt2"), export_model.export_generator(
        cfg, 3, g, batch_size=4, seed=5))
    gen = export_model.load_exported(path)
    z = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32))
    launches = (cf.conv3d_flat_cuda.launches, fba.fused_bias_act_pixelnorm.launches)
    out = gen(z)
    assert (cf.conv3d_flat_cuda.launches, fba.fused_bias_act_pixelnorm.launches) == launches
    live_cfg = dataclasses.replace(cfg, fused_transitions=True, use_pallas_fusion=False)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                     deterministic=True, allow_tf32=False):
        live = arch.generator(g, z.to(cuda), 0.0, phase=3, cfg=live_cfg, train=False,
                              noise=LayerNoise(5))
    assert out.device.type == "cuda" and torch.equal(out, live)
    on_cpu = export_model.load_exported(path, device="cpu")(z)
    assert on_cpu.device.type == "cpu"
    assert (on_cpu - out.cpu()).abs().max().item() <= 1e-4 * out.abs().max().item()


def test_pyramid_on_the_card_matches_the_cpu(cuda):
    """resample -> clip/pad/normalize -> the Lanczos pyramid of a (40, 300, 280) HU volume
    on the card against the CPU: every level within 2^-21 in HU/1024 units (two float32
    ulps at the top of the normalized range; chip_smoke.py's limit), absmax levels equal."""
    import numpy as np

    from saragan_tpu_torch.tools import prepare_data

    x = np.random.default_rng(0).normal(0, 600, size=(40, 300, 280)).astype(np.float32)
    for method in ("lanczos", "absmax"):
        card = prepare_data.process_volume(x, (2.5, 0.7, 0.7), method=method, device=cuda)
        host = prepare_data.process_volume(x, (2.5, 0.7, 0.7), method=method, device="cpu")
        assert [tuple(c.shape) for c in card] == [tuple(h.shape) for h in host]
        for c, h in zip(card, host):
            diff = (c.cpu().float() - h.float()).abs().max().item()
            assert diff <= 2.0 ** -21, (method, tuple(c.shape), diff)


def test_smoke_test_on_the_card_runs_the_kernels(cuda, capsys):
    """``tools.test_network`` at phase 3 on the card: the engine resolves to ``flat``, the
    forward, dgrad and wgrad kernels launch and no plain version runs."""
    from saragan_tpu_torch.tools import test_network

    before = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches)
    plain = (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls)
    report = test_network.main(["surfgan", "--phase", "3", "--latent_dim", "32"])
    assert report["conv_engine"] == "flat" and report["device"].startswith("cuda")
    assert math.isfinite(report["gen_loss"]) and report["device_bytes_in_use"] > 0
    assert cf.conv3d_flat_cuda.launches > before[0]
    assert cf.conv3d_flat_wgrad_cuda.launches > before[1]
    assert (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls) == plain
    assert "Total generator variables" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The 2-D path: #4 at ProGAN's widths, the 2-D step, the native prefetcher
# ---------------------------------------------------------------------------

# the G activations of the 2-D 'm' run: C = 512 at 4^2 .. 32^2 (batch 16, phase 6) and
# the last block's C = 64 at 256^2 (batch 8, phase 7)
TWO_D_FUSED = [(16, 512, 4, 4), (16, 512, 8, 8), (16, 512, 16, 16), (16, 512, 32, 32),
               (8, 64, 256, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TWO_D_FUSED, ids=lambda s: "x".join(map(str, s)))
def test_fused_kernels_at_the_2d_shapes(cuda, shape, dtype):
    """Forward and backward at the 2-D shapes (C = 512 plans a backward item of 8 voxels
    in f32): against the plain versions at the limits of the shapes above, bit-identical
    on a rerun."""
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(shape[1], generator=g, device=cuda)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    launches = (fba.fused_bias_act_pixelnorm.launches, fba.fused_bias_act_pixelnorm_grad.launches)
    y, y2 = (fba.fused_bias_act_pixelnorm(x, b, 0.2, True) for _ in range(2))
    (gx, gb), (gx2, gb2) = (fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)
                            for _ in range(2))
    torch.cuda.synchronize()
    assert (fba.fused_bias_act_pixelnorm.launches, fba.fused_bias_act_pixelnorm_grad.launches) \
        == (launches[0] + 2, launches[1] + 2)
    assert torch.equal(y, y2) and torch.equal(gx, gx2) and torch.equal(gb, gb2)
    ry = fba.bias_act_pixelnorm_plain(x, b, 0.2, True)
    rgx, rgb = fba.bias_act_pixelnorm_grad_plain(x, b, gy, 0.2, True)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gx, rgx, rtol=1e-5, atol=1e-6)
        assert ((gb - rgb).abs().double() <= 1e-5 * rgb.abs() + _gb_tol(gx)).all()
    else:
        assert _rel_err(y, ry) <= 1e-2 and _rel_err(gx, rgx) <= 1e-2
        assert _rel_err(gb, rgb) <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_2d_train_step_runs_the_fused_kernels_and_no_conv_kernel(cuda, dtype):
    """A 2-D pgan step (RGB, phase 3) with the fused op under the card's engine: #4's
    forward and backward launch once per G conv, rank-2 convs go to cuDNN (no conv
    kernel), no plain version runs, and the losses are finite."""
    cfg = Config(architecture="pgan", start_shape="(3, 4, 4)", final_shape="(3, 32, 32)",
                 latent_dim=32, network_size="xs", conv_kernel_size=(3, 3), loss_fn="wgan",
                 gp_weight=10.0, use_pallas_fusion=True, compute_dtype=dtype).finalize()
    arch = get_architecture("pgan")
    state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0), phase=3,
                                       cfg=cfg, device=cuda)
    step = make_train_step(arch, cfg, 3, go, do, conv_engine="flat")
    real = torch.randn(4, 3, 16, 16, generator=torch.Generator(device=cuda).manual_seed(6),
                       device=cuda)
    counts = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches,
              fba.fused_bias_act_pixelnorm.launches, fba.fused_bias_act_pixelnorm_grad.launches,
              fba.bias_act_pixelnorm_plain.calls, fba.bias_act_pixelnorm_grad_plain.calls)
    new, m = step(state, real, torch.Generator(device=cuda).manual_seed(7), 0.5, 1e-3, 1e-3)
    torch.cuda.synchronize()
    after = (cf.conv3d_flat_cuda.launches, cf.conv3d_flat_wgrad_cuda.launches,
             fba.fused_bias_act_pixelnorm.launches, fba.fused_bias_act_pixelnorm_grad.launches,
             fba.bias_act_pixelnorm_plain.calls, fba.bias_act_pixelnorm_grad_plain.calls)
    assert [a - c for a, c in zip(after, counts)] == [0, 0, 5, 5, 0, 0]
    assert all(torch.isfinite(v).item() for v in (m.gen_loss, m.disc_loss, m.gp_loss))
    assert any(not torch.equal(new.g_params[k], state.g_params[k]) for k in state.g_params)


def test_native_prefetcher_lands_batches_pinned(cuda, tmp_path):
    import numpy as np

    from saragan_tpu_torch.data import native

    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], np.random.default_rng(i).normal(size=(8, 16, 16)).astype(np.float32))
    pf = native.NativeBatchPrefetcher(lambda: paths, (1, 8, 16, 16), 0.5, 2.0,
                                      out_dtype=torch.bfloat16, pin_memory=True)
    try:
        host = next(pf)
    finally:
        pf.stop()
    assert host.is_pinned() and host.dtype == torch.bfloat16
    want = torch.from_numpy((np.stack([np.load(p) for p in paths])[:, None] - 0.5) / 2.0)
    on_card = host.to(cuda, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(on_card.cpu(), want.float().to(torch.bfloat16))


@pytest.mark.parametrize("axis,kernel", [(2, (3, 3, 3)), (2, (5, 3, 3)), (3, (3, 5, 3))])
def test_halo_conv_backward_and_double_backward_at_world_one(cuda, axis, kernel):
    """The differentiable halo exchange on the card over an NCCL group of one: the slab is
    the whole volume, so each halo is the zero slab of the volume's end, and the conv of
    the extended slab (``flat``: #1 on it, cropped; #1' and #2 in its backward) is the
    SAME conv.  Its output, the input and weight gradients and the second order of the
    penalty's shape (the gradients of L + |dL/dx|^2) against the unsharded ``flat`` conv,
    in f32 within 1e-4 of each one's largest value."""
    from saragan_tpu_torch.ops.core import conv_apply
    from saragan_tpu_torch.parallel import halo, init_mesh

    mesh = init_mesh("cuda:0", verbose=False)
    try:
        g = torch.Generator(device=cuda).manual_seed(3)
        x = torch.randn((2, 16, 8, 12, 10), generator=g, device=cuda)
        w = torch.randn((*kernel, 16, 8), generator=g, device=cuda) * 0.1
        r = kernel[axis - 2] // 2

        def halo_conv(a, b):
            ext = halo._HaloExchange.apply(a, r, mesh, axis)
            return halo._crop(conv_apply(ext, b, "flat"), {axis: r})

        out = []
        cf.conv3d_flat_cuda.launches = cf.conv3d_flat_wgrad_cuda.launches = 0
        for conv in (halo_conv, lambda a, b: conv_apply(a, b, "flat")):
            xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            y = conv(xs, ws)
            (gx,) = torch.autograd.grad((y * y).sum(), xs, create_graph=True)
            out.append([y.detach(), gx.detach(),
                        *torch.autograd.grad((y * y).sum() + (gx * gx).sum(), [xs, ws])])
        torch.cuda.synchronize()
        assert cf.conv3d_flat_cuda.launches > 0 and cf.conv3d_flat_wgrad_cuda.launches > 0
        for got, ref in zip(*out):
            assert got.shape == ref.shape
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-4 * ref.abs().max().item())
    finally:
        mesh.close()
