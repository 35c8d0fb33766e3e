"""The port's hand-written kernels against their plain versions on the card, the conv's
derivative algebra against cuDNN's double backward, and one train step under ``flat``.

Needs an NVIDIA GPU, nvcc and triton; skipped without them.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import torch.nn.functional as F

from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.ops.conv3d_grad import conv3d_c
from saragan_tpu_torch.train.step import init_train_state, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ragged shapes: channels that are not multiples of the staged chunk (8) or the
# per-block filter tile (16), volumes that are not multiples of the 16x32 output tile
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
                                   (1, 256, 1, 4, 4)])
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


def test_fused_backward_matches_plain_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 16, 3, 8, 8, generator=g, device=cuda, requires_grad=True)
    b = torch.randn(16, generator=g, device=cuda, requires_grad=True)
    gy = torch.randn(2, 16, 3, 8, 8, generator=g, device=cuda)
    ours = torch.autograd.grad(fba.bias_act_pixelnorm(x, b), (x, b), gy)
    ref = torch.autograd.grad(fba.bias_act_pixelnorm_plain(x, b, 0.2, True), (x, b), gy)
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


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
