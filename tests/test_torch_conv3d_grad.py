"""The conv's derivative algebra (``ops/conv3d_grad.py``): Conv3dC and Conv3dW on their
plain path (what a CPU tensor runs) against the JAX package's ``_conv3d_C`` /
``_conv3d_W`` with the Pallas engine in interpret mode, the WGAN-GP second-order
pattern, gradcheck and gradgradcheck in f64, bf16, and what the kernels refuse.

f32 tolerance rtol 1e-4 / atol 1e-5: sums of up to 27*C products in different orders.
The second-order pattern takes the reference test's own 5e-4 (tests/test_pallas_conv.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import saragan_tpu.ops.core as jcore
from saragan_tpu.ops.pallas_conv import conv3d_flat_wgrad as jax_wgrad
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops.conv3d_grad import Conv3dC, Conv3dW, conv3d_c, flip_swap

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
KERNELS = [(3, 3, 3), (1, 3, 3), (3, 1, 3)]


def _arrays(kernel, c=3, f=5, spatial=(4, 5, 6), n=2, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, *spatial)).astype(dtype)
    w = (rng.normal(size=(*kernel, c, f)) * 0.3).astype(dtype)
    dy = rng.normal(size=(n, f, *spatial)).astype(dtype)
    return x, w, dy


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


@pytest.fixture
def pallas_engine(monkeypatch):
    monkeypatch.setattr(jcore, "CONV3D_ALGORITHM", "pallas")


@pytest.mark.parametrize("kernel", KERNELS)
def test_conv3d_c_forward_and_grads_match_jax(pallas_engine, kernel):
    x, w, ct = _arrays(kernel)
    y_ref, vjp = jax.vjp(jcore._conv3d_C, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(ct))
    xt, wt = _t(x, True), _t(w, True)
    y = conv3d_c(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **F32)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), **F32)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **F32)


@pytest.mark.parametrize("kernel", KERNELS)
def test_conv3d_w_forward_and_grads_match_jax(pallas_engine, kernel):
    x, w, dy = _arrays(kernel, seed=1)
    uw = np.random.default_rng(2).normal(size=w.shape).astype(np.float32)
    np.testing.assert_allclose(
        cf.conv3d_flat_wgrad_plain(_t(x), _t(dy), kernel).numpy(),
        np.asarray(jax_wgrad(jnp.asarray(x), jnp.asarray(dy), kernel, interpret=True)),
        rtol=2e-4, atol=2e-5)  # the reference test's own wgrad tolerance
    dw_ref, vjp = jax.vjp(lambda a, b: jcore._conv3d_W(a, b, kernel), jnp.asarray(x),
                          jnp.asarray(dy))
    dx_ref, ddy_ref = vjp(jnp.asarray(uw))
    xt, dyt = _t(x, True), _t(dy, True)
    dw = Conv3dW.apply(xt, dyt, kernel)
    dx, ddy = torch.autograd.grad(dw, (xt, dyt), _t(uw))
    np.testing.assert_allclose(dw.detach().numpy(), np.asarray(dw_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), **F32)
    np.testing.assert_allclose(ddy.numpy(), np.asarray(ddy_ref), **F32)


def test_gp_second_order_matches_jax_and_cudnn_double_backward(pallas_engine):
    """The WGAN-GP pattern of tests/test_pallas_conv.py:46-63: d/dw of
    sum((d/dx sum(tanh(C(x, w))))^2)."""
    x, w, _ = _arrays((3, 3, 3), c=2, f=3, seed=2)

    def jax_gp(conv):
        def inner(ww):
            g = jax.grad(lambda xx: jnp.sum(jnp.tanh(conv(xx, ww))))(jnp.asarray(x))
            return jnp.sum(jnp.square(g))

        return np.asarray(jax.grad(inner)(jnp.asarray(w)))

    def torch_gp(conv):
        xt, wt = _t(x, True), _t(w, True)
        (g,) = torch.autograd.grad(torch.tanh(conv(xt, wt)).sum(), xt, create_graph=True)
        (gw,) = torch.autograd.grad(torch.square(g).sum(), wt)
        return gw.numpy()

    def library(xx, ww):
        return F.conv3d(xx, ww.permute(4, 3, 0, 1, 2), padding="same")

    ours = torch_gp(conv3d_c)
    np.testing.assert_allclose(ours, jax_gp(jcore._conv3d_C), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(ours, torch_gp(library), rtol=5e-4, atol=5e-4)


def test_input_gradient_launches_no_wgrad():
    """grad(D(x), x) needs no weight gradient: the backward asks the engine and skips
    it; the parameter gradient then runs it."""
    x, w, _ = _arrays((3, 3, 3), seed=3)
    xt, wt = _t(x, True), _t(w, True)
    calls = cf.conv3d_flat_wgrad_plain.calls
    y = conv3d_c(torch.tanh(conv3d_c(xt, wt[..., :3])), wt)
    (g,) = torch.autograd.grad(y.sum(), xt, create_graph=True)
    assert cf.conv3d_flat_wgrad_plain.calls == calls
    torch.autograd.grad(g.square().sum(), wt)
    assert cf.conv3d_flat_wgrad_plain.calls > calls


@pytest.mark.parametrize("kernel", [(3, 3, 3), (1, 3, 3)])
def test_gradcheck_and_gradgradcheck_f64(kernel):
    x, w, dy = _arrays(kernel, c=2, f=2, spatial=(3, 4, 4), n=1, seed=4, dtype=np.float64)
    xt, wt, dyt = _t(x, True), _t(w, True), _t(dy, True)
    assert torch.autograd.gradcheck(lambda a, b: Conv3dC.apply(a, b), (xt, wt))
    assert torch.autograd.gradgradcheck(lambda a, b: Conv3dC.apply(a, b), (xt, wt))
    assert torch.autograd.gradcheck(lambda a, b: Conv3dW.apply(a, b, kernel), (xt, dyt))
    assert torch.autograd.gradgradcheck(lambda a, b: Conv3dW.apply(a, b, kernel), (xt, dyt))


def test_flip_swap_is_an_involution():
    w = torch.randn(3, 1, 5, 2, 4)
    fs = flip_swap(w)
    assert fs.shape == (3, 1, 5, 4, 2) and fs.is_contiguous()
    assert torch.equal(fs[0, 0, 0], w[2, 0, 4].T)
    assert torch.equal(flip_swap(fs), w)


def test_bf16_forward_matches_reference_tolerance():
    """bf16 operands, f32 accumulation, one rounding (tests/test_pallas_conv.py:66-72)."""
    x, w, dy = _arrays((3, 3, 3))
    y = conv3d_c(_t(x).bfloat16(), _t(w).bfloat16())
    assert y.dtype == torch.bfloat16
    ref = np.asarray(jcore._conv_direct(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=0.06, atol=0.06)
    # wgrad: one rounding of the f32 sum over the same bf16 operands
    xb, dyb = _t(x).bfloat16(), _t(dy).bfloat16()
    dw = Conv3dW.apply(xb, dyb, (3, 3, 3))
    assert dw.dtype == torch.bfloat16
    ref = cf.conv3d_flat_wgrad_plain(xb.float(), dyb.float(), (3, 3, 3))
    np.testing.assert_allclose(dw.float().numpy(), ref.numpy(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("kernel", [(2, 3, 3), (3, 3, 4)])
def test_even_kernels_refused(kernel):
    x, w, dy = _arrays(kernel)
    with pytest.raises(ValueError, match="odd"):
        conv3d_c(_t(x), _t(w))
    with pytest.raises(ValueError, match="odd"):
        Conv3dW.apply(_t(x), _t(dy), kernel)


def test_kernel_wrappers_refuse_cpu_and_graphs():
    x, w, dy = (_t(a) for a in _arrays((3, 3, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        cf.conv3d_flat_wgrad_cuda(x, dy, (3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        cf.conv3d_flat_cuda(x, w)
    with pytest.raises(ValueError, match="differ outside the channel axis"):
        cf.conv3d_flat_wgrad(x, dy[:1], (3, 3, 3))
