"""Fused bias + leaky ReLU + pixel norm: the port's plain version (what its wrapper
runs on a CPU tensor) against the JAX package's Pallas kernel in interpret mode and its
unfused oracle (same f32 math, so the JAX kernel file's own tolerance), and the
``autograd.Function``'s first- and second-order gradients against jax.grad of the
reference's custom-JVP op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saragan_tpu.ops.pallas_kernels import _reference_forward, fused_bias_act_pixelnorm
from saragan_tpu_torch.ops import fused_bias_act as fba

torch.set_num_threads(1)


@pytest.mark.parametrize("c", [16, 64, 256])
@pytest.mark.parametrize("pixelnorm", [True, False])
@pytest.mark.parametrize("spatial", [(2, 4, 8), (4, 8)], ids=["3d", "2d"])
def test_plain_matches_jax_kernel_and_oracle(spatial, pixelnorm, c):
    rng = np.random.default_rng(c + 7 * pixelnorm + len(spatial))
    x = rng.normal(size=(2, c, *spatial)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    ours = fba.bias_act_pixelnorm(torch.from_numpy(x), torch.from_numpy(b), 0.2, pixelnorm)
    kernel = np.asarray(fused_bias_act_pixelnorm(jnp.asarray(x), jnp.asarray(b), 0.2, pixelnorm))
    oracle = np.asarray(_reference_forward(jnp.asarray(x), jnp.asarray(b), 0.2, pixelnorm))
    np.testing.assert_allclose(ours.numpy(), kernel, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.numpy(), oracle, rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_runs_plain_version_not_kernel():
    x = torch.randn(2, 16, 2, 4, 4)
    b = torch.randn(16)
    launches, calls = fba.fused_bias_act_pixelnorm.launches, fba.bias_act_pixelnorm_plain.calls
    y = fba.bias_act_pixelnorm(x, b)
    assert fba.fused_bias_act_pixelnorm.launches == launches
    assert fba.bias_act_pixelnorm_plain.calls == calls + 1
    torch.testing.assert_close(y, fba.bias_act_pixelnorm_plain(x, b, 0.2, True))
    # the kernel wrapper itself never runs on a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        fba.fused_bias_act_pixelnorm(x, b, 0.2, True)


# ---------------------------------------------------------------------------
# The autograd.Function: primal from the kernel (its plain version on the CPU),
# gradient from the reference's oracle, against jax.grad of the reference's custom-JVP op
# ---------------------------------------------------------------------------

# f32: elementwise rtol/atol.  bf16: |ours - ref| <= 5e-2 * max|ref|, loose: the
# gradients are bf16 tensors whose channel and bias reductions (64 terms here) each
# framework sums in its own order and precision; 2-8 bf16 ulps apart on these inputs
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": 5e-2}


def _inputs(dtype, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 2, 4, 4)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (jnp.asarray(x, jdt), jnp.asarray(b), jnp.asarray(gy, jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(b), torch.from_numpy(gy).to(tdt))


def _close(ours, ref, dtype):
    ours, ref = ours.detach().float().numpy(), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, **GRAD_TOL[dtype])
    else:
        assert np.abs(ours - ref).max() <= GRAD_TOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_first_order_grads_match_jax(dtype):
    jx, jb, jgy, x, b, gy = _inputs(dtype)
    y_ref, vjp = jax.vjp(lambda xx, bb: fused_bias_act_pixelnorm(xx, bb, 0.2, True), jx, jb)
    dx_ref, db_ref = vjp(jgy)
    x.requires_grad_(True)
    b.requires_grad_(True)
    y = fba.bias_act_pixelnorm(x, b)
    dx, db = torch.autograd.grad(y, (x, b), gy)
    assert dx.dtype == x.dtype and db.dtype == torch.float32
    _close(y, y_ref, dtype)
    _close(dx, dx_ref, dtype)
    _close(db, db_ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_second_order_grads_match_jax(dtype):
    """d/d(x, b) of sum((d/dx <y, gy>)^2): the penalty's grad-of-grad pattern."""
    jx, jb, jgy, x, b, gy = _inputs(dtype, seed=12)

    def jax_h(xx, bb):
        g = jax.grad(lambda u: jnp.sum((fused_bias_act_pixelnorm(u, bb, 0.2, True) * jgy)
                                       .astype(jnp.float32)))(xx)
        return jnp.sum(jnp.square(g.astype(jnp.float32)))

    hx_ref, hb_ref = jax.grad(jax_h, argnums=(0, 1))(jx, jb)
    x.requires_grad_(True)
    b.requires_grad_(True)
    y = fba.bias_act_pixelnorm(x, b)
    (g,) = torch.autograd.grad((y * gy).float().sum(), x, create_graph=True)
    hx, hb = torch.autograd.grad(g.float().square().sum(), (x, b))
    _close(hx, hx_ref, dtype)
    _close(hb, hb_ref, dtype)


def test_function_backward_recomputes_without_plain_version_calls():
    """The backward is the gradient oracle, not the kernel's plain version: a CUDA step
    shows 0 plain-version calls while the gradient flows."""
    x = torch.randn(2, 16, 2, 4, 4, requires_grad=True)
    b = torch.zeros(16, requires_grad=True)
    y = fba.bias_act_pixelnorm(x, b)
    calls = fba.bias_act_pixelnorm_plain.calls
    torch.autograd.grad(y.sum(), (x, b))
    assert fba.bias_act_pixelnorm_plain.calls == calls
