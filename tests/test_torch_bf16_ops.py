"""bf16 rounding of the port's ops against the JAX package's, on the same bf16 inputs.

Every op of the train step rounds where the reference rounds, so on these inputs the
two are bit-equal, except where a sum of products is taken in another order (the 1x1x1
channel GEMM, the polyphase conv), which gets a stated tolerance of one rounding.  Two
faults of the port were found this way and fixed (each left part of the outputs 1 bf16
ulp off): pixel_norm took its rsqrt in f32, and the leaky ReLU multiplied by the f32
slope instead of the slope rounded to bf16.  The 1x1x1 channel GEMM is
compared with the reference's math on f32-widened operands (XLA's CPU backend has no
bf16 x bf16 -> f32 dot): products of bf16 values are exact in f32, so only the summation
order may differ, which the stated tolerance covers."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jops
from saragan_tpu.core import Scope as JaxScope
from saragan_tpu.ops.pallas_kernels import _reference_forward
from saragan_tpu_torch.core import Scope
from saragan_tpu_torch.ops import core as ops
from saragan_tpu_torch.ops import fused_bias_act as fba

torch.set_num_threads(1)


def _bf16(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(ml_dtypes.bfloat16)


def _port(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _assert_bit_equal(ours: torch.Tensor, ref):
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(ref)
    assert ref.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(), ref.astype(np.float32))


def test_pixel_norm_bf16_bit_equal():
    x = _bf16((4, 16, 4, 16, 16), 0, scale=3.0)
    _assert_bit_equal(ops.pixel_norm(_port(x)), jops.pixel_norm(jnp.asarray(x)))


@pytest.mark.parametrize("op", ["upscale", "avg_unpool", "downscale"])
def test_resampling_bf16_bit_equal(op):
    x = _bf16((2, 8, 4, 6, 8), 1, scale=2.0)
    _assert_bit_equal(getattr(ops, op)(_port(x)), getattr(jops, op)(jnp.asarray(x)))


@pytest.mark.parametrize("activation", ["leaky_relu", "linear"])
def test_act_bf16_bit_equal(activation):
    x = _bf16((4, 16, 4, 16, 16), 2, scale=3.0)
    _assert_bit_equal(ops.act(_port(x), activation, param=0.2),
                      jops.act(jnp.asarray(x), activation, param=0.2))


def test_apply_bias_bf16_bit_equal():
    x = _bf16((2, 16, 3, 4, 5), 3, scale=2.0)
    b = np.random.default_rng(4).normal(size=(16,)).astype(np.float32)
    ours = ops.apply_bias(Scope({"bias": torch.from_numpy(b)}), _port(x))
    _assert_bit_equal(ours, jops.apply_bias(JaxScope({"bias": jnp.asarray(b)}), jnp.asarray(x)))


def test_dense_bf16_bit_equal():
    x = _bf16((8, 64), 5)
    w = np.random.default_rng(6).normal(size=(64, 96)).astype(np.float32)
    ours = ops.dense(Scope({"weight": torch.from_numpy(w)}), _port(x), 96, "leaky_relu",
                     param=0.2)
    ref = jops.dense(JaxScope({"weight": jnp.asarray(w)}), jnp.asarray(x), 96, "leaky_relu",
                     param=0.2)
    _assert_bit_equal(ours, ref)


@pytest.mark.parametrize("c,f", [(1, 16), (16, 8)], ids=["c1", "skinny"])
def test_conv3d_1x1_mulsum_bf16_bit_equal(c, f):
    x, w = _bf16((2, c, 4, 8, 8), 7), _bf16((1, 1, 1, c, f), 8, scale=0.3)
    _assert_bit_equal(ops._conv3d_1x1(_port(x), _port(w)),
                      jops._conv3d_shifted_gemm(jnp.asarray(x), jnp.asarray(w)))


def test_conv3d_1x1_gemm_bf16_one_rounding():
    """C > 32: the channel GEMM accumulates in f32 and rounds once; tolerance: one bf16
    ulp (2^-7 relative at most) for a different f32 summation order."""
    x, w = _bf16((2, 64, 2, 4, 4), 9), _bf16((1, 1, 1, 64, 40), 10, scale=0.3)
    ours = ops._conv3d_1x1(_port(x), _port(w))
    ref = np.asarray(jops._conv3d_shifted_gemm(jnp.asarray(x, jnp.float32),
                                               jnp.asarray(w, jnp.float32)))
    ref = ref.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)


def test_upscale_conv_bf16_one_rounding():
    """Polyphase library convs against the reference's one lhs-dilated conv: the same
    bf16 phase kernels (tap sums rounded in the same order), f32 accumulation in another
    order, one rounding.  Measured: 1 of 3072 outputs 1 ulp apart (a value near 0 after
    cancellation); tolerance 1 ulp at the top of a binade (2^-7) plus 1e-4 absolute."""
    x, w = _bf16((2, 8, 2, 4, 4), 11), _bf16((3, 3, 3, 8, 6), 12, scale=0.3)
    ours = ops.upscale_conv(_port(x), _port(w))
    ref = np.asarray(jops.upscale_conv(jnp.asarray(x), jnp.asarray(w)))
    assert ours.dtype == torch.bfloat16 and ref.dtype == ml_dtypes.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref.astype(np.float32), rtol=2 ** -7,
                               atol=1e-4)


def test_fused_oracle_bf16_bit_equal():
    """The gradient oracle of the fused op is the reference's unfused math."""
    x = _bf16((4, 16, 4, 16, 16), 13, scale=3.0)
    b = np.random.default_rng(14).normal(size=(16,)).astype(np.float32)
    _assert_bit_equal(fba._oracle(_port(x), torch.from_numpy(b), 0.2, True),
                      _reference_forward(jnp.asarray(x), jnp.asarray(b), 0.2, True))
