"""Kernel #3 of the port, the pipelined conv3d forward: its plain version (what the
dispatcher runs on a CPU tensor) against the JAX package's ``conv3d_flat_v2`` as the JAX
package's own test runs it (interpret mode on the CPU) and against its lax conv.

Tolerances: f32 max|ours - ref| <= 1e-5 * max|ref| (up to 27 * C products summed in other
orders); bf16 max|ours - ref| <= 1e-2 * max|ref| (both accumulate in f32 and round once,
so they differ by at most an ulp)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from saragan_tpu.ops.core import _conv_direct
from saragan_tpu.ops.pallas_conv import conv3d_flat_v2 as jax_conv3d_flat_v2
from saragan_tpu_torch.ops import conv3d_flat as cf

torch.set_num_threads(1)


def _xw(kernel, c, f=5, spatial=(3, 4, 6), n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, *spatial)).astype(np.float32)
    w = (rng.normal(size=(*kernel, c, f)) / np.sqrt(c * np.prod(kernel))).astype(np.float32)
    return x, w


def _max_rel(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / np.abs(ref).max()


# C <= 32 contracts one im2col operand, C = 64 per tap
@pytest.mark.parametrize("c", [8, 16, 32, 64], ids=["c8", "c16", "c32", "c64_per_tap"])
@pytest.mark.parametrize("kernel", [(3, 3, 3), (1, 3, 3)])
def test_plain_matches_jax_v2_and_direct_f32(c, kernel):
    x, w = _xw(kernel, c)
    calls = cf.conv3d_flat_v2_plain.calls
    ours = cf.conv3d_flat_v2(torch.from_numpy(x), torch.from_numpy(w))
    assert cf.conv3d_flat_v2_plain.calls == calls + 1
    assert ours.dtype == torch.float32 and ours.shape == (2, 5, 3, 4, 6)
    ref = np.asarray(jax_conv3d_flat_v2(jnp.asarray(x), jnp.asarray(w)))
    assert _max_rel(ours.numpy(), ref) <= 1e-5
    direct = np.asarray(_conv_direct(jnp.asarray(x), jnp.asarray(w)))
    assert _max_rel(ours.numpy(), direct) <= 1e-5


@pytest.mark.parametrize("c", [16, 64], ids=["c16", "c64_per_tap"])
def test_plain_matches_jax_v2_bf16(c):
    x, w = _xw((3, 3, 3), c, seed=1)
    xb, wb = x.astype(ml_dtypes.bfloat16), w.astype(ml_dtypes.bfloat16)
    ours = cf.conv3d_flat_v2(torch.from_numpy(xb.astype(np.float32)).bfloat16(),
                             torch.from_numpy(wb.astype(np.float32)).bfloat16())
    assert ours.dtype == torch.bfloat16
    ref = jax_conv3d_flat_v2(jnp.asarray(xb), jnp.asarray(wb))
    assert ref.dtype == jnp.bfloat16
    assert _max_rel(ours.float().numpy(), np.asarray(ref, np.float32)) <= 1e-2


def test_plain_equals_v1_plain_in_f64():
    """The im2col contraction and the per-tap one are the same function."""
    x, w = (torch.from_numpy(a).double() for a in _xw((3, 3, 3), 12, seed=2))
    torch.testing.assert_close(cf.conv3d_flat_v2_plain(x, w), cf.conv3d_flat_plain(x, w),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kernel", [(2, 3, 3), (3, 3, 4)])
def test_even_kernel_raises(kernel):
    x, w = _xw(kernel, 4)
    with pytest.raises(ValueError, match="odd"):
        cf.conv3d_flat_v2(torch.from_numpy(x), torch.from_numpy(w))


def test_cpu_dispatch_never_launches_the_kernel():
    x, w = (torch.from_numpy(a) for a in _xw((3, 3, 3), 4))
    launches = cf.conv3d_flat_v2_cuda.launches
    cf.conv3d_flat_v2(x, w)
    assert cf.conv3d_flat_v2_cuda.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        cf.conv3d_flat_v2_cuda(x, w)
