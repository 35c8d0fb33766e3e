"""Kernel #5 of the port, the minibatch standard-deviation statistic: its plain version
(what the dispatcher runs on a CPU tensor) against the JAX package's
``minibatch_stddev_stat`` in interpret mode, as the JAX package's own test runs it, and
against the channel the reference's ``minibatch_stddev_layer`` appends.

Tolerance: rtol 1e-6 in f32 (one mean over a few hundred features, summed in another
order); bf16 inputs are widened to f32 exactly by both, so the same."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from saragan_tpu.ops.core import minibatch_stddev_layer
from saragan_tpu.ops.pallas_kernels import minibatch_stddev_stat as jax_mbstd
from saragan_tpu_torch.ops import minibatch_stddev as mb

torch.set_num_threads(1)


def _x(n, seed=0, shape=(3, 2, 4, 4)):
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_plain_matches_jax_kernel(n, dtype):
    x = _x(n, seed=n)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.astype(np.float32)).bfloat16()
    else:
        xt = torch.from_numpy(x)
    calls = mb.minibatch_stddev_stat_plain.calls
    ours = mb.minibatch_stddev_stat(xt, group_size=4)
    assert mb.minibatch_stddev_stat_plain.calls == calls + 1
    assert ours.shape == (n // 4, 1) and ours.dtype == torch.float32
    ref = np.asarray(jax_mbstd(jnp.asarray(x), group_size=4))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("n", [2, 8])
def test_equals_the_appended_channel_of_the_reference_layer(n):
    """Group m holds the interleaved samples m, m + groups, ...; the layer tiles the
    group's value over its samples (before its cast back to x's dtype, f32 here)."""
    x = _x(n, seed=3)
    stat = mb.minibatch_stddev_stat(torch.from_numpy(x), group_size=4).numpy()
    layer = np.asarray(minibatch_stddev_layer(jnp.asarray(x), group_size=4))
    groups = n // min(4, n)
    for i in range(n):
        np.testing.assert_allclose(layer[i, 3], np.full(layer.shape[2:], stat[i % groups, 0]),
                                   rtol=1e-6)


def test_bad_group_and_cpu_dispatch():
    with pytest.raises(ValueError, match="group size"):
        mb.minibatch_stddev_stat(torch.zeros(6, 2), group_size=4)
    launches = mb.minibatch_stddev_stat_triton.launches
    mb.minibatch_stddev_stat(torch.zeros(4, 2))
    assert mb.minibatch_stddev_stat_triton.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        mb.minibatch_stddev_stat_triton(torch.zeros(4, 2))
