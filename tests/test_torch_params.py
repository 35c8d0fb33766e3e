"""Parameters of the PyTorch port against the JAX package: conversion, init names,
shapes and distributions, and npz checkpoints that load in either package."""

import jax
import numpy as np
import pytest
import torch

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.core import filter_params as jax_filter_params
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.train import checkpoint as jax_ckpt
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import params_from_numpy, params_to_numpy
from saragan_tpu_torch.core import filter_params, param_count
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

TINY = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 8, 32, 32)",
            latent_dim=16, filter_spec=[[16, 16], [16, 8], [8, 8]])
BENCH = dict(architecture="pgan", start_shape="(1, 1, 4, 4)",
             final_shape="(1, 128, 512, 512)", latent_dim=256, network_size="xs")


def _jax_g_params(kw, phase, seed=0):
    params = jax_arch("pgan").init(jax.random.PRNGKey(seed), phase=phase,
                                   cfg=JaxConfig(**kw).finalize())
    return {k: np.asarray(v) for k, v in jax_filter_params(params, "generator").items()}


def _port_g_params(kw, phase, seed=0):
    params = get_architecture("pgan").init(torch.Generator().manual_seed(seed), phase=phase,
                                           cfg=Config(**kw).finalize(), device="cpu")
    return filter_params(params, "generator")


def test_numpy_round_trip_is_bit_exact():
    ref = _jax_g_params(TINY, 3)
    back = params_to_numpy(params_from_numpy(ref, "cpu"))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("kw,phase,count", [(TINY, 3, None), (BENCH, 6, 3_701_138)],
                         ids=["tiny_phase3", "bench_phase6"])
def test_init_names_and_shapes_match_reference(kw, phase, count):
    ref = _jax_g_params(kw, phase)
    port = _port_g_params(kw, phase)
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in port.values())
    if count is not None:
        assert param_count(port) == count


def test_init_distribution_matches_reference():
    """Weights N(0, 1/lrmul) with lrmul 1 (runtime He scaling), biases zero."""
    port = _port_g_params(BENCH, 6)
    weights = torch.cat([v.flatten() for k, v in port.items() if k.endswith("/weight")])
    assert weights.numel() > 3_000_000
    assert abs(weights.mean().item()) < 0.01
    assert abs(weights.std().item() - 1.0) < 0.01
    assert all(torch.all(v == 0) for k, v in port.items() if k.endswith("/bias"))


def test_init_is_per_name_and_phase_independent():
    """A layer gets the same values whichever phase it first appears in, and another
    seed gives other values."""
    p2, p3 = _port_g_params(TINY, 2), _port_g_params(TINY, 3)
    shared = set(p2) & set(p3)
    assert shared and len(p3) > len(p2)
    for k in shared:
        torch.testing.assert_close(p2[k], p3[k], rtol=0, atol=0)
    other = _port_g_params(TINY, 3, seed=1)
    assert not torch.equal(other["generator/generator_in/dense/weight"],
                           p3["generator/generator_in/dense/weight"])


def test_npz_cross_loads_both_ways(tmp_path):
    ref = _jax_g_params(TINY, 3)
    jax_path = jax_ckpt.save_params(str(tmp_path / "jax_model"), ref, ema=ref, meta={"phase": 3})
    params, ema, meta = ckpt.load_params(jax_path, device="cpu")
    assert meta == {"phase": 3.0}
    for k, v in ref.items():
        np.testing.assert_array_equal(params[k].numpy(), v)
        np.testing.assert_array_equal(ema[k].numpy(), v)

    port = _port_g_params(TINY, 3, seed=5)
    port_path = ckpt.save_params(str(tmp_path / "port_model"), port, meta={"step": 7})
    jparams, jema, jmeta = jax_ckpt.load_params(port_path)
    assert jema is None and jmeta == {"step": 7.0}
    for k, v in port.items():
        np.testing.assert_array_equal(jparams[k], v.numpy())

    # name-intersection restore: a phase-2 checkpoint seeds the shared names of phase 3
    p2 = _port_g_params(TINY, 2, seed=9)
    restored = ckpt.restore_into(port, p2)
    for k in port:
        torch.testing.assert_close(restored[k], p2[k] if k in p2 else port[k], rtol=0, atol=0)
    with pytest.raises(KeyError):
        ckpt.restore_into(port, p2, strict=True)
