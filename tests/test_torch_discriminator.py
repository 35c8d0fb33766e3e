"""The pgan discriminator of the port against the JAX package's, on the same parameters
and inputs, and the full G+D init against ``arch.init``'s names and shapes.

f32: rtol 1e-4 / atol 1e-5 (convs summed in other orders).  bf16: the scores agree to
2e-2 * max|score| (each layer rounds its output to bf16; the frameworks' convs and
matmuls sum in other orders, so single ulps differ and propagate through up to 9
layers).  The JAX package's Pallas engine cannot run bf16 on the CPU (XLA's CPU dot has
no bf16 x bf16 -> f32), so in bf16 the port's flat engine is held to the reference's
direct engine, which computes the same function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jax_ops_core
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.core import filter_params as jax_filter_params
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import params_from_numpy
from saragan_tpu_torch.core import filter_params
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
CFG = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 8, 32, 32)",
           latent_dim=16, filter_spec=[[16, 16], [16, 8], [8, 8]])
BENCH = dict(architecture="pgan", start_shape="(1, 1, 4, 4)",
             final_shape="(1, 128, 512, 512)", latent_dim=256, network_size="xs")


@pytest.fixture(scope="module")
def d_params():
    out = {}
    for phase in (2, 3):
        params = jax_arch("pgan").init(jax.random.PRNGKey(phase), phase=phase,
                                       cfg=JaxConfig(**CFG).finalize())
        out[phase] = {k: np.asarray(v)
                      for k, v in jax_filter_params(params, "discriminator").items()}
    return out


def _images(phase, seed=1):
    shape = JaxConfig(**CFG).finalize().current_shape(phase, 2)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("phase", [2, 3])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("engine,jax_engine", [("direct", "direct"), ("flat", "pallas")])
def test_discriminator_matches_jax_f32(d_params, monkeypatch, engine, jax_engine, alpha, phase):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", jax_engine)
    x = _images(phase)
    ref = np.asarray(jax_arch("pgan").discriminator(d_params[phase], jnp.asarray(x), alpha,
                                                    phase=phase, cfg=JaxConfig(**CFG).finalize()))
    calls = cf.conv3d_flat_plain.calls
    ours = get_architecture("pgan").discriminator(
        params_from_numpy(d_params[phase], "cpu"), torch.from_numpy(x), alpha, phase=phase,
        cfg=Config(**CFG).finalize(), conv_engine=engine)
    assert ours.shape == ref.shape == (2, 1)
    np.testing.assert_allclose(ours.numpy(), ref, **F32)
    # flat: every conv that is not 1x1x1 (two per block, one in discriminator_out)
    assert cf.conv3d_flat_plain.calls - calls == (2 * (phase - 1) + 1 if engine == "flat" else 0)


@pytest.mark.parametrize("phase", [2, 3])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("engine", ["direct", "flat"])
def test_discriminator_matches_jax_bf16(d_params, monkeypatch, engine, alpha, phase):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "direct")
    x = _images(phase, seed=2)
    ref = np.asarray(jax_arch("pgan").discriminator(
        d_params[phase], jnp.asarray(x, jnp.bfloat16), alpha, phase=phase,
        cfg=JaxConfig(**CFG).finalize()), np.float32)
    ours = get_architecture("pgan").discriminator(
        params_from_numpy(d_params[phase], "cpu"), torch.from_numpy(x).bfloat16(), alpha,
        phase=phase, cfg=Config(**CFG).finalize(), conv_engine=engine)
    assert ours.dtype == torch.bfloat16
    assert np.abs(ours.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("kw,phase", [(CFG, 2), (CFG, 3), (BENCH, 6)],
                         ids=["tiny_phase2", "tiny_phase3", "bench_phase6"])
def test_full_init_names_and_shapes_match_reference(kw, phase):
    ref = jax.eval_shape(lambda k: jax_arch("pgan").init(k, phase=phase,
                                                         cfg=JaxConfig(**kw).finalize()),
                         jax.random.PRNGKey(0))
    port = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=phase,
                                         cfg=Config(**kw).finalize(), device="meta")
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in ref.items()}
    assert filter_params(port, "discriminator") and filter_params(port, "generator")


def test_spectral_norm_raises():
    """Spectral norm raised until it was ported; now the init under ``use_spectral_norm``
    has the reference's names and shapes, each D weight with its ``<weight>_u`` vector
    (the forward against the reference: tests/test_torch_step_options.py)."""
    kw = dict(CFG, use_spectral_norm=True)
    ref = jax.eval_shape(lambda k: jax_arch("pgan").init(k, phase=2,
                                                         cfg=JaxConfig(**kw).finalize()),
                         jax.random.PRNGKey(0))
    port = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=2,
                                         cfg=Config(**kw).finalize(), device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in ref.items()}
    us = [k for k in port if k.endswith("_u")]
    assert us and all(k.startswith("discriminator/") and k[:-2] in port for k in us)
