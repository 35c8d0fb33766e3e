"""The style families' ops and the plain ops the port adds for them, against the JAX
package on the CPU: instance norm, AdaIN style_mod, noise, minibatch stddev (with the
stacked passes' groups), conv_downscale, group and depthwise convs, the mapping network,
the modulated conv, style mixing and truncation, ``refresh_state`` on the same 64
latents, surfgan's projection conditioning, the noise sources' seeding, and the serving
and trainer entry points with a style family.  f32 to rtol 1e-5 (of max|ref| where the
op sums), bf16 to the rounding the op makes (stated per test)."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jax_ops
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.core import Scope as JaxScope
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.models import style_ops as jax_style_ops
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import params_from_numpy
from saragan_tpu_torch.core import Scope
from saragan_tpu_torch.models import get_architecture, style_ops
from saragan_tpu_torch.ops import core as ops
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch import losses
from saragan_tpu_torch.convert import train_state_to_numpy
from saragan_tpu_torch.train import checkpoint as ckpt
from test_torch_families import (N, _tree, assert_step_close, jax_style_draws,
                                 run_one_step, step_draws)

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def jax_direct_engine(monkeypatch):
    monkeypatch.setattr(jax_ops, "CONV3D_ALGORITHM", "direct")


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def np32(t):
    return t.detach().float().numpy()


def normal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def small_cfg(arch, phase=2, **kw):
    args = dict(architecture=arch, start_shape="(1, 4, 4, 4)", final_shape="(1, 32, 32, 32)",
                starting_phase=phase, ending_phase=phase, latent_dim=16, network_size="xxs",
                kernel_spec=[[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
                filter_spec=[[8, 8], [8, 8], [4, 4]], loss_fn="wgan")
    args.update(kw)
    return JaxConfig(**args).finalize(), Config(**args).finalize()


# ---------------------------------------------------------------------------
# Plain ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    """In x's dtype, means accumulated in f32: bf16 bit-equal but for one ulp."""
    x = jnp.asarray(normal(0, (2, 3, 4, 6, 5)) * 3 + 1, dtype)
    ref = np.asarray(jax_ops.instance_norm(x), np.float32)
    ours = ops.instance_norm(to_torch(x))
    assert ours.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(np32(ours), ref, **F32)
    else:
        np.testing.assert_allclose(np32(ours), ref, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("n", [4, 8, 6, 2])
def test_minibatch_stddev_layer_matches_jax(n, passes):
    """Groups strided across each pass, as the reference's reshape (G, N/G) and its vmap
    over stacked passes; f32 statistics."""
    x = normal(1, (n * passes, 5, 2, 3, 4))
    if n % min(4, n):
        with pytest.raises(ValueError, match="group"):
            ops.minibatch_stddev_layer(torch.from_numpy(x), passes=passes)
        return
    stacked = jnp.asarray(x).reshape((passes, n) + x.shape[1:])
    ref = np.asarray(jax.vmap(jax_ops.minibatch_stddev_layer)(stacked)).reshape(
        (n * passes, 6) + x.shape[2:])
    ours = ops.minibatch_stddev_layer(torch.from_numpy(x), passes=passes)
    np.testing.assert_allclose(ours.numpy(), ref, **F32)


def test_minibatch_stddev_layer_bf16_statistics_in_f32():
    x = jnp.asarray(normal(2, (8, 4, 2, 4, 4)), jnp.bfloat16)
    ref = np.asarray(jax_ops.minibatch_stddev_layer(x), np.float32)
    ours = ops.minibatch_stddev_layer(to_torch(x))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(ours), ref)  # f32 math, one rounding at the end


@pytest.mark.parametrize("kernel", [(3, 3, 3), (1, 3, 3), (1, 1, 1)])
def test_conv_downscale_matches_jax_and_pool_of_conv(kernel):
    x = normal(3, (2, 3, 4, 6, 8))
    w = normal(4, (*kernel, 3, 5))
    ref = np.asarray(jax_ops.conv_downscale(jnp.asarray(x), jnp.asarray(w)))
    ours = ops.conv_downscale(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    pooled = ops.downscale(ops.conv_apply(torch.from_numpy(x), torch.from_numpy(w)))
    np.testing.assert_allclose(ours.numpy(), pooled.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_conv_matches_jax(groups):
    x = normal(5, (2, 8, 3, 5, 4))
    w = normal(6, (3, 3, 3, 8 // groups, 12))
    ref = np.asarray(jax_ops.group_conv(jnp.asarray(x), jnp.asarray(w), groups))
    ours = ops.group_conv(torch.from_numpy(x), torch.from_numpy(w), groups)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_depthwise_conv_matches_jax():
    x = normal(7, (2, 6, 3, 5, 4))
    w = normal(8, (1, 3, 3, 1, 6))
    ref = np.asarray(jax_ops.depthwise_conv(jnp.asarray(x), jnp.asarray(w)))
    ours = ops.depthwise_conv(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def _both_scopes(seed=9):
    """A JAX init scope and the port's scope over the parameters it creates."""
    jparams = {}
    return JaxScope(jparams, init=True, rng=jax.random.PRNGKey(seed)), jparams


def test_style_mod_and_apply_noise_match_jax():
    x = normal(10, (2, 4, 3, 4, 5))
    dlat = normal(11, (2, 16))
    js, jp = _both_scopes()
    # a non-zero strength: the init's is 0
    jp["layer/noise_strength"] = jnp.asarray(0.3)
    key = jax.random.PRNGKey(3)
    ref_noise = jax.random.normal(key, (2, 1, 3, 4, 5))
    ref = jax_ops.style_mod(js.sub("layer"), jax_ops.apply_noise(js.sub("layer"), jnp.asarray(x),
                                                                  key),
                            jnp.asarray(dlat), "leaky_relu", 0.2)
    params = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    s = Scope(params).sub("layer")
    src = ops.NoiseByName({"layer/noise": to_torch(ref_noise)})
    ours = ops.style_mod(s, ops.apply_noise(s, torch.from_numpy(x), src, "layer/noise"),
                         torch.from_numpy(dlat), "leaky_relu", 0.2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32)


# ---------------------------------------------------------------------------
# Noise sources
# ---------------------------------------------------------------------------


def test_layer_noise_is_seeded_by_name_and_row():
    src = ops.LayerNoise(7)
    a = src("g/conv/noise", (3, 1, 2, 2, 2), torch.float32, "cpu")
    assert torch.equal(a, src("g/conv/noise", (3, 1, 2, 2, 2), torch.float32, "cpu"))
    assert not torch.equal(a, src("g/conv_1/noise", (3, 1, 2, 2, 2), torch.float32, "cpu"))
    rows = ops.LayerNoise([11, 12, 13])("n", (3, 1, 4), torch.float32, "cpu")
    for j, seed in enumerate((11, 12, 13)):  # a row alone equals its slot in the batch
        assert torch.equal(rows[j:j + 1], ops.LayerNoise(seed)("n", (1, 1, 4), torch.float32,
                                                               "cpu"))
    assert [p.seeds for p in ops.LayerNoise([1, 2, 3, 4]).chunk(2)] == [(1, 2), (3, 4)]
    parts = ops.LayerNoise(5).chunk(2)
    assert len({p.seeds for p in parts}) == 2
    with pytest.raises(ValueError, match="seeds"):
        ops.LayerNoise([1, 2])("n", (3, 1, 4), torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    first = ops.generator_seed(g)
    torch.randn(3, generator=g)
    assert ops.generator_seed(g) != first and ops.generator_seed(None) == 0


# ---------------------------------------------------------------------------
# Mapping, modulated conv, mixing, truncation, refresh_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["stylegan", "stylegan2"])
def test_g_mapping_matches_jax(kind, dtype):
    kw = (dict(mapping_fmaps=32, last_layer_latent=True, bias_lrmul=0.01)
          if kind == "stylegan2" else {})
    js, jp = _both_scopes()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    z = jnp.asarray(normal(13, (3, 16)), jdt)
    jax_style_ops.g_mapping(js, jnp.zeros((1, 16)), 5, **kw)  # creates the parameters
    ref = np.asarray(jax_style_ops.g_mapping(JaxScope(jp), z, 5, **kw), np.float32)
    ours = style_ops.g_mapping(Scope(params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                                       "cpu")), to_torch(z), 5, **kw)
    assert ours.shape == (3, 5, 16)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np32(ours), ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("up,fused", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv_matches_jax(demodulate, up, fused):
    x = normal(14, (2, 4, 2, 4, 4))
    z = normal(15, (2, 16))
    js, jp = _both_scopes()
    kernel = (1, 3, 3)
    args = dict(up=up, demodulate=demodulate, param=0.2, fused_transitions=fused)
    jax_style_ops.modulated_conv(js, jnp.asarray(x), jnp.asarray(z), 6, kernel, "leaky_relu",
                                 **args)
    ref = jax_style_ops.modulated_conv(JaxScope(jp), jnp.asarray(x), jnp.asarray(z), 6, kernel,
                                       "leaky_relu", **args)
    params = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for engine in ("direct", "flat"):
        calls = cf.conv3d_flat_plain.calls
        ours = style_ops.modulated_conv(Scope(params), torch.from_numpy(x), torch.from_numpy(z),
                                        6, kernel, "leaky_relu", engine=engine, **args)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        # the plain conv of a 3x3 modulated conv is kernel #1's under flat (not when the
        # upscale is fused into the polyphase transition)
        expect = 1 if engine == "flat" and not (up and fused) else 0
        assert cf.conv3d_flat_plain.calls - calls == expect


@pytest.mark.parametrize("coin,cutoff", [(0.2, 1), (0.2, 3), (0.95, 2)])
def test_style_mixing_and_truncation_match_jax(coin, cutoff):
    """The coin picks the drawn cutoff below the probability, else the no-mix cutoff."""
    d_z = normal(16, (2, 6, 16))
    d_reg = normal(17, (2, 6, 16))
    expect_cut = cutoff if coin < 0.9 else 4
    ref = np.where(np.arange(6)[None, :, None] < expect_cut, d_z, d_reg)
    mix = style_ops.StyleMix(torch.zeros(2, 16), torch.tensor(coin), torch.tensor(cutoff))
    ours = style_ops.style_mixing(torch.from_numpy(d_z), torch.from_numpy(d_reg), mix, 6, 0.9,
                                  no_mix_cutoff=4)
    np.testing.assert_array_equal(ours.numpy(), ref)
    avg = normal(18, (16,))
    tref = jax_style_ops.apply_truncation(jnp.asarray(d_z), jnp.asarray(avg), 6, 0.7, 4)
    tours = style_ops.apply_truncation(torch.from_numpy(d_z), torch.from_numpy(avg), 6, 0.7, 4)
    np.testing.assert_allclose(tours.numpy(), np.asarray(tref), **F32)


@pytest.mark.parametrize("arch", ["stylegan", "stylegan2", "surfgan"])
def test_refresh_state_matches_jax(arch):
    """The w-average after one refresh from the reference's 64 latents."""
    phase = 1 if arch == "stylegan2" else 2
    jcfg, cfg = small_cfg(arch, phase)
    params = jax_arch(arch).init(jax.random.PRNGKey(0), phase=phase, cfg=jcfg)
    g = {k: v for k, v in params.items() if k.startswith("generator/")}
    g = {**g, "generator/d_z_avg": jnp.asarray(normal(19, (16,)))}
    key = jax.random.PRNGKey(4)
    ref = jax_arch(arch).refresh_state(g, key, phase=phase, cfg=jcfg)
    z = to_torch(jax.random.normal(key, (64, 16)))
    ours = get_architecture(arch).refresh_state(
        params_from_numpy({k: np.asarray(v) for k, v in g.items()}, "cpu"), z, phase=phase,
        cfg=cfg)
    np.testing.assert_allclose(ours["generator/d_z_avg"].numpy(),
                               np.asarray(ref["generator/d_z_avg"]), rtol=1e-5, atol=1e-7)
    for k in g:
        if k != "generator/d_z_avg":
            assert torch.equal(ours[k], torch.from_numpy(np.array(g[k])))


def test_surfgan_conditioning_matches_jax():
    """Projection conditioning at model level (the trainer does not wire it, nor does the
    reference's): the conditioning weight, G and D with labels."""
    jcfg, cfg = small_cfg("surfgan", num_labels=3)
    params = jax_arch("surfgan").init(jax.random.PRNGKey(0), phase=2, cfg=jcfg)
    ours_init = get_architecture("surfgan").init(torch.Generator().manual_seed(0), phase=2,
                                                 cfg=cfg, device="cpu")
    assert ours_init["generator/g_mapping/conditioning/weight"].shape == (3, 16)
    assert ours_init["generator/d_z_avg"].shape == (32,)
    p_np = {k: np.asarray(v) for k, v in params.items()}
    z = normal(20, (2, 16))
    cond = np.eye(3, dtype=np.float32)[[0, 2]]
    ref = np.asarray(jax_arch("surfgan").generator(params, z, 0.5, phase=2, cfg=jcfg,
                                                   conditioning=cond, train=False))
    arch = get_architecture("surfgan")
    ours = arch.generator(params_from_numpy(p_np, "cpu"), torch.from_numpy(z), 0.5, phase=2,
                          cfg=cfg, conditioning=torch.from_numpy(cond), train=False)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    dref = np.asarray(jax_arch("surfgan").discriminator(params, ref, 0.5, phase=2, cfg=jcfg,
                                                        conditioning=cond))
    dours = arch.discriminator(params_from_numpy(p_np, "cpu"), torch.from_numpy(np.array(ref)),
                               0.5, phase=2, cfg=cfg, conditioning=torch.from_numpy(cond))
    np.testing.assert_allclose(dours.numpy(), dref, rtol=1e-5, atol=1e-5 * np.abs(dref).max())


def test_stylegan2_refuses_progressive_growing():
    """The reference asserts it (``saragan_tpu/config.py:419-424``); the port raises."""
    _, cfg = small_cfg("stylegan2", 1)
    with pytest.raises(ValueError, match="progressive growing"):
        dataclasses.replace(cfg, ending_phase=2).finalize()


# ---------------------------------------------------------------------------
# Entry points with a style family
# ---------------------------------------------------------------------------


def test_keyed_sampler_style_family_row_independent(tmp_path):
    """surfgan served from a checkpoint the JAX package wrote: the named architecture is
    served (the config's own says pgan), noise on, a sample alone bit-equal to its slot
    in a coalesced batch; truncation_psi is not a serving option, so no truncation."""
    from saragan_tpu.train import checkpoint as jax_ckpt
    from saragan_tpu_torch.tools.serve import GeneratorService

    jcfg, cfg = small_cfg("surfgan")
    params = jax_arch("surfgan").init(jax.random.PRNGKey(0), phase=2, cfg=jcfg)
    path = str(tmp_path / "model_2")
    jax_ckpt.save_params(path, params, ema=params)
    svc = GeneratorService.from_checkpoint("surfgan", path + ".npz",
                                           cfg=dataclasses.replace(cfg, architecture="pgan"),
                                           phase=2, batch_size=4, device="cpu")
    assert svc.info["architecture"] == "surfgan"
    batch = svc.generate(4, seed=3)
    alone = svc.generate(1, seed=3)
    assert batch.shape == (4, 1, 8, 8, 8) and np.isfinite(batch).all()
    np.testing.assert_array_equal(alone[0], batch[0])
    loaded, _, _ = ckpt.load_params(path + ".npz", "cpu")
    assert "generator/d_z_avg" in loaded


# ---------------------------------------------------------------------------
# surfgan's step under the other step options
# ---------------------------------------------------------------------------


def _alternate_draws(cfg, key, dtype, shape):
    """The reference's alternate step: the key split in two, the discriminator's half into
    forward_discriminator's 5, the generator's into forward_generator's 3; refresh_state
    folds the step key in 7."""
    rng_d, rng_g = jax.random.split(key)
    d = step_draws("surfgan", cfg, 2, rng_d, N, dtype, shape)
    k_z, k_g, _ = jax.random.split(rng_g, 3)
    noise, mix = jax_style_draws("surfgan", cfg, 2, k_g, N, dtype)
    g = losses.Draws(to_torch(jax.random.normal(k_z, (N, cfg.latent_dim), dtype)),
                     z_mix=mix.z, mix_coin=mix.coin, mix_cutoff=mix.cutoff, noise=noise,
                     refresh_z=to_torch(jax.random.normal(jax.random.fold_in(key, 7), (64, 16))))
    return [d], [g]


def _accumulation_draws(cfg, key, dtype, shape):
    """grad_accumulate splits the step key per micro-batch (of N, the step's batch being
    2 N); refresh_state folds the step key in 7."""
    keys = jax.random.split(key, 2)
    parts = [step_draws("surfgan", cfg, 2, k, N, dtype, shape) for k in keys]
    refresh = to_torch(jax.random.normal(jax.random.fold_in(key, 7), (64, 16)))
    return [parts[0]._replace(refresh_z=refresh), parts[1]._replace(refresh_z=None)]


@pytest.mark.parametrize("option,draws_of,n", [
    (dict(gp_grad_mode="revfwd"), None, N),
    (dict(optim_strategy="alternate"), _alternate_draws, N),
    (dict(gradient_accumulation=2), _accumulation_draws, 2 * N),
    (dict(use_spectral_norm=True), None, N),
    (dict(fused_grads=False), None, N),
    (dict(loss_fn="logistic"), None, N)],
    ids=["revfwd", "alternate", "accumulation2", "spectral", "unfused", "logistic"])
def test_surfgan_step_options_match_jax(option, draws_of, n):
    """surfgan (the family whose D mixes samples) one step under each step option the
    reference allows it, from one converted state and the reference's draws: losses rtol
    1e-4 and the step's gradients and parameters as ``assert_step_close`` holds them.
    Under accumulation the step's batch is 8, so each micro-batch of 4 forms one
    minibatch-stddev group of 4, as the other cases do."""
    jstate, jm, _, tnew, m = run_one_step("surfgan", draws_of=draws_of, n=n, **option)
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        np.testing.assert_allclose(np32(getattr(m, name)), np.asarray(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    ours, ref = train_state_to_numpy(tnew), _tree(jstate)
    assert_step_close(ours, ref, "surfgan")
    np.testing.assert_allclose(ours["g_params"]["generator/d_z_avg"],
                               ref["g_params"]["generator/d_z_avg"], rtol=1e-4, atol=1e-7)
