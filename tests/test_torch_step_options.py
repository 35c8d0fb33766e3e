"""The train-step options of this slice against the JAX package: gradient accumulation
(``optim/accumulate.py``), spectral norm of the discriminator (its forward, the per-step
u refresh, a step, Adam on the u vectors, the npz round trip), the ``revfwd`` penalty
gradient and the ``alternate`` strategy.

Inputs come from numpy and both steps start from one converted state, fed the
reference's own draws.  Tolerances are those of ``tests/test_torch_train_step.py``: f32
losses rtol 1e-4, gradients rtol 1e-3 / atol 1e-3 * max|g|, parameters rtol 1e-3
(Adam's first step moves each by about lr * sign(g)); the power iteration's vectors
rtol 1e-5 (a few f32 matrix products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jax_ops_core
from saragan_tpu import losses as jax_losses
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.optim.accumulate import grad_accumulate as jax_grad_accumulate
from saragan_tpu.train import make_train_step as jax_make_train_step
from saragan_tpu_torch import losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import (params_from_numpy, train_state_from_numpy,
                                       train_state_to_numpy)
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import refresh_spectral_u, spectral_normalize
from saragan_tpu_torch.optim.accumulate import grad_accumulate, split_microbatches
from saragan_tpu_torch.optim.factory import make_optimizer, make_optimizers_from_config
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.step import make_train_step, micro_draws
from test_torch_train_step import (CFG, N, PHASE, _assert_grads_close, _jax_state, _leaves,
                                   _loss_fns, _np, _real, _to_torch, _tree, jax_draws)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_direct_engine(monkeypatch):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "direct")


def _configs(**kw):
    kw = {**CFG, **kw}
    return JaxConfig(**kw).finalize(), Config(**kw).finalize()


def jax_g_draws(key, n, latent_dim, dtype):
    """forward_generator's draws: its key split into 3 (z, the generator's, noise)."""
    k_z, _, _ = jax.random.split(key, 3)
    return losses.Draws(_to_torch(jax.random.normal(k_z, (n, latent_dim), dtype)))


def _step_both(jcfg, cfg, draws_of, steps=1, alpha=0.5):
    """`steps` steps of the reference and the port from one converted state; the port's
    draws are ``draws_of(key)`` of the reference's step key."""
    state, (jgo, jdo) = _jax_state(jcfg)
    jstep = jax.jit(jax_make_train_step(jax_arch("pgan"), jcfg, PHASE, jgo, jdo))
    tstate = train_state_from_numpy(_tree(state), "cpu")
    go, do = make_optimizers_from_config(cfg)
    step = make_train_step(get_architecture("pgan"), cfg, PHASE, go, do, conv_engine="flat")
    history = []
    for i in range(steps):
        real, key = _real(cfg, seed=30 + i), jax.random.PRNGKey(40 + i)
        state, jm = jstep(state, jnp.asarray(real), key, alpha, 1e-3, 1e-3)
        tstate, m = step(tstate, torch.from_numpy(real), None, alpha, 1e-3, 1e-3,
                         draws=draws_of(key))
        history.append((jm, m, state, tstate))
    return state, tstate, history


def _assert_step_close(jstate, tstate, history):
    for jm, m, *_ in history:
        for name in ("gen_loss", "disc_loss", "gp_loss", "fake_min", "fake_max"):
            np.testing.assert_allclose(_np(getattr(m, name)), np.asarray(getattr(jm, name)),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
    ours, ref = train_state_to_numpy(tstate), _tree(jstate)
    for part in ("g_params", "d_params", "ema"):
        assert ours[part].keys() == ref[part].keys()
        for k, v in ref[part].items():
            np.testing.assert_allclose(ours[part][k], v, rtol=1e-3, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Gradient accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accumulate_matches_reference(k):
    """Gradients and scalars of K micro-batches, summed in f32 in order and divided by K,
    as the reference's scan does."""
    rng = np.random.default_rng(k)
    batch = rng.normal(size=(8, 3, 5)).astype(np.float32)
    weights = rng.normal(size=(5,)).astype(np.float32)

    def jfn(mb, _key):
        return ({"w": jnp.sum(mb * weights, axis=(0, 1)), "s": jnp.sum(mb ** 2)},
                (jnp.mean(mb), jnp.max(mb)))

    def tfn(mb, _draws):
        w = torch.from_numpy(weights)
        return ({"w": torch.sum(mb * w, dim=(0, 1)), "s": torch.sum(mb ** 2)},
                (torch.mean(mb), torch.max(mb)))

    ref = jax_grad_accumulate(jfn, jnp.asarray(batch), jax.random.PRNGKey(0), k)
    ours = grad_accumulate(tfn, torch.from_numpy(batch), [None] * k, k)
    for name in ("w", "s"):
        np.testing.assert_allclose(_np(ours[0][name]), np.asarray(ref[0][name]), rtol=1e-6)
    for a, b in zip(ours[1], ref[1]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
    assert split_microbatches(torch.from_numpy(batch), k).shape == (k, 8 // k, 3, 5)


def test_grad_accumulate_rejects_a_batch_it_does_not_divide():
    from saragan_tpu.optim.accumulate import split_microbatches as jax_split

    with pytest.raises(ValueError) as ref:
        jax_split(jnp.zeros((6, 2)), 4)
    with pytest.raises(ValueError) as ours:
        split_microbatches(torch.zeros(6, 2), 4)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("k", [2, 4])
def test_accumulated_step_matches_reference(k):
    """A step with ``gradient_accumulation`` K against the reference's: micro-batch i
    draws from the i-th of K keys split from the step key, as the reference's scan
    does."""
    jcfg, cfg = _configs(gradient_accumulation=k)
    n = 4

    def draws_of(key):
        return [jax_draws(kk, n // k, cfg.latent_dim, _real(cfg).shape[1:], jnp.float32)
                for kk in jax.random.split(key, k)]

    state, (jgo, jdo) = _jax_state(jcfg)
    jstep = jax.jit(jax_make_train_step(jax_arch("pgan"), jcfg, PHASE, jgo, jdo))
    tstate = train_state_from_numpy(_tree(state), "cpu")
    step = make_train_step(get_architecture("pgan"), cfg, PHASE,
                           *make_optimizers_from_config(cfg), conv_engine="flat")
    real = np.random.default_rng(5).normal(size=cfg.current_shape(PHASE, n)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    state, jm = jstep(state, jnp.asarray(real), key, 0.5, 1e-3, 1e-3)
    tstate, m = step(tstate, torch.from_numpy(real), None, 0.5, 1e-3, 1e-3,
                     draws=draws_of(key))
    _assert_step_close(state, tstate, [(jm, m)])


def test_micro_draws_split_one_batch_along_its_samples():
    z, gamma = torch.arange(8.0).reshape(4, 2), torch.arange(4.0).reshape(4, 1, 1)
    parts = micro_draws(losses.Draws(z, gamma), 2)
    assert [p.z.tolist() for p in parts] == [z[:2].tolist(), z[2:].tolist()]
    assert parts[1].gamma.flatten().tolist() == [2.0, 3.0] and parts[0].noise_real is None
    assert micro_draws([parts[0]], 1) == [parts[0]]


# ---------------------------------------------------------------------------
# Spectral norm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spectral_params():
    """Reference G+D parameters under spectral norm (with its u vectors), numpy."""
    jcfg = JaxConfig(**CFG, use_spectral_norm=True).finalize()
    params = jax_arch("pgan").init(jax.random.PRNGKey(2), phase=PHASE, cfg=jcfg)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_spectral_norm_discriminator_matches_reference(spectral_params, alpha):
    jcfg, cfg = _configs(use_spectral_norm=True)
    x = np.random.default_rng(3).normal(size=cfg.current_shape(PHASE, N)).astype(np.float32)
    ref = np.asarray(jax_arch("pgan").discriminator(spectral_params, jnp.asarray(x), alpha,
                                                    phase=PHASE, cfg=jcfg))
    ours = get_architecture("pgan").discriminator(
        params_from_numpy(spectral_params, "cpu"), torch.from_numpy(x), alpha, phase=PHASE,
        cfg=cfg, conv_engine="flat")
    np.testing.assert_allclose(_np(ours), ref, rtol=1e-4, atol=1e-5)
    plain = get_architecture("pgan").discriminator(
        params_from_numpy(spectral_params, "cpu"), torch.from_numpy(x), alpha, phase=PHASE,
        cfg=Config(**CFG).finalize(), conv_engine="flat")
    assert not torch.allclose(plain, ours)  # the normalization changes the scores


def test_spectral_normalize_and_refresh_match_reference(spectral_params):
    from saragan_tpu.ops.core import refresh_spectral_u as jax_refresh
    from saragan_tpu.ops.core import spectral_normalize as jax_normalize

    w = spectral_params["discriminator/discriminator_block_2/conv_1/weight"]
    u = spectral_params["discriminator/discriminator_block_2/conv_1/weight_u"]
    rw, ru = jax_normalize(jnp.asarray(w), jnp.asarray(u), iterations=3)
    ow, ou = spectral_normalize(torch.tensor(w), torch.tensor(u), iterations=3)
    np.testing.assert_allclose(_np(ow), np.asarray(rw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(ou), np.asarray(ru), rtol=1e-5, atol=1e-7)
    ref = jax_refresh({k: jnp.asarray(v) for k, v in spectral_params.items()}, iterations=2)
    ours = refresh_spectral_u(params_from_numpy(spectral_params, "cpu"), iterations=2)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        tol = dict(rtol=1e-5, atol=1e-7) if k.endswith("_u") else dict(rtol=0, atol=0)
        np.testing.assert_allclose(_np(ours[k]), np.asarray(v), err_msg=k, **tol)


def test_spectral_norm_step_matches_reference():
    jcfg, cfg = _configs(use_spectral_norm=True)
    """Two steps: the second's forward reads the u vectors the first refreshed.  Losses of
    both steps and the state after the first at the stated tolerances; after the second,
    the u vectors (Adam's second move of a few near-zero bias gradients amplifies the
    normalization's rounding past rtol 1e-3, in the parameters only)."""
    jstate, tstate, history = _step_both(
        jcfg, cfg, lambda key: jax_draws(key, N, cfg.latent_dim, _real(cfg).shape[1:],
                                         jnp.float32), steps=2)
    _assert_step_close(history[0][2], history[0][3], history)
    ours, ref = train_state_to_numpy(tstate), _tree(jstate)
    us = [k for k in ref["d_params"] if k.endswith("_u")]
    assert us
    for k in us:
        np.testing.assert_allclose(ours["d_params"][k], ref["d_params"][k], rtol=1e-3,
                                   atol=1e-6, err_msg=k)


def test_spectral_u_is_left_by_adam_and_refreshed_by_the_step(spectral_params, tmp_path):
    """The u vectors get exactly-zero gradients, so Adam leaves them where they are; the
    step then power-iterates them against the updated weights; and they round-trip
    through the npz checkpoint."""
    jcfg, cfg = _configs(use_spectral_norm=True)
    state, _ = _jax_state(jcfg)
    tstate = train_state_from_numpy(_tree(state), "cpu")
    step = make_train_step(get_architecture("pgan"), cfg, PHASE,
                           *make_optimizers_from_config(cfg), conv_engine="flat")
    new, _ = step(tstate, torch.from_numpy(_real(cfg)), torch.Generator().manual_seed(0), 0.5,
                  1e-3, 1e-3)
    us = [k for k in new.d_params if k.endswith("_u")]
    assert us
    for k in us:
        assert torch.equal(new.d_opt.mu[k], torch.zeros_like(new.d_opt.mu[k]))
        assert torch.equal(new.d_opt.nu[k], torch.zeros_like(new.d_opt.nu[k]))
    adam = make_optimizer("Adam", beta1=0.0, beta2=0.9)
    p = {k: tstate.d_params[k] for k in us}
    moved, _ = adam.update({k: torch.zeros_like(v) for k, v in p.items()}, adam.init(p), p, 1e-3)
    assert all(torch.equal(moved[k], p[k]) for k in us)
    weights = {k: new.d_params[k] for k in new.d_params if not k.endswith("_u")}
    refreshed = refresh_spectral_u({**weights, **{k: tstate.d_params[k] for k in us}},
                                   iterations=cfg.spectral_iterations)
    assert all(torch.equal(new.d_params[k], refreshed[k]) for k in us)
    path = ckpt.save_params(str(tmp_path / "model_2"), {**new.g_params, **new.d_params},
                            ema=new.ema)
    params, ema, _ = ckpt.load_params(path, "cpu")
    assert all(torch.equal(params[k], new.d_params[k]) and torch.equal(ema[k], new.ema[k])
               for k in us)


# ---------------------------------------------------------------------------
# revfwd and the alternate strategy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "unbatched"])
def test_revfwd_grads_equal_revrev_and_the_reference(batched):
    jcfg, cfg = _configs(noise_stddev=0.1)
    state, _ = _jax_state(jcfg)
    tree = _tree(state)
    jgen, jdisc, gen, disc = _loss_fns(jcfg, cfg, 0.5)
    real, key = _real(cfg, seed=8), jax.random.PRNGKey(9)
    (jg, jd), jout = jax_losses.grads_simultaneous(
        jgen, jdisc, state.g_params, state.d_params, jnp.asarray(real), key,
        latent_dim=cfg.latent_dim, gp_weight=10.0, noise_stddev=0.1, batched_passes=batched,
        gp_grad_mode="revfwd")
    draws = jax_draws(key, N, cfg.latent_dim, real.shape[1:], jnp.float32, noise_stddev=0.1)
    out = {}
    for mode in ("revfwd", "revrev"):
        out[mode] = losses.grads_simultaneous(
            gen, disc, _leaves(tree["g_params"]), _leaves(tree["d_params"]),
            torch.from_numpy(real), draws, gp_weight=10.0, noise_stddev=0.1,
            batched_passes=batched, gp_grad_mode=mode)
    (g, d), o = out["revfwd"]
    for ours, ref in zip(o[:3], jout[:3]):
        np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-4, atol=1e-6)
    _assert_grads_close(g, jg)
    _assert_grads_close(d, jd)
    (g2, d2), o2 = out["revrev"]
    _assert_grads_close(d, {k: _np(v) for k, v in d2.items()})
    assert all(torch.equal(g[k], g2[k]) for k in g)  # the penalty has no generator path
    torch.testing.assert_close(o.gp_loss, o2.gp_loss, rtol=1e-6, atol=0)


def test_revfwd_step_matches_reference():
    jcfg, cfg = _configs(gp_grad_mode="revfwd")
    jstate, tstate, history = _step_both(
        jcfg, cfg, lambda key: jax_draws(key, N, cfg.latent_dim, _real(cfg).shape[1:],
                                         jnp.float32))
    _assert_step_close(jstate, tstate, history)


@pytest.mark.parametrize("loss_fn", ["wgan", "logistic"])
def test_alternate_step_matches_reference(loss_fn):
    """The D step, then the G step against the updated D, over two steps: the reference
    splits each step key into the D's and the G's, each split again by its loss."""
    jcfg, cfg = _configs(optim_strategy="alternate", loss_fn=loss_fn)

    def draws_of(key):
        k_d, k_g = jax.random.split(key)
        return (jax_draws(k_d, N, cfg.latent_dim, _real(cfg).shape[1:], jnp.float32),
                jax_g_draws(k_g, N, cfg.latent_dim, jnp.float32))

    jstate, tstate, history = _step_both(jcfg, cfg, draws_of, steps=2)
    _assert_step_close(jstate, tstate, history)


def test_forward_discriminator_and_generator_match_reference():
    jcfg, cfg = _configs()
    state, _ = _jax_state(jcfg)
    tree = _tree(state)
    jgen, jdisc, gen, disc = _loss_fns(jcfg, cfg, 0.5)
    real, key = _real(cfg, seed=11), jax.random.PRNGKey(12)

    def jd_loss(dp):
        return jax_losses.forward_discriminator(
            jgen, jdisc, state.g_params, dp, jnp.asarray(real), key,
            latent_dim=cfg.latent_dim, gp_weight=10.0)

    (jdl, jgp), jgrads = jax.value_and_grad(jd_loss, has_aux=True)(state.d_params)
    dp = _leaves(tree["d_params"])
    dl, gp = losses.forward_discriminator(
        gen, disc, params_from_numpy(tree["g_params"], "cpu"), dp, torch.from_numpy(real),
        jax_draws(key, N, cfg.latent_dim, real.shape[1:], jnp.float32), gp_weight=10.0)
    np.testing.assert_allclose(_np(dl), float(jdl), rtol=1e-4)
    np.testing.assert_allclose(_np(gp), float(jgp), rtol=1e-4)
    _assert_grads_close(losses.param_grads(dl, dp), jgrads)

    def jg_loss(gp_):
        return jax_losses.forward_generator(jgen, jdisc, gp_, state.d_params,
                                            jnp.asarray(real), key, latent_dim=cfg.latent_dim)

    jgl, jggrads = jax.value_and_grad(lambda p: jg_loss(p)[1])(state.g_params)
    gparams = _leaves(tree["g_params"])
    sample, gl = losses.forward_generator(gen, disc, gparams,
                                          params_from_numpy(tree["d_params"], "cpu"),
                                          jax_g_draws(key, N, cfg.latent_dim, jnp.float32))
    np.testing.assert_allclose(_np(gl), float(jgl), rtol=1e-4)
    _assert_grads_close(losses.param_grads(gl, gparams), jggrads)
    np.testing.assert_allclose(_np(sample), np.asarray(jg_loss(state.g_params)[0]), rtol=1e-4,
                               atol=1e-5)
