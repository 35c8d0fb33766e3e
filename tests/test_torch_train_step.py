"""The training slice of the port against the JAX package: Adam and the EMA against
optax, the simultaneous losses and their gradients fed the reference's own random draws,
and make_train_step from one converted TrainState (one step, a 3-step trajectory, bf16).

The JAX step runs under its ``direct`` conv engine (same math as ``pallas``; the kernel
files hold the Pallas path), the port's under ``flat``, whose plain versions run on the
CPU.  f32 tolerances: losses rtol 1e-4, gradients rtol 1e-3 / atol 1e-3 * max|g| (the
penalty's double backward sums in other orders), parameters rtol 1e-3 (Adam's first
steps move each parameter by about lr * sign(g))."""

import jax
import jax.extend.core
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import saragan_tpu.ops.core as jax_ops_core
from saragan_tpu import losses as jax_losses
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.optim.ema import ema_update as jax_ema_update
from saragan_tpu.optim.factory import make_optimizer as jax_make_optimizer
from saragan_tpu.train import init_train_state as jax_init_train_state
from saragan_tpu.train import make_train_step as jax_make_train_step
from saragan_tpu_torch import losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import (params_from_numpy, params_to_numpy,
                                       train_state_from_numpy, train_state_to_numpy)
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.optim.ema import ema_init, ema_update
from saragan_tpu_torch.optim.factory import make_optimizer, make_optimizers_from_config
from saragan_tpu_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(1)

CFG = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 8, 32, 32)",
           latent_dim=16, filter_spec=[[16, 16], [16, 8], [8, 8]], loss_fn="wgan",
           gp_weight=10.0, adam_beta1=0.0, adam_beta2=0.9, use_pallas_fusion=True)
PHASE = 2
N = 2


@pytest.fixture(autouse=True)
def jax_direct_engine(monkeypatch):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "direct")


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def jax_draws(key, n, latent_dim, sample_shape, dtype, noise_stddev=0.0):
    """The reference's own draws: losses.py splits the step key into 5."""
    k_z, _, k_nr, k_nf, k_gamma = jax.random.split(key, 5)
    z = jax.random.normal(k_z, (n, latent_dim), dtype)
    gamma = jax.random.uniform(k_gamma, (n,) + (1,) * len(sample_shape), dtype)
    noise = [None, None]
    if noise_stddev:
        noise = [_to_torch(jax.random.normal(k, (n, *sample_shape), dtype)) for k in (k_nr, k_nf)]
    return losses.Draws(_to_torch(z), _to_torch(gamma), *noise)


def _configs(**kw):
    return JaxConfig(**CFG, **kw).finalize(), Config(**CFG, **kw).finalize()


def _real(cfg, seed=0):
    shape = cfg.current_shape(PHASE, N)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_state(jcfg):
    state, opts = jax_init_train_state(jax_arch("pgan"), jax.random.PRNGKey(0), phase=PHASE,
                                       cfg=jcfg)
    return state, opts


def _tree(state):
    def opt(o):
        return {"count": np.asarray(o.count), "mu": {k: np.asarray(v) for k, v in o.mu.items()},
                "nu": {k: np.asarray(v) for k, v in o.nu.items()}}

    return {"g_params": {k: np.asarray(v) for k, v in state.g_params.items()},
            "d_params": {k: np.asarray(v) for k, v in state.d_params.items()},
            "g_opt": opt(state.g_opt), "d_opt": opt(state.d_opt),
            "ema": {k: np.asarray(v) for k, v in state.ema.items()}}


def _assert_grads_close(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        np.testing.assert_allclose(_np(ours[k]), r, rtol=1e-3,
                                   atol=1e-3 * max(np.abs(r).max(), 1e-6), err_msg=k)


# ---------------------------------------------------------------------------
# Adam and EMA
# ---------------------------------------------------------------------------


def test_adam_and_ema_match_optax():
    rng = np.random.default_rng(0)
    params = {"a/weight": rng.normal(size=(3, 4)).astype(np.float32),
              "a/bias": np.zeros(4, np.float32)}
    ref_opt = jax_make_optimizer("Adam", beta1=0.0, beta2=0.9)
    ours_opt = make_optimizer("Adam", beta1=0.0, beta2=0.9)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = ref_opt.init(ref_p)
    assert isinstance(ref_s, optax.ScaleByAdamState)
    p = params_from_numpy(params, "cpu")
    s = ours_opt.init(p)
    ref_ema, ema = dict(ref_p), ema_init(p)
    for i, lr in enumerate((1e-3, 5e-4, 2e-3)):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 10 ** -i
                 for k, v in params.items()}
        grads["a/bias"][0] = 0.0
        ref_p, ref_s = ref_opt.update({k: jnp.asarray(v) for k, v in grads.items()}, ref_s,
                                      ref_p, lr)
        p, s = ours_opt.update(params_from_numpy(grads, "cpu"), s, p, lr)
        ref_ema = jax_ema_update(ref_ema, ref_p, 0.99)
        ema = ema_update(ema, p, 0.99)
    assert s.count == int(ref_s.count) == 3
    for k in params:
        np.testing.assert_allclose(_np(p[k]), np.asarray(ref_p[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(s.mu[k]), np.asarray(ref_s.mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(_np(s.nu[k]), np.asarray(ref_s.nu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(_np(ema[k]), np.asarray(ref_ema[k]), rtol=1e-6, atol=1e-7)
    assert ema["a/weight"].data_ptr() != p["a/weight"].data_ptr()


def test_other_optimizers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer("LAMB")


# ---------------------------------------------------------------------------
# Losses and their gradients, fed the reference's draws
# ---------------------------------------------------------------------------


def _loss_fns(jcfg, cfg, alpha):
    ja, pa = jax_arch("pgan"), get_architecture("pgan")

    def jgen(p, z, k=None):
        return ja.generator(p, z, alpha, phase=PHASE, cfg=jcfg, rng=k)

    def jdisc(p, x):
        return ja.discriminator(p, x, alpha, phase=PHASE, cfg=jcfg)

    def gen(p, z):
        return pa.generator(p, z, alpha, phase=PHASE, cfg=cfg, conv_engine="flat")

    def disc(p, x):
        return pa.discriminator(p, x, alpha, phase=PHASE, cfg=cfg, conv_engine="flat")

    return jgen, jdisc, gen, disc


def _leaves(tree_np):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in tree_np.items()}


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "unbatched"])
def test_grads_simultaneous_match_jax(batched):
    jcfg, cfg = _configs(noise_stddev=0.1)
    state, _ = _jax_state(jcfg)
    tree = _tree(state)
    jgen, jdisc, gen, disc = _loss_fns(jcfg, cfg, 0.5)
    real = _real(cfg)
    key = jax.random.PRNGKey(3)
    (jg, jd), jout = jax_losses.grads_simultaneous(
        jgen, jdisc, state.g_params, state.d_params, jnp.asarray(real), key,
        latent_dim=cfg.latent_dim, gp_weight=10.0, noise_stddev=0.1, batched_passes=batched)
    draws = jax_draws(key, N, cfg.latent_dim, real.shape[1:], jnp.float32, noise_stddev=0.1)
    (g, d), out = losses.grads_simultaneous(
        gen, disc, _leaves(tree["g_params"]), _leaves(tree["d_params"]), torch.from_numpy(real),
        draws, gp_weight=10.0, noise_stddev=0.1, batched_passes=batched)
    for ours, ref in zip(out[:3], jout[:3]):
        np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(out.gen_sample), np.asarray(jout.gen_sample), rtol=1e-4,
                               atol=1e-5)
    _assert_grads_close(g, jg)
    _assert_grads_close(d, jd)


@pytest.mark.parametrize("loss_fn", ["wgan", "logistic"])
def test_forward_simultaneous_matches_jax(loss_fn):
    jcfg, cfg = _configs()
    state, _ = _jax_state(jcfg)
    tree = _tree(state)
    jgen, jdisc, gen, disc = _loss_fns(jcfg, cfg, 0.0)
    real = _real(cfg, seed=1)
    key = jax.random.PRNGKey(4)

    def jtotal(gp, dp):
        out = jax_losses.forward_simultaneous(jgen, jdisc, gp, dp, jnp.asarray(real), key,
                                              latent_dim=cfg.latent_dim, loss_fn=loss_fn,
                                              gp_weight=10.0)
        return out.gen_loss + out.disc_loss, out

    (jg, jd), jout = jax.grad(jtotal, argnums=(0, 1), has_aux=True)(state.g_params,
                                                                   state.d_params)
    gp, dp = _leaves(tree["g_params"]), _leaves(tree["d_params"])
    out = losses.forward_simultaneous(gen, disc, gp, dp, torch.from_numpy(real),
                                      jax_draws(key, N, cfg.latent_dim, real.shape[1:],
                                                jnp.float32),
                                      loss_fn=loss_fn, gp_weight=10.0)
    grads = losses.param_grads(out.gen_loss + out.disc_loss, {**gp, **dp})
    for ours, ref in zip(out[:3], jout[:3]):
        np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-4, atol=1e-6)
    _assert_grads_close({k: grads[k] for k in gp}, jg)
    _assert_grads_close({k: grads[k] for k in dp}, jd)


# ---------------------------------------------------------------------------
# make_train_step from one converted TrainState
# ---------------------------------------------------------------------------


def _run_both(jcfg, cfg, steps, static_alpha=None, alpha=0.5):
    state, (jgo, jdo) = _jax_state(jcfg)
    jstep = jax.jit(jax_make_train_step(jax_arch("pgan"), jcfg, PHASE, jgo, jdo,
                                        static_alpha=static_alpha))
    tstate = train_state_from_numpy(_tree(state), "cpu")
    go, do = make_optimizers_from_config(cfg)
    step = make_train_step(get_architecture("pgan"), cfg, PHASE, go, do,
                           static_alpha=static_alpha, conv_engine="flat")
    dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    history = []
    for i in range(steps):
        real = _real(cfg, seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        state, jm = jstep(state, jnp.asarray(real), key, alpha, 1e-3, 1e-3)
        draws = jax_draws(key, N, cfg.latent_dim, real.shape[1:], dtype)
        tstate, m = step(tstate, torch.from_numpy(real), None, alpha, 1e-3, 1e-3, draws=draws)
        history.append((jm, m))
    return state, tstate, history


def _assert_states_close(jstate, tstate, rtol, atol):
    ours = train_state_to_numpy(tstate)
    ref = _tree(jstate)
    for part in ("g_params", "d_params", "ema"):
        for k, v in ref[part].items():
            np.testing.assert_allclose(ours[part][k], v, rtol=rtol, atol=atol, err_msg=k)
    for part in ("g_opt", "d_opt"):
        assert int(ours[part]["count"]) == int(ref[part]["count"])


@pytest.mark.parametrize("steps", [1, 3], ids=["one_step", "trajectory"])
def test_train_step_matches_jax_f32(steps):
    jcfg, cfg = _configs()
    jstate, tstate, history = _run_both(jcfg, cfg, steps)
    for jm, m in history:
        for name in ("gen_loss", "disc_loss", "gp_loss"):
            np.testing.assert_allclose(_np(getattr(m, name)), np.asarray(getattr(jm, name)),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(_np(m.max_d_norm), np.asarray(jm.max_d_norm), rtol=1e-3)
    _assert_states_close(jstate, tstate, rtol=1e-3, atol=1e-6)


def test_train_step_matches_jax_bf16():
    """One bf16 step.  Losses within 2e-2 relative.  Adam's first step moves every
    parameter by lr * g / (|g| + eps), about lr * sign(g), so parameters either agree or,
    where a gradient near 0 changed sign under bf16 rounding, differ by 2 * lr: at most
    1 % of the entries may, and none by more."""
    jcfg, cfg = _configs(compute_dtype="bfloat16")
    jstate, tstate, history = _run_both(jcfg, cfg, 1)
    jm, m = history[0]
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        np.testing.assert_allclose(_np(getattr(m, name)), np.asarray(getattr(jm, name)),
                                   rtol=2e-2, atol=1e-3, err_msg=name)
    ours, ref = train_state_to_numpy(tstate), _tree(jstate)
    diffs = np.concatenate([np.abs(ours[part][k] - v).ravel() for part in ("g_params", "d_params")
                            for k, v in ref[part].items()])
    assert diffs.max() <= 2e-3 + 1e-6
    assert np.mean(diffs > 1e-5) <= 0.01


def test_static_alpha_zero_equals_alpha_traced_at_zero():
    _, cfg = _configs()
    arch = get_architecture("pgan")
    state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0), phase=PHASE,
                                       cfg=cfg, device="cpu")
    real = torch.from_numpy(_real(cfg, seed=5))
    out = []
    for static in (0.0, None):
        step = make_train_step(arch, cfg, PHASE, go, do, static_alpha=static,
                               conv_engine="flat")
        calls = cf.conv3d_flat_plain.calls
        new, m = step(state, real, torch.Generator().manual_seed(6), 0.0, 1e-3, 1e-3)
        out.append((new, m, cf.conv3d_flat_plain.calls - calls))
    (a, ma, ca), (b, mb, cb) = out
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        torch.testing.assert_close(getattr(ma, name), getattr(mb, name), rtol=1e-6, atol=1e-7)
    for part in ("g_params", "d_params", "ema"):
        for k in getattr(a, part):
            torch.testing.assert_close(getattr(a, part)[k], getattr(b, part)[k], rtol=1e-6,
                                       atol=1e-7)
    assert ca == cb  # the transition branches are 1x1 convs, pooling and blends


@pytest.mark.parametrize("change,match", [
    (dict(optim_strategy="alternate"), "alternate"), (dict(remat=True), "remat"),
    (dict(gradient_accumulation=2), "gradient_accumulation"),
    (dict(gp_grad_mode="revfwd"), "revfwd"), (dict(optimizer="SGD"), "SGD")])
def test_unported_options_raise(change, match):
    _, cfg = _configs(**change)
    arch = get_architecture("pgan")
    with pytest.raises(NotImplementedError, match=match):
        state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0),
                                           phase=PHASE, cfg=cfg, device="cpu")
        step = make_train_step(arch, cfg, PHASE, go, do, conv_engine="flat")
        step(state, torch.from_numpy(_real(cfg)), torch.Generator().manual_seed(0), 0.5,
             1e-3, 1e-3)
    with pytest.raises(NotImplementedError, match="freezing"):
        _, cfg = _configs()
        make_train_step(arch, cfg, PHASE, *make_optimizers_from_config(cfg), freeze=True,
                        frozen_names=frozenset({"generator/x"}))
    with pytest.raises(NotImplementedError, match="histogram"):
        make_train_step(arch, cfg, PHASE, *make_optimizers_from_config(cfg),
                        grad_histograms=True)


def test_train_state_numpy_round_trip():
    _, cfg = _configs()
    state, _ = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                phase=PHASE, cfg=cfg, device="cpu")
    back = train_state_from_numpy(train_state_to_numpy(state), "cpu")
    assert back.g_opt.count == 0 and back.ema.keys() == {**state.g_params, **state.d_params}.keys()
    for k, v in state.ema.items():
        assert torch.equal(back.ema[k], v) and back.ema[k].data_ptr() != v.data_ptr()
    assert params_to_numpy(back.d_params).keys() == state.d_params.keys()


# ---------------------------------------------------------------------------
# Kernel calls per step against the reference's C/W algebra
# ---------------------------------------------------------------------------

BENCH6 = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 128, 512, 512)",
              latent_dim=256, base_batch_size=8 * 2 ** 5, network_size="xs", loss_fn="wgan",
              gp_weight=10.0, adam_beta1=0.0, adam_beta2=0.9, compute_dtype="bfloat16",
              use_pallas_fusion=True)


def _reference_kernel_calls(jcfg, phase, n):
    """pallas_call equations of the reference's step under the ``pallas`` engine, by
    kernel body, in its traced (abstract, nothing computed) program."""
    arch = jax_arch("pgan")
    opts = {}

    def init(k):
        state, opts["opt"] = jax_init_train_state(arch, k, phase=phase, cfg=jcfg)
        return state

    state = jax.eval_shape(init, jax.random.PRNGKey(0))
    step = jax_make_train_step(arch, jcfg, phase, *opts["opt"], static_alpha=None)
    real = jax.ShapeDtypeStruct(jcfg.current_shape(phase, n), jnp.float32)
    jaxpr = jax.make_jaxpr(step)(state, real, jax.random.PRNGKey(1), 0.5, 1e-3, 1e-3).jaxpr
    calls = {}

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "pallas_call":
                body = str(e.params["jaxpr"].debug_info.func_src_info).split(" at ")[0]
                calls[body] = calls.get(body, 0) + 1
            for p in e.params.values():
                for q in (p if isinstance(p, (list, tuple)) else [p]):
                    if isinstance(q, jax.extend.core.ClosedJaxpr):
                        walk(q.jaxpr)
                    elif isinstance(q, jax.extend.core.Jaxpr):
                        walk(q)

    walk(jaxpr)
    return calls


@pytest.mark.parametrize("kw,phase,n,expected", [
    (CFG, 2, N, (19, 8, 3)), (CFG, 3, N, (31, 13, 5)), (BENCH6, 6, 8, (67, 28, 11))],
    ids=["phase2", "phase3", "bench_phase6"])
def test_kernel_calls_per_step_match_reference_algebra(monkeypatch, kw, phase, n, expected):
    """The port's flat step makes as many conv-kernel calls (forward + dgrad) and fused
    calls as the reference's traced step has ``_fwd_kernel`` and ``_fused_kernel``
    pallas_calls, and fewer wgrads: the reference's custom VJP also forms the weight
    gradients of the penalty's inner input-gradient (one per D conv that is not 1x1x1),
    which nothing reads and XLA drops; the port never launches them.  The port's step
    runs on the meta device (shapes only, through the plain versions' dispatch)."""
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "pallas")
    jcfg, cfg = JaxConfig(**kw).finalize(), Config(**kw).finalize()
    ref = _reference_kernel_calls(jcfg, phase, n)

    arch = get_architecture("pgan")
    state, (go, do) = init_train_state(arch, torch.Generator().manual_seed(0), phase=phase,
                                       cfg=cfg, device="meta")
    real = torch.empty(cfg.current_shape(phase, n), device="meta")
    draws = losses.draw_inputs(None, n, cfg.latent_dim, real.shape[1:], torch.float32, "meta")
    step = make_train_step(arch, cfg, phase, go, do, conv_engine="flat")
    before = (cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls,
              fba.bias_act_pixelnorm_plain.calls)
    step(state, real, None, 0.5, 1e-3, 1e-3, draws=draws)
    ours = (cf.conv3d_flat_plain.calls - before[0], cf.conv3d_flat_wgrad_plain.calls - before[1],
            fba.bias_act_pixelnorm_plain.calls - before[2])
    d_convs = 2 * (phase - 1) + 1  # the D blocks' two convs and discriminator_out's
    assert ours == expected
    assert ref == {"_fwd_kernel": ours[0], "_wgrad_kernel": ours[1] + d_convs,
                   "_fused_kernel": ours[2]}
