"""The five families after pgan (pgan2, pgandeep, stylegan, stylegan2, surfgan) in the
port against the JAX package on the CPU: G and D forwards from the reference's own
parameters, the style families' noise and mixing fed by name from the reference's keys,
one train step of each from one converted TrainState, surfgan's stacked critic pass, and
a `remat` step bit-equal to the plain step.

Small config of ``tests/test_models_all.py``: latent 16, 'xxs', filter_spec
[[8,8],[8,8],[4,4]], phase 2 (stylegan2 one phase: 1).  The JAX side runs its
``direct`` engine, the port ``flat`` (its kernels' plain versions here) or ``direct``.
Tolerances: f32 forwards rtol 1e-5 of max|ref|; bf16 forwards 3e-2 of max|ref| (a dozen
convs, each rounding its input and output to 8 bits, and the two frameworks round at
other places inside the mapping's matmuls); one step's losses rtol 1e-4 and parameters
rtol 1e-3, as ``tests/test_torch_train_step.py`` holds pgan."""

import dataclasses
import re
import zlib

import jax
import jax.extend.core
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jax_ops_core
from saragan_tpu import losses as jax_losses
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.train import init_train_state as jax_init_train_state
from saragan_tpu.train import make_train_step as jax_make_train_step
from saragan_tpu_torch import losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import (opt_state_from_optax, params_from_numpy,
                                       train_state_from_numpy, train_state_to_numpy)
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.models.style_ops import StyleMix
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops.core import LayerNoise, NoiseByName
from saragan_tpu_torch.optim.factory import make_optimizers_from_config
from saragan_tpu_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(1)

FAMILIES = ["pgan2", "pgandeep", "stylegan", "stylegan2", "surfgan"]
STYLE = {"stylegan", "stylegan2", "surfgan"}
N = 4
SMALL = dict(start_shape="(1, 4, 4, 4)", final_shape="(1, 32, 32, 32)", latent_dim=16,
             network_size="xxs",
             kernel_spec=[[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
             filter_spec=[[8, 8], [8, 8], [4, 4]], loss_fn="wgan", gp_weight=10.0,
             adam_beta1=0.0, adam_beta2=0.9, noise_stddev=0.0)


@pytest.fixture(autouse=True)
def jax_direct_engine(monkeypatch):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "direct")


def phase_of(arch: str) -> int:
    return 1 if arch == "stylegan2" else 2


def configs(arch: str, **kw):
    phase = phase_of(arch)
    args = dict(SMALL, architecture=arch, starting_phase=phase, ending_phase=phase, **kw)
    return JaxConfig(**args).finalize(), Config(**args).finalize()


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def np32(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def jax_params():
    """{arch: numpy params} from the reference's init."""
    out = {}
    for arch in FAMILIES:
        jcfg, _ = configs(arch)
        params = jax_arch(arch).init(jax.random.PRNGKey(0), phase=phase_of(arch), cfg=jcfg)
        out[arch] = {k: np.asarray(v) for k, v in params.items()}
    return out


class _Recorder:
    def __init__(self):
        self.shapes = {}

    def __call__(self, name, shape, dtype, device):
        self.shapes[name] = tuple(shape)
        return torch.zeros(shape, dtype=dtype, device=device)


def noise_layers(arch, cfg, phase, n):
    """{layer name: noise shape} of the port's generator at batch n."""
    rec = _Recorder()
    a = get_architecture(arch)
    params = a.init(torch.Generator().manual_seed(0), phase=phase, cfg=cfg, device="cpu")
    a.generator(params, torch.zeros(n, cfg.latent_dim), 0.5, phase=phase, cfg=cfg, noise=rec)
    return rec.shapes


def jax_style_draws(arch, cfg, phase, k_g, n, dtype, train=True):
    """The draws the reference's generator takes from its key `k_g`: (noise by name,
    StyleMix or None)."""
    mixes = train and (arch == "stylegan2" or phase > 1)
    mix, rng = None, k_g
    if mixes:
        k_mix, k_z, rng = jax.random.split(k_g, 3)
        k1, k2 = jax.random.split(k_mix)
        mix = StyleMix(to_torch(jax.random.normal(k_z, (n, cfg.latent_dim), dtype)),
                       to_torch(jax.random.uniform(k1, ())),
                       to_torch(jax.random.randint(k2, (), 1, max(phase, 2))))
    noise = {name: to_torch(jax.random.normal(
        jax.random.fold_in(rng, zlib.crc32(name.encode())), shape, dtype))
        for name, shape in noise_layers(arch, cfg, phase, n).items()}
    return NoiseByName(noise), mix


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["sample", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_generator_matches_jax(jax_params, arch, train, dtype):
    """G from the reference's parameters at alpha 0.5; in training mode the style
    families mix styles and add noise, in sampling mode they add noise only (stylegan
    also truncates), all from the reference's key."""
    jcfg, cfg = configs(arch)
    phase = phase_of(arch)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    z = jnp.asarray(np.random.default_rng(1).normal(size=(N, 16)), jdt)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_arch(arch).generator(jax_params[arch], z, 0.5, phase=phase, cfg=jcfg,
                                              rng=key, train=train), np.float32)
    kw = {}
    if arch in STYLE:
        kw["noise"], kw["mix"] = jax_style_draws(arch, cfg, phase, key, N, jdt, train)
    ours = get_architecture(arch).generator(params_from_numpy(jax_params[arch], "cpu"),
                                            to_torch(z), 0.5, phase=phase, cfg=cfg,
                                            conv_engine="flat", train=train, **kw)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == ref.shape
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np32(ours), ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_discriminator_matches_jax(jax_params, arch, dtype):
    jcfg, cfg = configs(arch)
    phase = phase_of(arch)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(np.random.default_rng(2).normal(size=cfg.current_shape(phase, N)), jdt)
    ref = np.asarray(jax_arch(arch).discriminator(jax_params[arch], x, 0.5, phase=phase,
                                                  cfg=jcfg), np.float32)
    calls = cf.conv3d_flat_plain.calls
    ours = get_architecture(arch).discriminator(params_from_numpy(jax_params[arch], "cpu"),
                                                to_torch(x), 0.5, phase=phase, cfg=cfg,
                                                conv_engine="flat")
    assert ours.shape == ref.shape == (N, 1)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np32(ours), ref, rtol=0, atol=tol * np.abs(ref).max())
    assert cf.conv3d_flat_plain.calls > calls  # the 3x3x3 convs went through kernel #1's path


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_names_and_shapes_match_jax(jax_params, arch):
    _, cfg = configs(arch)
    ours = get_architecture(arch).init(torch.Generator().manual_seed(0), phase=phase_of(arch),
                                       cfg=cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in jax_params[arch].items()}
    if arch == "surfgan":  # random-normal biases, as the reference's runtime_coef ops
        assert ours["discriminator/discriminator_out/dense2/bias"].abs().sum() > 0


# ---------------------------------------------------------------------------
# One train step from one converted TrainState
# ---------------------------------------------------------------------------


def _tree(state, opts=None):
    """The reference's TrainState in the port's numpy form; `opts` (the port's (G, D)
    optimizers) maps optax's state trees of another optimizer than Adam."""
    def opt(o, optimizer):
        if optimizer is not None:
            return opt_state_from_optax(optimizer, o)
        return {"count": np.asarray(o.count), "mu": {k: np.asarray(v) for k, v in o.mu.items()},
                "nu": {k: np.asarray(v) for k, v in o.nu.items()}}

    go, do = opts or (None, None)
    return {"g_params": {k: np.asarray(v) for k, v in state.g_params.items()},
            "d_params": {k: np.asarray(v) for k, v in state.d_params.items()},
            "g_opt": opt(state.g_opt, go), "d_opt": opt(state.d_opt, do),
            "ema": {k: np.asarray(v) for k, v in state.ema.items()}}


def step_draws(arch, cfg, phase, key, n, dtype, sample_shape, train_gen=True):
    """The reference's draws of one simultaneous step from its key (losses.py splits it
    into 5; the generator takes the second; refresh_state folds in 7)."""
    k_z, k_g, _, _, k_gamma = jax.random.split(key, 5)
    draws = losses.Draws(to_torch(jax.random.normal(k_z, (n, cfg.latent_dim), dtype)),
                         to_torch(jax.random.uniform(k_gamma, (n,) + (1,) * len(sample_shape),
                                                     dtype)))
    if arch not in STYLE:
        return draws
    noise, mix = jax_style_draws(arch, cfg, phase, k_g, n, dtype, train_gen)
    refresh_z = to_torch(jax.random.normal(jax.random.fold_in(key, 7), (64, cfg.latent_dim)))
    if mix is not None:
        draws = draws._replace(z_mix=mix.z, mix_coin=mix.coin, mix_cutoff=mix.cutoff)
    return draws._replace(noise=noise, refresh_z=refresh_z)


def jax_one_step(arch, alpha=0.5, n=N, **kw):
    """(initial state, state after one step, metrics, real, key) of the reference at
    batch `n`."""
    jcfg, cfg = configs(arch, **kw)
    phase = phase_of(arch)
    state, (jgo, jdo) = jax_init_train_state(jax_arch(arch), jax.random.PRNGKey(0),
                                             phase=phase, cfg=jcfg)
    real = np.random.default_rng(10).normal(size=cfg.current_shape(phase, n)).astype(np.float32)
    key = jax.random.PRNGKey(20)
    jstep = jax.jit(jax_make_train_step(jax_arch(arch), jcfg, phase, jgo, jdo))
    jstate, jm = jstep(state, jnp.asarray(real), key, alpha, 1e-3, 1e-3)
    return state, jstate, jm, real, key


def run_one_step(arch, alpha=0.5, draws_of=None, n=N, **kw):
    """One step of the reference and of the port from one converted state at batch `n`;
    the port's draws are ``draws_of(cfg, key, dtype, sample_shape)`` of the reference's
    step key (default: the simultaneous step's, ``step_draws``)."""
    _, cfg = configs(arch, **kw)
    phase = phase_of(arch)
    state, jstate, jm, real, key = jax_one_step(arch, alpha, n, **kw)
    tstate = train_state_from_numpy(_tree(state), "cpu")
    dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    if draws_of is None:
        draws = step_draws(arch, cfg, phase, key, n, dtype, real.shape[1:])
    else:
        draws = draws_of(cfg, key, dtype, real.shape[1:])
    step = make_train_step(get_architecture(arch), cfg, phase,
                           *make_optimizers_from_config(cfg), conv_engine="flat")
    tnew, m = step(tstate, torch.from_numpy(real), None, alpha, 1e-3, 1e-3, draws=draws)
    return jstate, jm, tstate, tnew, m


# stylegan's biases that instance norm follows: the norm subtracts any per-channel
# shift, so their exact gradient is 0 and both frameworks compute rounding noise there
ZERO_GRADIENT = r"generator/g_synthesis/.*/(constant_in|conv|conv_1|conv_2)/bias$"


def assert_step_close(ours, ref, arch, lr=1e-3):
    """One Adam step from one state.  With beta1 = 0 Adam's mu is the gradient: held to
    rtol 1e-3, atol 1e-3 * max|g| per variable, as the pgan step's gradients, or 1e-4 of
    the network's largest gradient where that is larger (D's gradient is the difference
    of the fake and real terms and the penalty's, each summed over N x S voxels: its f32
    error scales with those terms, of the network's scale, not with a small result);
    where the exact gradient is 0 (``ZERO_GRADIENT``), both within 1e-4 of the network's
    largest.
    Adam then moves each entry by lr * g / (|g| + 1e-8): where |g| is near 1e-8 (a few
    entries of the widest weights, and the zero-gradient biases) an f32 rounding of g
    moves that entry by up to 2 lr, so parameters and EMA agree within rtol 1e-3, atol
    1e-6 but for at most 1e-3 of the other entries, and none by more than 2 lr."""
    zero = re.compile(ZERO_GRADIENT) if arch == "stylegan" else None
    for net in ("g", "d"):
        mu_ref, mu = ref[f"{net}_opt"]["mu"], ours[f"{net}_opt"]["mu"]
        top = max(np.abs(g).max() for g in mu_ref.values())
        for k, g in mu_ref.items():
            if zero is not None and zero.search(k):
                assert max(np.abs(g).max(), np.abs(mu[k]).max()) <= 1e-4 * top, k
                continue
            np.testing.assert_allclose(mu[k], g, rtol=1e-3,
                                       atol=max(1e-3 * np.abs(g).max(), 1e-4 * top), err_msg=k)
        assert int(ours[f"{net}_opt"]["count"]) == int(ref[f"{net}_opt"]["count"]) == 1
    for part in ("g_params", "d_params", "ema"):
        off = total = 0
        for k, v in ref[part].items():
            d = np.abs(ours[part][k] - v)
            assert d.max() <= 2 * lr + 1e-6, (part, k, d.max())
            if zero is None or not zero.search(k):
                off += int(np.sum(d > 1e-6 + 1e-3 * np.abs(v)))
                total += v.size
        assert off <= 1e-3 * total, (part, off, total)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """The flagship's step options (WGAN-GP, shared fake pass, stacked critic) at alpha
    0.5: losses, gradients, every parameter, Adam count and the EMA after one step; the
    style families' w-average moved by refresh_state, as the reference's."""
    jstate, jm, tstate, tnew, m = run_one_step(arch)
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        np.testing.assert_allclose(np32(getattr(m, name)), np.asarray(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    ours, ref = train_state_to_numpy(tnew), _tree(jstate)
    assert_step_close(ours, ref, arch)
    if arch in STYLE:
        np.testing.assert_allclose(ours["g_params"]["generator/d_z_avg"],
                                   ref["g_params"]["generator/d_z_avg"], rtol=1e-4, atol=1e-7)
    if arch in STYLE:
        avg = ours["g_params"]["generator/d_z_avg"]
        assert np.abs(avg).max() > 0 and np.all(ours["g_opt"]["mu"]["generator/d_z_avg"] == 0)


EMA_STEPS = 3


def run_steps(arch, steps=EMA_STEPS, **kw):
    """`steps` steps of the reference and of the port from one converted state, step i
    with its own real batch, key and alpha 0.25 (i + 1), the reference's draws fed to the
    port; each step's losses held as ``test_train_step_matches_jax`` holds them.  Returns
    (reference state after the last step, the port's states after each step)."""
    jcfg, cfg = configs(arch, **kw)
    phase = phase_of(arch)
    state, (jgo, jdo) = jax_init_train_state(jax_arch(arch), jax.random.PRNGKey(0),
                                             phase=phase, cfg=jcfg)
    jstep = jax.jit(jax_make_train_step(jax_arch(arch), jcfg, phase, jgo, jdo))
    go, do = make_optimizers_from_config(cfg)
    tstate = train_state_from_numpy(_tree(state, (go, do)), "cpu")
    step = make_train_step(get_architecture(arch), cfg, phase, go, do, conv_engine="flat")
    history = []
    for i in range(steps):
        alpha = 0.25 * (i + 1)
        real = np.random.default_rng(10 + i).normal(
            size=cfg.current_shape(phase, N)).astype(np.float32)
        key = jax.random.PRNGKey(20 + i)
        state, jm = jstep(state, jnp.asarray(real), key, alpha, 1e-3, 1e-3)
        draws = step_draws(arch, cfg, phase, key, N, jnp.float32, real.shape[1:])
        tstate, m = step(tstate, torch.from_numpy(real), None, alpha, 1e-3, 1e-3, draws=draws)
        for name in ("gen_loss", "disc_loss", "gp_loss"):
            np.testing.assert_allclose(np32(getattr(m, name)), np.asarray(getattr(jm, name)),
                                       rtol=1e-4, atol=1e-6, err_msg=f"step {i} {name}")
        history.append(train_state_to_numpy(tstate))
    return state, history


@pytest.mark.parametrize("arch", sorted(STYLE))
def test_style_ema_after_steps_matches_jax(arch):
    """The style families' EMA shadow after 3 steps from one converted state, against the
    reference's.  ``ema_beta`` 0.5, so each step moves the shadow by half of the live
    weights' move and an entry the port failed to average (a mapping-net weight, the
    w-average buffer ``d_z_avg``) would stand half a step off.  Momentum, not Adam: Adam
    moves an entry whose gradient is rounding noise (stylegan's biases before instance
    norm) by +-lr, and over three steps stylegan's two trajectories part by more than
    rounding; with Momentum every move is lr * g, so the weights and the shadow stay within
    the pgan trajectory's limits (rtol 1e-3, atol 1e-6), the w-average (moved by
    ``refresh_state``, not by the optimizer) within rtol 1e-4; stylegan's biases whose
    exact gradient is 0 (``ZERO_GRADIENT``) move by lr times rounding noise, so they are
    held within atol 1e-5, a hundredth of lr.  Then the port's shadow
    against its own recurrence from the step before, 0.5 shadow' + 0.5 live."""
    beta = 0.5
    kw = dict(ema_beta=beta, optimizer="Momentum")
    jstate, history = run_steps(arch, **kw)
    opts = make_optimizers_from_config(configs(arch, **kw)[1])
    ours, ref = history[-1], _tree(jstate, opts)
    avg = "generator/d_z_avg"
    for part in ("g_params", "ema"):
        np.testing.assert_allclose(ours[part][avg], ref[part][avg], rtol=1e-4, atol=1e-7,
                                   err_msg=part)
    assert np.abs(ours["ema"][avg] - ours["g_params"][avg]).max() > 0
    zero = re.compile(ZERO_GRADIENT) if arch == "stylegan" else None
    for part in ("g_params", "d_params", "ema"):
        assert ours[part].keys() == ref[part].keys()
        for k, v in ref[part].items():
            atol = 1e-5 if zero is not None and zero.search(k) else 1e-6
            np.testing.assert_allclose(ours[part][k], v, rtol=1e-3, atol=atol, err_msg=k)
    # the recurrence, from the port's state one step before
    prev = history[-2]["ema"]
    live = {**ours["g_params"], **ours["d_params"]}
    assert ours["ema"].keys() == live.keys() == prev.keys()
    for k, v in ours["ema"].items():
        np.testing.assert_allclose(v, beta * prev[k] + (1 - beta) * live[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def moment_err(vols) -> float:
    """The family driver's gate reading: |mean| + |std - 1| of the samples."""
    vols = np.asarray(vols, np.float64)
    return abs(vols.mean()) + abs(vols.std() - 1.0)


@pytest.mark.parametrize("arch", sorted(STYLE))
def test_initial_moment_error_spread_matches_jax(arch):
    """The family driver's first reading is the initial generator's moment error.  Over
    six init seeds of each package (each from its own generator: JAX keys, torch seeds)
    the two spreads agree: the means within two standard errors of their difference.
    So a seed whose first reading already lies near the data's moments, where the gate
    (first live reading against the last EMA readings) is weakest, is as likely in the
    port as in the reference.  Sampling mode (noise, no mixing) at alpha 0, 16 samples of
    the small config."""
    jcfg, cfg = configs(arch)
    phase, n = phase_of(arch), 16
    z = np.random.default_rng(3).normal(size=(n, cfg.latent_dim)).astype(np.float32)
    ja, ta = jax_arch(arch), get_architecture(arch)
    jax_sample = jax.jit(lambda p, k: ja.generator(p, jnp.asarray(z), 0.0, phase=phase,
                                                   cfg=jcfg, rng=k, train=False))
    jax_errs, port_errs = [], []
    for seed in range(6):
        jp = ja.init(jax.random.PRNGKey(seed), phase=phase, cfg=jcfg)
        jax_errs.append(moment_err(jax_sample(jp, jax.random.PRNGKey(100 + seed))))
        tp = ta.init(torch.Generator().manual_seed(seed), phase=phase, cfg=cfg, device="cpu")
        with torch.no_grad():
            port_errs.append(moment_err(np32(ta.generator(
                tp, torch.from_numpy(z), 0.0, phase=phase, cfg=cfg, conv_engine="flat",
                train=False, noise=LayerNoise(100 + seed)))))
    j, p = np.asarray(jax_errs), np.asarray(port_errs)
    se = np.sqrt(j.var(ddof=1) / j.size + p.var(ddof=1) / p.size)
    print(f"{arch} initial moment errors: JAX {np.round(j, 4)}, port {np.round(p, 4)}")
    assert abs(j.mean() - p.mean()) <= 2 * se, (jax_errs, port_errs)


def _assert_grads_close(ours, ref, rtol, rel_atol):
    assert ours.keys() == ref.keys()
    for k, r in ref.items():
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(np32(ours[k]), r, rtol=rtol,
                                   atol=rel_atol * max(np.abs(r).max(), 1e-6), err_msg=k)


def test_surfgan_stacked_pass_matches_jax_batched_passes_and_unstacked(jax_params):
    """surfgan's D mixes samples: the stacked fake/real critic pass forms its
    minibatch-stddev groups inside each half, as the reference's vmap over the pair
    (``batched_passes=True``): the shared-fake-pass gradients against the reference's
    (rtol 1e-3, atol 1e-3 * max|g|), and against the port's passes kept apart (1e-5:
    the same sums, batched otherwise)."""
    jcfg, cfg = configs("surfgan")
    phase = phase_of("surfgan")
    params = jax_params["surfgan"]
    g_np = {k: v for k, v in params.items() if k.startswith("generator/")}
    d_np = {k: v for k, v in params.items() if k.startswith("discriminator/")}
    real = np.random.default_rng(3).normal(size=cfg.current_shape(phase, N)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    arch, jarch = get_architecture("surfgan"), jax_arch("surfgan")
    (jg, jd), jout = jax.jit(lambda gp, dp, x, k: jax_losses.grads_simultaneous(
        lambda p, z, kk=None: jarch.generator(p, z, 0.5, phase=phase, cfg=jcfg, rng=kk),
        lambda p, xx: jarch.discriminator(p, xx, 0.5, phase=phase, cfg=jcfg), gp, dp, x, k,
        latent_dim=cfg.latent_dim, gp_weight=10.0, batched_passes=True))(g_np, d_np, real, key)
    draws = step_draws("surfgan", cfg, phase, key, N, jnp.float32, real.shape[1:])
    mix = StyleMix(draws.z_mix, draws.mix_coin, draws.mix_cutoff)
    out = {}
    for batched in (True, False):
        def leaves(tree):
            return {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in tree.items()}

        out[batched] = losses.grads_simultaneous(
            lambda p, z: arch.generator(p, z, 0.5, phase=phase, cfg=cfg, conv_engine="flat",
                                        noise=draws.noise, mix=mix),
            lambda p, x, passes=1: arch.discriminator(p, x, 0.5, phase=phase, cfg=cfg,
                                                      conv_engine="flat", passes=passes),
            leaves(g_np), leaves(d_np), torch.from_numpy(real), draws, gp_weight=10.0,
            batched_passes=batched)
    (g, d), o = out[True]
    for ours, ref in zip(o[:3], jout[:3]):
        np.testing.assert_allclose(np32(ours), np.asarray(ref), rtol=1e-4, atol=1e-6)
    _assert_grads_close(g, jg, 1e-3, 1e-3)
    _assert_grads_close(d, jd, 1e-3, 1e-3)
    (ga, da), oa = out[False]
    _assert_grads_close(ga, {k: np32(v) for k, v in g.items()}, 1e-5, 1e-5)
    _assert_grads_close(da, {k: np32(v) for k, v in d.items()}, 1e-5, 1e-5)
    np.testing.assert_allclose(np32(oa.disc_loss), np32(o.disc_loss), rtol=1e-6)


def test_surfgan_bf16_step_matches_jax():
    """One bf16 step (the flagship's dtype): losses within 2e-2; per network, the port's
    bf16 gradients (Adam's mu) no farther from the reference's f32 gradients than twice
    the reference's own bf16 gradients are, relative to the network's largest gradient
    (its bias gradients sum N x S bf16 terms that nearly cancel); every parameter within
    2 lr, the most Adam's first step can move one apart."""
    jstate, jm, _, tnew, m = run_one_step("surfgan", compute_dtype="bfloat16")
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        np.testing.assert_allclose(np32(getattr(m, name)), np.asarray(getattr(jm, name)),
                                   rtol=2e-2, atol=1e-3, err_msg=name)
    ours, ref = train_state_to_numpy(tnew), _tree(jstate)
    f32 = _tree(jax_one_step("surfgan")[1])
    for net in ("g", "d"):
        exact = f32[f"{net}_opt"]["mu"]
        top = max(np.abs(g).max() for g in exact.values())

        def err(mu):
            return max(np.abs(mu[k] - g).max() for k, g in exact.items()) / top

        ref_err, our_err = err(ref[f"{net}_opt"]["mu"]), err(ours[f"{net}_opt"]["mu"])
        assert our_err <= 2 * ref_err + 1e-3, (net, our_err, ref_err)
    for part in ("g_params", "d_params"):
        for k, v in ref[part].items():
            assert np.abs(ours[part][k] - v).max() <= 2e-3 + 1e-6, k


@pytest.mark.parametrize("arch", ["stylegan", "surfgan"])
def test_remat_step_equals_plain_step(arch):
    """Recompute redraws each layer's noise from its seeded generator: a `remat` step,
    drawing everything from one generator on its own, equals the plain step bit for
    bit."""
    _, cfg = configs(arch)
    phase = phase_of(arch)
    a = get_architecture(arch)
    state, opts = init_train_state(a, torch.Generator().manual_seed(0), phase=phase, cfg=cfg,
                                   device="cpu")
    real = torch.randn(cfg.current_shape(phase, N), generator=torch.Generator().manual_seed(1))
    out = []
    for remat in (False, True):
        step = make_train_step(a, dataclasses.replace(cfg, remat=remat), phase, *opts,
                               conv_engine="flat")
        out.append(step(state, real, torch.Generator().manual_seed(2), 0.5, 1e-3, 1e-3))
    (s0, m0), (s1, m1) = out
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        assert torch.equal(getattr(m0, name), getattr(m1, name)), name
    for part in ("g_params", "d_params", "ema"):
        for k, v in getattr(s0, part).items():
            assert torch.equal(getattr(s1, part)[k], v), (part, k)
    assert not torch.equal(s0.g_params["generator/d_z_avg"], state.g_params["generator/d_z_avg"])


def _reference_kernel_calls(arch, jcfg, phase, n):
    """pallas_call equations of the reference's step under the ``pallas`` engine, by
    kernel body, in its traced (abstract) program."""
    opts = {}

    def init(k):
        state, opts["opt"] = jax_init_train_state(jax_arch(arch), k, phase=phase, cfg=jcfg)
        return state

    state = jax.eval_shape(init, jax.random.PRNGKey(0))
    step = jax_make_train_step(jax_arch(arch), jcfg, phase, *opts["opt"])
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


@pytest.mark.parametrize("arch", ["stylegan", "surfgan"])
def test_kernel_calls_per_step_match_reference_algebra(monkeypatch, arch):
    """The port's flat step launches kernel #1 (forward and dgrad) wherever the
    reference's traced step has a ``_fwd_kernel``, and #2 wherever it has a
    ``_wgrad_kernel`` but the weight gradients of the penalty's inner input gradient,
    one per D conv that is not 1x1x1, which nothing reads (XLA drops them; the port never
    forms them).  The modulated convs' plain convs are kernel calls.  The port's step
    runs on the meta device (shapes only)."""
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", "pallas")
    jcfg, cfg = configs(arch)
    phase = phase_of(arch)
    ref = _reference_kernel_calls(arch, jcfg, phase, N)
    a = get_architecture(arch)
    state, opts = init_train_state(a, torch.Generator().manual_seed(0), phase=phase, cfg=cfg,
                                   device="meta")
    real = torch.empty(cfg.current_shape(phase, N), device="meta")
    draws = losses.draw_inputs(None, N, cfg.latent_dim, real.shape[1:], torch.float32, "meta",
                               style_phase=phase)
    before = cf.conv3d_flat_plain.calls, cf.conv3d_flat_wgrad_plain.calls
    make_train_step(a, cfg, phase, *opts, conv_engine="flat")(state, real, None, 0.5, 1e-3,
                                                              1e-3, draws=draws)
    ours = cf.conv3d_flat_plain.calls - before[0], cf.conv3d_flat_wgrad_plain.calls - before[1]
    d_convs = 2 * (phase - 1) + 1  # the D blocks' two 3x3x3 convs and the head's
    assert ref == {"_fwd_kernel": ours[0], "_wgrad_kernel": ours[1] + d_convs}, (ref, ours)
