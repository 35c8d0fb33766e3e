"""One simultaneous G/D train step of WGAN-GP with Adam and the EMA, written plainly.

Losses (Gulrajani et al., arXiv:1704.00028, with the progressive-growing drift term):

    gen_loss  = -mean D(G(z))
    disc_loss = mean(D(G(z)) - D(x) + gp_weight (|grad D(x_hat)| - 1)^2 + 1e-3 D(x)^2)

with x_hat = gamma x + (1 - gamma) G(z) and the slope norm taken over axes (1, 2, 3) of
the NCDHW gradient, so one slope per sample and W slice, as the saraGAN code reduces it.
G's gradient is that of gen_loss, D's that of disc_loss, both at the step's parameters.
Adam as optax's ``scale_by_adam`` (bias-corrected moments, epsilon 1e-8 outside the
root), the update ``-lr * u``; names frozen in the mixing half keep their value and
moments.  surfgan moves ``generator/d_z_avg`` toward the mapped refresh latents after the
update.  Then the EMA over G and D: ``ema = beta ema + (1 - beta) params``.

Everything runs in float32 with TF32 off unless ``rounding`` asks for less.
``rows`` keeps only those rows of the batch and its draws (a fault for the check's
tests).
"""

from __future__ import annotations

import ast
import contextlib
from typing import Dict, FrozenSet, NamedTuple, Optional

import torch

from portbench.reference import pgan, surfgan
from portbench.reference.ops import NO_ROUNDING, Params, Rounding

ARCHS = {"pgan": pgan, "surfgan": surfgan}


def model_cfg(config: dict) -> dict:
    """The reference's view of a configuration file's ``config``."""
    cfg = dict(config)
    cfg["base_shape"] = list(ast.literal_eval(str(config["start_shape"])))
    cfg.setdefault("leakiness", 0.2)
    return cfg


@contextlib.contextmanager
def full_float32():
    """float32 convs and matmuls: TF32 off; restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def param_shapes(cfg: dict, phase: int) -> Dict[str, tuple]:
    """Every parameter's name and shape at `phase`, from one shape pass of G and D."""
    arch = ARCHS[cfg["architecture"]]
    p = Params.shapes()
    base = cfg["base_shape"]
    size = [d * 2 ** (phase - 1) for d in base[1:]]
    z = torch.zeros((1, cfg["latent_dim"]), device="meta")
    arch.generator(p, z, 0.5, phase=phase, cfg=cfg)
    arch.discriminator(p, torch.zeros((1, base[0], *size), device="meta"), 0.5, phase=phase,
                       cfg=cfg)
    return dict(p.recorded)


def frozen_names(cfg: dict, phase: int) -> FrozenSet[str]:
    """The names the previous phase's model already had: frozen in the mixing half."""
    if phase <= 1:
        return frozenset()
    return frozenset(param_shapes(cfg, phase)) & frozenset(param_shapes(cfg, phase - 1))


class Draws(NamedTuple):
    z: torch.Tensor
    gamma: torch.Tensor
    z_mix: Optional[torch.Tensor] = None
    mix_coin: Optional[torch.Tensor] = None
    mix_cutoff: Optional[torch.Tensor] = None
    refresh_z: Optional[torch.Tensor] = None
    # {layer name: (N, 1, *spatial)}, or a callable (name, shape) -> tensor
    noise: Optional[object] = None


class State(NamedTuple):
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int
    ema: Dict[str, torch.Tensor]


def init_state(params: Dict[str, torch.Tensor]) -> State:
    f32 = {k: v.detach().float().clone() for k, v in params.items()}
    return State(f32, {k: torch.zeros_like(v) for k, v in f32.items()},
                 {k: torch.zeros_like(v) for k, v in f32.items()}, 0,
                 {k: v.clone() for k, v in f32.items()})


def _keep(draws: Draws, real: torch.Tensor, rows):
    if rows is None:
        return draws, real
    pick = lambda t: None if t is None else t[rows]  # noqa: E731
    noise = draws.noise
    if isinstance(noise, dict):
        noise = {k: v[rows] for k, v in noise.items()}
    return draws._replace(z=draws.z[rows], gamma=draws.gamma[rows], z_mix=pick(draws.z_mix),
                          noise=noise), real[rows]


def losses_and_grads(params, real, draws: Draws, alpha, *, cfg: dict, phase: int,
                     q: Rounding = NO_ROUNDING, rows=None):
    """((gen_loss, disc_loss, gp_loss), {name: gradient}) at `params` (float32)."""
    arch = ARCHS[cfg["architecture"]]
    draws, real = _keep(draws, real, rows)
    live = {k: v.detach().float().requires_grad_(True) for k, v in params.items()}
    g_names = [k for k in live if k.startswith("generator/")]
    d_names = [k for k in live if k.startswith("discriminator/")]
    p = Params(live)
    gen_kw = {}
    if cfg["architecture"] == "surfgan":
        noise = draws.noise
        if noise is not None and not callable(noise):
            table = noise
            noise = lambda name, shape: table[name].float()  # noqa: E731
        gen_kw = dict(noise=noise, mix=(draws.z_mix.float(), draws.mix_coin, draws.mix_cutoff))
    real = real.float()
    fake = arch.generator(p, draws.z.float(), alpha, phase=phase, cfg=cfg, q=q, **gen_kw)
    fake_score = torch.mean(arch.discriminator(p, fake, alpha, phase=phase, cfg=cfg, q=q))
    rs = arch.discriminator(p, real, alpha, phase=phase, cfg=cfg, q=q)
    real_term = torch.mean(-rs + 1e-3 * rs * rs)
    names = g_names + d_names
    first = torch.autograd.grad(fake_score + real_term, [live[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    first = dict(zip(names, first))
    gamma = draws.gamma.float().reshape(-1, *([1] * (real.ndim - 1)))
    interp = (gamma * real + (1 - gamma) * fake.detach()).requires_grad_(True)
    score = arch.discriminator(p, interp, alpha, phase=phase, cfg=cfg, q=q).sum()
    (gx,) = torch.autograd.grad(score, interp, create_graph=True)
    slopes = torch.sqrt(torch.sum(gx * gx, dim=(1, 2, 3)))
    gp = torch.mean(cfg["gp_weight"] * (slopes - 1.0) ** 2)
    gp_grads = torch.autograd.grad(gp, [live[k] for k in d_names], allow_unused=True,
                                   materialize_grads=True)
    grads = {k: -first[k] for k in g_names}
    grads.update({k: first[k] + g for k, g in zip(d_names, gp_grads)})
    losses = tuple(float(v) if v.device.type != "meta" else v
                   for v in (-fake_score.detach(), (fake_score + real_term + gp).detach(),
                             gp.detach()))
    return losses, grads


@torch.no_grad()
def adam(state: State, grads, *, cfg: dict, frozen: FrozenSet[str]) -> State:
    b1, b2 = cfg["adam_beta1"], cfg["adam_beta2"]
    count = state.count + 1
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    params, mu, nu = dict(state.params), dict(state.mu), dict(state.nu)
    for k, v in state.params.items():
        if k in frozen:
            continue
        g = grads[k]
        lr = cfg["g_lr"] if k.startswith("generator/") else cfg["d_lr"]
        mu[k] = (1 - b1) * g + b1 * state.mu[k]
        nu[k] = (1 - b2) * g * g + b2 * state.nu[k]
        params[k] = v - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8))
    return State(params, mu, nu, count, state.ema)


def step(state: State, real, draws: Draws, alpha, *, cfg: dict, phase: int,
         frozen: FrozenSet[str] = frozenset(), q: Rounding = NO_ROUNDING, rows=None):
    """(new state, (gen_loss, disc_loss, gp_loss), gradients)."""
    losses, grads = losses_and_grads(state.params, real, draws, alpha, cfg=cfg, phase=phase,
                                     q=q, rows=rows)
    new = adam(state, grads, cfg=cfg, frozen=frozen)
    params = new.params
    with torch.no_grad():
        if cfg["architecture"] == "surfgan":
            params = dict(params)
            params["generator/d_z_avg"] = surfgan.refresh_w_average(
                Params(params), draws.refresh_z, phase, cfg)
        beta = cfg["ema_beta"]
        ema = {k: beta * e + (1 - beta) * params[k] for k, e in state.ema.items()}
    return new._replace(params=params, ema=ema), losses, grads
