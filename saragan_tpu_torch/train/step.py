"""The training step (counterpart of ``saragan_tpu/train/step.py``).

One step of the simultaneous G/D update: the losses' gradients with respect to both
parameter sets, optional global-norm clipping per network (with per-variable norms
reported on the clipped gradients), Adam with ``-lr * u`` applied at update time, and
the EMA over G+D.  Two gradient paths, as in the reference:

* ``fused_grads`` with the WGAN loss (the flagship): ``losses.grads_simultaneous``, one
  discriminator backward over the fake batch for both networks, the fake and real
  critic passes stacked into one call when ``batched_passes``;
* otherwise ``losses.forward_simultaneous`` and one gradient of gen_loss + disc_loss
  (the logistic loss always takes this path).

Numerics: parameters, gradients, Adam state and EMA are f32; with
``compute_dtype="bfloat16"`` the batch and latents are bf16 and the models cast weights
to the activation dtype at use (no autocast).  Library convs (the ``direct`` engine, the
polyphase transitions) run under deterministic cuDNN with TF32 off, as serving does,
and matmuls with TF32 off (``_train_numerics``).

Not ported (each raises and names ROADMAP.md): ``optim_strategy="alternate"``,
``remat``/``remat_offload``, previous-phase freezing, gradient histograms,
``gradient_accumulation > 1``, ``gp_grad_mode="revfwd"``, spectral norm.

The step builds its graph eagerly and makes no host synchronisation: losses and metrics
come back as device tensors.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, FrozenSet, NamedTuple, Optional, Tuple

import torch

from saragan_tpu_torch import losses
from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.core import Params, filter_params
from saragan_tpu_torch.optim.ema import ema_init, ema_update
from saragan_tpu_torch.optim.factory import Optimizer, make_optimizers_from_config

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}


class TrainState(NamedTuple):
    g_params: Params
    d_params: Params
    g_opt: Any
    d_opt: Any
    ema: Params  # over G+D


class StepMetrics(NamedTuple):
    gen_loss: torch.Tensor
    disc_loss: torch.Tensor
    gp_loss: torch.Tensor
    max_g_norm: torch.Tensor
    max_d_norm: torch.Tensor
    g_norms: Optional[Dict[str, torch.Tensor]] = None
    d_norms: Optional[Dict[str, torch.Tensor]] = None
    fake_min: Optional[torch.Tensor] = None
    fake_max: Optional[torch.Tensor] = None
    real_min: Optional[torch.Tensor] = None
    real_max: Optional[torch.Tensor] = None


def compute_dtype(cfg) -> torch.dtype:
    return _COMPUTE_DTYPES.get(cfg.compute_dtype, torch.float32)


def split_params(params: Params) -> Tuple[Params, Params]:
    return filter_params(params, "generator"), filter_params(params, "discriminator")


def init_train_state(arch, rng: torch.Generator, *, phase: int, cfg,
                     device=None) -> Tuple[TrainState, Tuple[Optimizer, Optimizer]]:
    """Parameters from the port's seeded init on `device` (CUDA unless named), Adam
    state and EMA; returns (state, (g_optimizer, d_optimizer))."""
    params = arch.init(rng, phase=phase, cfg=cfg, device=resolve_device(device))
    g_params, d_params = split_params(params)
    g_optimizer, d_optimizer = make_optimizers_from_config(cfg)
    state = TrainState(g_params, d_params, g_optimizer.init(g_params),
                       d_optimizer.init(d_params), ema_init({**g_params, **d_params}))
    return state, (g_optimizer, d_optimizer)


@torch.no_grad()
def _clip_and_norms(grads: Params, clipping: bool):
    """Optional global-norm-1 clip, then per-variable norms of the (clipped) gradients
    and their maximum."""
    if clipping:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
        scale = torch.clamp(1.0 / (gnorm + 1e-16), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
    norms = {k: torch.linalg.vector_norm(g.reshape(-1)) for k, g in grads.items()}
    return grads, torch.max(torch.stack(list(norms.values()))), norms


@contextlib.contextmanager
def _train_numerics():
    """Deterministic cuDNN, no TF32 in convs or matmuls; restored on exit."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _check_ported(arch, cfg, freeze, frozen_names, grad_histograms):
    todo = []
    if cfg.optim_strategy == "alternate":
        todo.append("optim_strategy='alternate' (queue 1 item 5)")
    elif cfg.optim_strategy != "simultaneous":
        raise ValueError(f"Unknown optim strategy {cfg.optim_strategy}")
    if cfg.remat or cfg.remat_offload:
        todo.append("remat / remat_offload (queue 1 item 10)")
    if freeze and frozen_names:
        todo.append("previous-phase freezing (queue 1 item 5)")
    if grad_histograms:
        todo.append("the gradient-histogram step variant (queue 1 item 5)")
    if int(cfg.gradient_accumulation) > 1:
        todo.append("gradient_accumulation > 1 (queue 1 item 9)")
    if cfg.use_spectral_norm:
        todo.append("spectral norm (queue 1 item 2)")
    if todo:
        raise NotImplementedError("not ported yet (ROADMAP.md): " + "; ".join(todo))


def make_grads_fn(arch, cfg, phase: int, apply_gp: bool = True,
                  static_alpha: Optional[float] = None, *, conv_engine: str = "direct"):
    """The gradient half of the train step:
    ``grads(g_params, d_params, real, draws, alpha) -> ((g_grads, d_grads), LossOutput)``
    with `real` in the compute dtype and the draws given; arguments as for
    ``make_train_step``."""
    lazy_k = max(1, int(cfg.lazy_gp))
    gp_weight = cfg.gp_weight * lazy_k if apply_gp else 0.0
    fused = cfg.loss_fn == "wgan" and cfg.fused_grads

    def grads_fn(g_params: Params, d_params: Params, real: torch.Tensor,
                 draws: losses.Draws, alpha):
        a = torch.tensor(float(alpha)) if static_alpha is None else static_alpha

        def gen_fn(p, z):
            return arch.generator(p, z, a, phase=phase, cfg=cfg, conv_engine=conv_engine)

        def disc_fn(p, x):
            return arch.discriminator(p, x, a, phase=phase, cfg=cfg, conv_engine=conv_engine)

        g_p = {k: v.detach().requires_grad_(True) for k, v in g_params.items()}
        d_p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        common = dict(gp_weight=gp_weight, noise_stddev=cfg.noise_stddev,
                      gp_full_reduction=cfg.gp_full_reduction, compute_gp=apply_gp)
        with _train_numerics():
            if fused:
                return losses.grads_simultaneous(
                    gen_fn, disc_fn, g_p, d_p, real, draws, gp_grad_mode=cfg.gp_grad_mode,
                    batched_passes=cfg.batched_passes,
                    disc_cross_sample=arch.disc_cross_sample, **common)
            out = losses.forward_simultaneous(gen_fn, disc_fn, g_p, d_p, real, draws,
                                              loss_fn=cfg.loss_fn, **common)
            grads = losses.param_grads(out.gen_loss + out.disc_loss, {**g_p, **d_p})
        return (({k: grads[k] for k in g_p}, {k: grads[k] for k in d_p}),
                losses.LossOutput(*(v.detach() for v in out)))

    return grads_fn


def make_train_step(arch, cfg, phase: int, g_optimizer: Optimizer, d_optimizer: Optimizer,
                    frozen_names: FrozenSet[str] = frozenset(), freeze: bool = False,
                    apply_gp: bool = True, grad_histograms: bool = False,
                    static_alpha: Optional[float] = None, *, conv_engine: str = "direct"):
    """The train step for one phase:
    ``step(state, real, rng, alpha, g_lr, d_lr, draws=None) -> (state, StepMetrics)``.

    `rng` is a ``torch.Generator`` on the batch's device that draws the latents, the
    penalty's interpolation weights and the instance noise, unless `draws`
    (``losses.Draws``) hands them in.  `alpha`, `g_lr` and `d_lr` are per-step numbers.

    static_alpha: bind alpha as a Python constant.  With ``static_alpha=0.0`` the models
    skip the phase-transition branches, which contribute exactly 0 in the stabilizing
    half of a phase (their parameters get zero gradients, as in the reference).
    Otherwise alpha goes in as a 0-dim tensor and the branches always run, as the
    reference's traced alpha does.  `conv_engine` is "direct" (cuDNN) or "flat" (the
    hand-written kernels)."""
    _check_ported(arch, cfg, freeze, frozen_names, grad_histograms)
    dtype = compute_dtype(cfg)
    grads_fn = make_grads_fn(arch, cfg, phase, apply_gp, static_alpha,
                             conv_engine=conv_engine)

    def train_step(state: TrainState, real: torch.Tensor, rng: Optional[torch.Generator],
                   alpha, g_lr, d_lr, draws: Optional[losses.Draws] = None):
        real = real.to(dtype)
        if draws is None:
            draws = losses.draw_inputs(rng, real.shape[0], cfg.latent_dim, real.shape[1:],
                                       dtype, real.device, noise_stddev=cfg.noise_stddev,
                                       compute_gp=apply_gp)
        (g_grads, d_grads), out = grads_fn(state.g_params, state.d_params, real, draws, alpha)

        with torch.no_grad():
            g_grads, max_g_norm, g_norms = _clip_and_norms(g_grads, cfg.g_clipping)
            d_grads, max_d_norm, d_norms = _clip_and_norms(d_grads, cfg.d_clipping)
            g_params, g_opt = g_optimizer.update(g_grads, state.g_opt, state.g_params, g_lr)
            d_params, d_opt = d_optimizer.update(d_grads, state.d_opt, state.d_params, d_lr)
            ema = ema_update(state.ema, {**g_params, **d_params}, cfg.ema_beta)
            metrics = StepMetrics(out.gen_loss, out.disc_loss, out.gp_loss, max_g_norm,
                                  max_d_norm, g_norms, d_norms,
                                  torch.min(out.gen_sample), torch.max(out.gen_sample),
                                  torch.min(real[0]), torch.max(real[0]))
        return TrainState(g_params, d_params, g_opt, d_opt, ema), metrics

    return train_step
