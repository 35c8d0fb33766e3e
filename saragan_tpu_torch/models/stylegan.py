"""stylegan (3-D): the StyleGAN v1 member (counterpart of
``saragan_tpu/models/stylegan.py``).

An 8-layer z -> w mapping (lrmul 0.01, latent-sized layers) broadcast to 2 * phase
styles; synthesis from a learned ones-constant, each layer noise + bias + activation +
instance norm + AdaIN ``style_mod``; style mixing with probability 0.9 whose no-mix
cutoff is `phase` (styles >= phase always come from the second pass); truncation with
psi 0.7 on the first 8 styles, applied in training too, as the reference does.  The
discriminator is pgan-style blocks sized by the num_filters tables.

``generator/d_z_avg`` (the w-average) takes no gradient; ``refresh_state`` moves it once
per train step from 64 latents, as the reference's ``refresh_state``.  Under
``remat_offload`` each network is one recompute region (it has no block taps).
"""

from __future__ import annotations

import torch

from saragan_tpu_torch.core import Params, Scope, zeros_initializer
from saragan_tpu_torch.models import style_ops
from saragan_tpu_torch.models.common import (adaptive_kernel, init_from_shape_passes,
                                              phase_filters, resolve_base_dim, segment,
                                              spectral_iters, static_alpha_zero)
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops

TRUNCATION_PSI = 0.7
TRUNCATION_LAYERS = 8
STYLE_MIXING_PROB = 0.9


def _ones(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype)


def _layer_epilogue(scope, x, dlatent, activation, param, noise):
    """noise, bias, activation, instance norm, style modulation."""
    x = style_ops.maybe_noise(scope, x, noise, "noise")
    x = ops.act(ops.apply_bias(scope, x), activation, param)
    return ops.style_mod(scope, ops.instance_norm(x), dlatent, activation, param)


def _synthesis_in(scope, d_z, base_dim, base_shape, activation, param, noise, engine):
    c = scope.sub("constant_in")
    const = c.get("input_constant", (1, base_dim, *base_shape[1:]), _ones)
    x = const.to(d_z.dtype).expand(d_z.shape[0], *const.shape[1:])
    x = _layer_epilogue(c, x, d_z[:, 0], activation, param, noise)
    cv = scope.sub("conv")
    x = ops.conv(cv, x, base_dim, adaptive_kernel(x.shape[2:]), activation, param,
                 engine=engine)
    return _layer_epilogue(cv, x, d_z[:, 1], activation, param, noise)


def _synthesis_block(scope, x, filters_out, d_z, layer_idx, activation, param, noise,
                     fused_transitions, engine):
    if fused_transitions:
        c = scope.sub("conv_1")
        kernel = adaptive_kernel([s * 2 for s in x.shape[2:]])
        w = ops.get_weight(c, (*kernel, x.shape[1], filters_out), activation, param=param)
        x = ops.upscale_conv(x, w.to(x.dtype))
        x = _layer_epilogue(c, x, d_z[:, layer_idx * 2 - 2], activation, param, noise)
        layers = (("conv_2", 1),)
    else:
        x = ops.upscale(x)
        layers = (("conv_1", 0), ("conv_2", 1))
    for name, j in layers:
        c = scope.sub(name)
        x = ops.conv(c, x, filters_out, adaptive_kernel(x.shape[2:]), activation, param,
                     engine=engine)
        x = _layer_epilogue(c, x, d_z[:, layer_idx * 2 - 2 + j], activation, param, noise)
    return x


def _g_synthesis(scope, d_z, alpha, phase, cfg, param, noise, engine):
    channels = cfg.base_shape[0]
    s = scope.sub("g_synthesis")
    x = _synthesis_in(s.sub("generator_in"), d_z, resolve_base_dim(cfg), cfg.base_shape,
                      cfg.activation, param, noise, engine)
    x_upsample = None
    for layer_idx in range(2, phase + 1):
        if layer_idx == phase and not static_alpha_zero(alpha):
            x_upsample = ops.upscale(ops.to_rgb(s.sub(f"to_rgb_{phase - 1}"), x, channels,
                                                engine=engine))
        x = _synthesis_block(s.sub(f"generator_block_{layer_idx}"), x,
                             phase_filters(cfg, layer_idx), d_z, layer_idx, cfg.activation,
                             param, noise, cfg.fused_transitions, engine)
    x_out = ops.to_rgb(s.sub(f"to_rgb_{phase}"), x, channels, engine=engine)
    if x_upsample is not None:
        a = torch.as_tensor(alpha, dtype=x_out.dtype)
        x_out = a * x_upsample + (1 - a) * x_out
    return x_out


def _mapping(g, z, phase, cfg, param):
    return style_ops.g_mapping(g, z, phase * 2, act_param=param, activation=cfg.activation)


def _generator(scope, z, alpha, phase, cfg, param, noise, mix, train, engine):
    g = scope.sub("generator")
    num_styles = phase * 2
    d_z_avg = g.get("d_z_avg", (z.shape[1],), zeros_initializer())
    d_z = _mapping(g, z, phase, cfg, param)
    if train and phase > 1 and mix is not None:
        d_z_reg = _mapping(g, mix.z.to(z.dtype), phase, cfg, param)
        d_z = style_ops.style_mixing(d_z, d_z_reg, mix, num_styles, STYLE_MIXING_PROB,
                                     no_mix_cutoff=phase)
    d_z = style_ops.apply_truncation(d_z, d_z_avg, num_styles, TRUNCATION_PSI,
                                     TRUNCATION_LAYERS)
    return _g_synthesis(g, d_z, alpha, phase, cfg, param, noise, engine)


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: str = "direct", noise=None, mix=None,
              train: bool = True) -> torch.Tensor:
    """G(z) at `phase` with per-layer noise from the source `noise` and, in training from
    phase 2 on, style mixing from `mix` (a ``style_ops.StyleMix``); either None leaves it
    out."""
    return segment(lambda t: _generator(Scope(params), t, alpha, phase, cfg, cfg.leakiness,
                                        noise, mix, train, conv_engine), cfg, z)


def _conv_bias_act(c, x, fmaps, activation, param, engine):
    x = ops.conv(c, x, fmaps, adaptive_kernel(x.shape[2:]), activation, param=param,
                 engine=engine)
    return ops.act(ops.apply_bias(c, x), activation, param=param)


def _discriminator(scope, x, alpha, phase, cfg, param, engine):
    activation = cfg.activation
    d = scope.sub("discriminator")
    image = x
    filters_out = phase_filters(cfg, phase)
    x = ops.from_rgb(d.sub(f"from_rgb_{phase}"), x, filters_out, activation, param=param,
                     engine=engine)
    for i in reversed(range(2, phase + 1)):
        b = d.sub(f"discriminator_block_{i}")
        filters_out = phase_filters(cfg, i - 1)
        x = _conv_bias_act(b.sub("conv_1"), x, phase_filters(cfg, i), activation, param,
                           engine)
        x = ops.downscale(_conv_bias_act(b.sub("conv_2"), x, filters_out, activation, param,
                                         engine))
        if i == phase and not static_alpha_zero(alpha):
            prev = ops.from_rgb(d.sub(f"from_rgb_{phase - 1}"), ops.downscale(image),
                                filters_out, activation, param=param, engine=engine)
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x = a * prev + (1 - a) * x
    o = d.sub("discriminator_out")
    x = _conv_bias_act(o, x, filters_out, activation, param, engine)
    d1 = o.sub("dense_1")
    x = ops.act(ops.apply_bias(d1, ops.dense(d1, x, cfg.latent_dim, activation, param=param)),
                activation, param=param)
    d2 = o.sub("dense_2")
    return ops.apply_bias(d2, ops.dense(d2, x, 1, activation="linear"))


def discriminator(params: Params, x: torch.Tensor, alpha, *, phase: int, cfg,
                  conv_engine: str = "direct", passes: int = 1) -> torch.Tensor:
    """D(x) at `phase`: (N, C, *spatial) -> (N, 1).  No op mixes samples (`passes`
    changes nothing)."""
    return segment(lambda t: _discriminator(Scope(params, spectral=spectral_iters(cfg)), t,
                                            alpha, phase, cfg, cfg.leakiness, conv_engine),
                   cfg, x)


def init(rng: torch.Generator, *, phase: int, cfg, device) -> Params:
    """The full G+D parameters for `phase` (the reference's names and shapes)."""
    return init_from_shape_passes(
        lambda s, z: _generator(s, z, 1.0, phase, cfg, cfg.leakiness, None, None, True,
                                "direct"),
        lambda s, x: _discriminator(s, x, 1.0, phase, cfg, cfg.leakiness, "direct"),
        rng, phase=phase, cfg=cfg, device=device)


@torch.no_grad()
def refresh_state(g_params: Params, z: torch.Tensor, *, phase: int, cfg) -> Params:
    """The w-average moved toward the first style of the mapped latents `z` (the
    reference draws 64), beta 0.995 (reference ``refresh_state``)."""
    d_z = _mapping(Scope(g_params).sub("generator"), z, phase, cfg, cfg.leakiness)
    return style_ops.update_dlatent_avg(g_params, "generator", d_z[:, 0])


register(Architecture("stylegan", init, generator, discriminator, refresh_state=refresh_state))
