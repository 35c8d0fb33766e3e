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

Spatial sharding (``space=``; ``models/common.py``, ``adaptive_space_plan``): the convs at
a sharded resolution are halo convs (the fused transition ``halo_upscale_conv``), the
kernels from the global shape, each layer's noise its slab of the whole volume's draw,
and instance norm's two moments sums over the slab and then the space group
(``common.instance_norm_at``); ``style_mod`` is per (N, C).  The constant enters the slab
where resolution 1 runs sharded; the discriminator is pgan's case.
"""

from __future__ import annotations

import torch

from saragan_tpu_torch.core import Params, Scope, zeros_initializer
from saragan_tpu_torch.models import style_ops
from saragan_tpu_torch.models.common import (adaptive_kernel, adaptive_space_plan,
                                              conv_layer, d_scope, init_from_shape_passes,
                                              instance_norm_at, noise_at, phase_filters,
                                              resolve_base_dim, segment, space_plan_for,
                                              spatial_at, spectral_iters,
                                              static_alpha_zero, to_slab, to_whole,
                                              up_conv_at)
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops

TRUNCATION_PSI = 0.7
TRUNCATION_LAYERS = 8
STYLE_MIXING_PROB = 0.9


def _ones(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype)


def _layer_epilogue(scope, x, dlatent, activation, param, noise, sp=None, res=None):
    """noise, bias, activation, instance norm, style modulation (at resolution `res`)."""
    x = style_ops.maybe_noise(scope, x, noise_at(noise, sp, res), "noise")
    x = ops.act(ops.apply_bias(scope, x), activation, param)
    return ops.style_mod(scope, instance_norm_at(x, sp, res), dlatent, activation, param)


def _synthesis_in(scope, d_z, base_dim, base_shape, activation, param, noise, engine,
                  sp=None):
    c = scope.sub("constant_in")
    const = c.get("input_constant", (1, base_dim, *base_shape[1:]), _ones)
    x = const.to(d_z.dtype).expand(d_z.shape[0], *const.shape[1:])
    kernel = adaptive_kernel(x.shape[2:])
    x = to_slab(sp, x, None, 1)
    x = _layer_epilogue(c, x, d_z[:, 0], activation, param, noise, sp, 1)
    cv = scope.sub("conv")
    x = conv_layer(cv, x, base_dim, kernel, activation, param, engine, sp, 1)
    return _layer_epilogue(cv, x, d_z[:, 1], activation, param, noise, sp, 1)


def _synthesis_block(scope, x, filters_out, d_z, layer_idx, activation, param, noise,
                     fused_transitions, engine, sp=None):
    i = layer_idx
    if fused_transitions:
        c = scope.sub("conv_1")
        kernel = adaptive_kernel([s * 2 for s in spatial_at(x, sp, i - 1)])
        w = ops.get_weight(c, (*kernel, x.shape[1], filters_out), activation, param=param)
        x = up_conv_at(x, w, engine, sp, i, True)
        x = _layer_epilogue(c, x, d_z[:, layer_idx * 2 - 2], activation, param, noise, sp, i)
        layers = (("conv_2", 1),)
    else:
        x = to_slab(sp, ops.upscale(x), i - 1, i)
        layers = (("conv_1", 0), ("conv_2", 1))
    for name, j in layers:
        c = scope.sub(name)
        x = conv_layer(c, x, filters_out, adaptive_kernel(spatial_at(x, sp, i)), activation, param,
                  engine, sp, i)
        x = _layer_epilogue(c, x, d_z[:, layer_idx * 2 - 2 + j], activation, param, noise,
                            sp, i)
    return x


def _g_synthesis(scope, d_z, alpha, phase, cfg, param, noise, engine, sp=None):
    channels = cfg.base_shape[0]
    s = scope.sub("g_synthesis")
    x = _synthesis_in(s.sub("generator_in"), d_z, resolve_base_dim(cfg), cfg.base_shape,
                      cfg.activation, param, noise, engine, sp)
    x_upsample = None
    for layer_idx in range(2, phase + 1):
        if layer_idx == phase and not static_alpha_zero(alpha):
            x_upsample = to_slab(sp, ops.upscale(ops.to_rgb(
                s.sub(f"to_rgb_{phase - 1}"), x, channels, engine=engine)), phase - 1, phase)
        x = _synthesis_block(s.sub(f"generator_block_{layer_idx}"), x,
                             phase_filters(cfg, layer_idx), d_z, layer_idx, cfg.activation,
                             param, noise, cfg.fused_transitions, engine, sp)
    x_out = ops.to_rgb(s.sub(f"to_rgb_{phase}"), x, channels, engine=engine)
    if x_upsample is not None:
        a = torch.as_tensor(alpha, dtype=x_out.dtype)
        x_out = a * x_upsample + (1 - a) * x_out
    return x_out


def _mapping(g, z, phase, cfg, param):
    return style_ops.g_mapping(g, z, phase * 2, act_param=param, activation=cfg.activation)


def _generator(scope, z, alpha, phase, cfg, param, noise, mix, train, engine, space=None):
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
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    return _g_synthesis(g, d_z, alpha, phase, cfg, param, noise, engine, sp)


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: ops.Engine = "direct", noise=None, mix=None,
              train: bool = True, space=None) -> torch.Tensor:
    """G(z) at `phase` with per-layer noise from the source `noise` and, in training from
    phase 2 on, style mixing from `mix` (a ``style_ops.StyleMix``); either None leaves it
    out.  `space`: the output is this rank's slab of each volume."""
    return segment(lambda t: _generator(Scope(params), t, alpha, phase, cfg, cfg.leakiness,
                                        noise, mix, train, conv_engine, space), cfg, z)


def _conv_bias_act(c, x, fmaps, activation, param, engine, sp=None, res=None):
    x = conv_layer(c, x, fmaps, adaptive_kernel(spatial_at(x, sp, res)), activation, param, engine,
              sp, res)
    return ops.act(ops.apply_bias(c, x), activation, param=param)


def _discriminator(scope, x, alpha, phase, cfg, param, engine, space=None):
    activation = cfg.activation
    d = scope.sub("discriminator")
    image = x
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    filters_out = phase_filters(cfg, phase)
    x = ops.from_rgb(d_scope(sp, d.sub(f"from_rgb_{phase}"), phase), x, filters_out,
                     activation, param=param, engine=engine)
    for i in reversed(range(2, phase + 1)):
        b = d.sub(f"discriminator_block_{i}")
        filters_out = phase_filters(cfg, i - 1)
        x = _conv_bias_act(d_scope(sp, b.sub("conv_1"), i), x, phase_filters(cfg, i),
                           activation, param, engine, sp, i)
        x = _conv_bias_act(d_scope(sp, b.sub("conv_2"), i), x, filters_out, activation, param,
                           engine, sp, i)
        x = ops.downscale(to_whole(sp, x, i, i - 1), engine=engine)
        if i == phase and not static_alpha_zero(alpha):
            prev = ops.from_rgb(d_scope(sp, d.sub(f"from_rgb_{phase - 1}"), phase - 1),
                                ops.downscale(to_whole(sp, image, phase, phase - 1), engine=engine),
                                filters_out, activation, param=param, engine=engine)
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x = a * prev + (1 - a) * x
    o = d_scope(sp, d.sub("discriminator_out"), 1)
    x = to_whole(sp, _conv_bias_act(o, x, filters_out, activation, param, engine, sp, 1), 1,
                 None)
    d1 = d_scope(sp, o.sub("dense_1"), None)
    x = ops.act(ops.apply_bias(d1, ops.dense(d1, x, cfg.latent_dim, activation, param=param)),
                activation, param=param)
    d2 = d_scope(sp, o.sub("dense_2"), None)
    return ops.apply_bias(d2, ops.dense(d2, x, 1, activation="linear"))


def discriminator(params: Params, x: torch.Tensor, alpha, *, phase: int, cfg,
                  conv_engine: ops.Engine = "direct", passes: int = 1,
                  mesh=None, space=None) -> torch.Tensor:
    """D(x) at `phase`: (N, C, *spatial) -> (N, 1).  No op mixes samples (`passes`
    and `mesh` change nothing).  `space`: x is this rank's slab of each volume."""
    return segment(lambda t: _discriminator(Scope(params, spectral=spectral_iters(cfg)), t,
                                            alpha, phase, cfg, cfg.leakiness, conv_engine,
                                            space), cfg, x)


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


register(Architecture("stylegan", init, generator, discriminator, adaptive_space_plan,
                      refresh_state=refresh_state))
