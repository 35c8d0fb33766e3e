"""surfgan: the homegrown StyleGAN2 variant the project is named after (counterpart of
``saragan_tpu/models/surfgan.py``).

Residual modulated generator blocks with gain-normalized sums, a residual discriminator
with a minibatch-stddev head and optional projection conditioning, a mapping network
that concatenates the projected conditioning, and the family's own ops that thread the
weight's ``runtime_coef`` (gain / sqrt(fan_in) * lrmul) through bias and noise: biases are
random-normal at init and scaled by the coefficient, the noise strength too.

Style indices as the reference's: num_styles = 4 * phase - 2; residual 4i - 6, conv_1
3i - 5, conv_2 3i - 4, to_rgb 4i - 3 (to_rgb_1 reads style 1).  Style mixing (probability
0.9, no-mix cutoff num_styles) in training from phase 2 on; truncation only when sampling
with a `truncation_psi`.  Noise layers are named ``<conv scope>/apply_noise``.

The discriminator mixes samples (the minibatch-stddev channel, groups of 4 strided over
the batch), so the stacked critic pass tells it how many batches it holds (`passes`) and
the groups form inside each.  ``conv1`` of the head takes F + 1 channels.  Under
``remat_offload`` each network is one recompute region (it has no block taps).

Spatial sharding (``space=``; ``models/common.py``, ``adaptive_space_plan``): the
modulated convs at a sharded resolution are halo convs (``up=True`` through
``common.up_conv_at``); the style scale and the demodulation are per (N, C) / (N, F)
and the 1x1 residuals and RGB heads per voxel, so they stay local; each kernel is
chosen from the global shape; a layer's noise is its slab of the whole volume's draw.
The constant enters this rank's slab where resolution 1 runs sharded, a block's
replicated input where its resolution does (``common.to_slab``).  The discriminator
gathers its slabs before a pool into a replicated resolution and before the head, which
runs replicated (its minibatch-stddev groups over the data axis alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from saragan_tpu_torch.core import Params, Scope, normal_initializer, zeros_initializer
from saragan_tpu_torch.models import style_ops
from saragan_tpu_torch.models.common import (adaptive_kernel, adaptive_space_plan,
                                              conv_layer, d_scope, init_from_shape_passes,
                                              noise_at, phase_filters, resolve_base_dim,
                                              segment, space_plan_for, spatial_at,
                                              spectral_iters, static_alpha_zero, to_slab,
                                              to_whole)
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops

STYLE_MIXING_PROB = 0.9
TRUNCATION_LAYERS = 8


def _num_styles(phase: int) -> int:
    return phase * 4 - 2


def _runtime_coef(shape, activation, lrmul=1.0, param=None) -> float:
    fan_in = int(np.prod(shape[:-1]))
    return ops.calculate_gain(activation, param) / math.sqrt(fan_in) * lrmul


def _apply_bias_rc(scope: Scope, x, runtime_coef: float):
    """Random-normal bias scaled by runtime_coef."""
    b = (scope.get("bias", (x.shape[1],), normal_initializer(1.0)) * runtime_coef).to(x.dtype)
    if x.ndim == 2:
        return x + b
    return x + b.reshape((1, -1) + (1,) * (x.ndim - 2))


def _apply_noise_rc(scope: Scope, x, noise, runtime_coef: float):
    """Noise under the scope's own name, its strength scaled by runtime_coef."""
    strength = scope.get("noise_strength", (), zeros_initializer())
    if noise is None:
        return x
    n = noise(scope.prefix, (x.shape[0], 1, *x.shape[2:]), x.dtype, x.device)
    return x + n * (strength * runtime_coef).to(x.dtype)


def _dense_rc(scope: Scope, x, fmaps, activation, lrmul=1.0, param=None):
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    rc = _runtime_coef((x.shape[1], fmaps), activation, lrmul, param)
    return ops.dense(scope, x, fmaps, activation, lrmul=lrmul, param=param), rc


def _conv_rc(scope: Scope, x, fmaps, kernel, activation, param, engine, sp=None, res=None):
    rc = _runtime_coef((*kernel, x.shape[1], fmaps), activation, 1.0, param)
    return conv_layer(scope, x, fmaps, kernel, activation, param, engine, sp, res), rc


def _modulated_conv_rc(scope, x, z, fmaps, kernel, activation, up=False, demodulate=True,
                       param=None, fused_transitions=False, engine="direct", sp=None,
                       res=None):
    """The stylegan2 modulated conv with surfgan's runtime-coefficient bias in the
    modulation dense (its output at resolution `res`); returns (y, the conv weight's
    runtime_coef)."""
    kernel = tuple(int(k) for k in kernel)
    w = ops.get_weight(scope, (*kernel, x.shape[1], fmaps), activation, param=param)
    rc = _runtime_coef((*kernel, x.shape[1], fmaps), activation, 1.0, param)
    mod = scope.sub("modulate")
    s, rc_dense = _dense_rc(mod, z, x.shape[1], activation, param=param)
    s = ops.act(_apply_bias_rc(mod, s, rc_dense) + 1, activation, param)
    return style_ops.modulate(x, w, s, up=up, demodulate=demodulate,
                              fused_transitions=fused_transitions, engine=engine, sp=sp,
                              res=res), rc


def _to_rgb_mod(scope, x, z, channels, engine):
    x, rc = _modulated_conv_rc(scope, x, z, channels, (1,) * (x.ndim - 2), "linear",
                               demodulate=False, engine=engine)
    return _apply_bias_rc(scope, x, rc)


def _from_rgb(scope, x, filters_out, activation, param, engine):
    x, rc = _conv_rc(scope, x, filters_out, (1,) * (x.ndim - 2), activation, param, engine)
    return ops.act(_apply_bias_rc(scope, x, rc), activation, param=param)


def _g_mapping(scope, z, num_styles, activation, act_param, conditioning, mapping_layers=8,
               mapping_lrmul=0.01):
    """z (with the projected conditioning concatenated) -> (N, num_styles, width)."""
    m = scope.sub("g_mapping")
    mapping_fmaps = z.shape[1]
    if conditioning is not None:
        c = m.sub("conditioning")
        w = c.get("weight", (conditioning.shape[1], z.shape[1]), normal_initializer(1.0))
        z = torch.cat([z, torch.matmul(conditioning.to(z.dtype), w.to(z.dtype))], dim=1)
    x = style_ops.normalize_latents(z)
    latent_fmaps = z.shape[1]
    for layer_idx in range(mapping_layers):
        fmaps = latent_fmaps if layer_idx == mapping_layers - 1 else mapping_fmaps
        d = m.sub(f"dense_{layer_idx}")
        x, rc = _dense_rc(d, x, fmaps, activation, lrmul=mapping_lrmul, param=act_param)
        x = ops.act(_apply_bias_rc(d, x, rc), activation, param=act_param)
    return x[:, None].expand(-1, num_styles, -1)


def _conv_epilogue(scope, x, rc, activation, param, noise):
    """noise (under ``<scope>/apply_noise``), bias and activation of a synthesis conv."""
    x = _apply_noise_rc(scope.sub("apply_noise"), x, noise, rc)
    return ops.act(_apply_bias_rc(scope, x, rc), activation, param)


def _synthesis_in(scope, d_z, base_dim, base_shape, activation, param, noise, engine,
                  sp=None):
    c = scope.sub("constant_in")
    const = c.get("input_constant", (1, base_dim, *base_shape[1:]), normal_initializer(1.0))
    x = const.to(d_z.dtype).expand(d_z.shape[0], *const.shape[1:])
    kernel = adaptive_kernel(x.shape[2:])
    x = to_slab(sp, x, None, 1)
    cv = scope.sub("conv")
    x, rc = _modulated_conv_rc(cv, x, d_z[:, 0], base_dim, kernel, activation, param=param,
                               engine=engine, sp=sp, res=1)
    return _conv_epilogue(cv, x, rc, activation, param, noise_at(noise, sp, 1))


def _synthesis_block(scope, x, filters_out, d_z, layer_idx, activation, param, noise,
                     fused_transitions, engine, sp=None):
    i = layer_idx
    t, _ = _modulated_conv_rc(scope.sub("residual"), x, d_z[:, layer_idx * 4 - 6], filters_out,
                              (1,) * (x.ndim - 2), activation, up=True, param=param,
                              fused_transitions=fused_transitions, engine=engine, sp=sp, res=i)
    c1 = scope.sub("conv_1")
    # the kernel fits the dims before the upscale, as the reference reads them
    x, rc = _modulated_conv_rc(c1, x, d_z[:, layer_idx * 3 - 5], filters_out,
                               adaptive_kernel(spatial_at(x, sp, i - 1)), activation, up=True,
                               param=param, fused_transitions=fused_transitions, engine=engine,
                               sp=sp, res=i)
    noise = noise_at(noise, sp, i)
    x = _conv_epilogue(c1, x, rc, activation, param, noise)
    c2 = scope.sub("conv_2")
    x, rc = _modulated_conv_rc(c2, x, d_z[:, layer_idx * 3 - 4], filters_out,
                               adaptive_kernel(spatial_at(x, sp, i)), activation, param=param,
                               engine=engine, sp=sp, res=i)
    x = _conv_epilogue(c2, x, rc, activation, param, noise)
    return (x + t) * ops.in_dtype(1.0 / ops.calculate_gain(activation, param), x.dtype)


def _g_synthesis(scope, d_z, alpha, phase, cfg, param, noise, engine, sp=None):
    channels = cfg.base_shape[0]
    s = scope.sub("g_synthesis")
    x = _synthesis_in(s.sub("generator_in"), d_z, resolve_base_dim(cfg), cfg.base_shape,
                      cfg.activation, param, noise, engine, sp)
    x_out = _to_rgb_mod(s.sub("to_rgb_1"), x, d_z[:, 1], channels, engine)
    for layer_idx in range(2, phase + 1):
        x = _synthesis_block(s.sub(f"generator_block_{layer_idx}"), x,
                             phase_filters(cfg, layer_idx), d_z, layer_idx, cfg.activation,
                             param, noise, cfg.fused_transitions, engine, sp)
        rgb = _to_rgb_mod(s.sub(f"to_rgb_{layer_idx}"), x, d_z[:, layer_idx * 4 - 3],
                          channels, engine)
        up = to_slab(sp, ops.upscale(x_out), layer_idx - 1, layer_idx)
        if layer_idx == phase and not static_alpha_zero(alpha):
            a = torch.as_tensor(alpha, dtype=x_out.dtype)
            x_out = (1 - a) * rgb + up
        else:
            x_out = rgb + up
    return x_out


def _generator(scope, z, alpha, phase, cfg, param, noise, mix, train, conditioning,
               truncation_psi, engine, space=None):
    g = scope.sub("generator")
    num_styles = _num_styles(phase)
    d_z = _g_mapping(g, z, num_styles, cfg.activation, param, conditioning)
    d_z_avg = g.get("d_z_avg", (d_z.shape[-1],), zeros_initializer())
    if train and phase > 1 and mix is not None:
        d_z_reg = _g_mapping(g, mix.z.to(z.dtype), num_styles, cfg.activation, param,
                             conditioning)
        d_z = style_ops.style_mixing(d_z, d_z_reg, mix, num_styles, STYLE_MIXING_PROB)
    if not train and truncation_psi is not None:
        d_z = style_ops.apply_truncation(d_z, d_z_avg, num_styles, truncation_psi,
                                         TRUNCATION_LAYERS)
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    return _g_synthesis(g, d_z, alpha, phase, cfg, param, noise, engine, sp)


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: ops.Engine = "direct", noise=None, mix=None, train: bool = True,
              conditioning=None, truncation_psi=None, space=None) -> torch.Tensor:
    """G(z) at `phase` with per-layer noise from `noise`, style mixing in training from
    `mix`, the projection `conditioning` (N, num_labels) concatenated in the mapping, and
    `truncation_psi` when sampling.  `space` (a mesh with a space axis): the output is
    this rank's slab of each volume."""
    return segment(lambda t: _generator(Scope(params), t, alpha, phase, cfg, cfg.leakiness,
                                        noise, mix, train, conditioning, truncation_psi,
                                        conv_engine, space), cfg, z)


def _discriminator_block(scope, x, filters_in, filters_out, activation, param, engine,
                         sp=None, i=None):
    """Block at resolution `i` (its residual pooled into `i` - 1 first)."""
    t, _ = _conv_rc(d_scope(sp, scope.sub("residual"), i - 1),
                    ops.downscale(to_whole(sp, x, i, i - 1), engine=engine), filters_out,
                    (1,) * (x.ndim - 2), activation, param, engine)
    c1 = d_scope(sp, scope.sub("conv_1"), i)
    kernel = adaptive_kernel(spatial_at(x, sp, i))
    x, rc = _conv_rc(c1, x, filters_in, kernel, activation, param, engine, sp, i)
    x = ops.act(_apply_bias_rc(c1, x, rc), activation, param=param)
    c2 = d_scope(sp, scope.sub("conv_2"), i)
    x, rc = _conv_rc(c2, x, filters_out, kernel, activation, param, engine, sp, i)
    x = ops.act(_apply_bias_rc(c2, x, rc), activation, param=param)
    x = ops.downscale(to_whole(sp, x, i, i - 1), engine=engine)
    return (x + t) * ops.in_dtype(1.0 / ops.calculate_gain(activation, param), x.dtype)


def _discriminator_out(scope, x, latent_dim, filters_out, activation, param, conditioning,
                       passes, engine, mesh=None, sp=None):
    """The head, replicated under spatial sharding (gathered first)."""
    o = d_scope(sp, scope.sub("discriminator_out"), None)
    x = ops.minibatch_stddev_layer(to_whole(sp, x, 1, None), passes=passes, mesh=mesh)
    c = o.sub("conv1")
    x, rc = _conv_rc(c, x, filters_out, adaptive_kernel(x.shape[2:]), activation, param,
                     engine)
    x = ops.act(_apply_bias_rc(c, x, rc), activation, param=param)
    d1 = o.sub("dense1")
    x, rc = _dense_rc(d1, x, latent_dim, activation, param=param)
    x = ops.act(_apply_bias_rc(d1, x, rc), activation, param=param)
    d2 = o.sub("dense2")
    x, rc = _dense_rc(d2, x, 1, "linear")
    x = _apply_bias_rc(d2, x, rc)
    if conditioning is not None:
        x = torch.sum(x * conditioning.to(x.dtype), dim=1, keepdim=True)
    return x


def _discriminator(scope, x, alpha, phase, cfg, param, conditioning, passes, engine,
                   mesh=None, space=None):
    activation = cfg.activation
    d = scope.sub("discriminator")
    image = x
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    filters_out = phase_filters(cfg, phase)
    x = _from_rgb(d_scope(sp, d.sub(f"from_rgb_{phase}"), phase), x, filters_out, activation,
                  param, engine)
    for i in reversed(range(2, phase + 1)):
        filters_out = phase_filters(cfg, i - 1)
        x = _discriminator_block(d.sub(f"discriminator_block_{i}"), x, phase_filters(cfg, i),
                                 filters_out, activation, param, engine, sp, i)
        if i == phase and not static_alpha_zero(alpha):
            prev = _from_rgb(d_scope(sp, d.sub(f"from_rgb_{phase - 1}"), phase - 1),
                             ops.downscale(to_whole(sp, image, phase, phase - 1), engine=engine),
                             filters_out, activation, param, engine)
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x = a * prev + (1 - a) * x
    return _discriminator_out(d, x, cfg.latent_dim, filters_out, activation, param,
                              conditioning, passes, engine, mesh, sp)


def discriminator(params: Params, x: torch.Tensor, alpha, *, phase: int, cfg,
                  conv_engine: ops.Engine = "direct", passes: int = 1,
                  conditioning=None, mesh=None, space=None) -> torch.Tensor:
    """D(x) at `phase`: (N, C, *spatial) -> (N, 1), the minibatch-stddev groups formed
    inside each of the `passes` batches x stacks (over each pass's global batch under a
    data-parallel `mesh`); with `conditioning` the projection score.  `space`: x is this
    rank's slab of each volume; the scores are the whole volumes'."""
    return segment(lambda t: _discriminator(Scope(params, spectral=spectral_iters(cfg)), t,
                                            alpha, phase, cfg, cfg.leakiness, conditioning,
                                            passes, conv_engine, mesh, space), cfg, x)


def init(rng: torch.Generator, *, phase: int, cfg, device) -> Params:
    """The full G+D parameters for `phase` (the reference's names and shapes), with the
    mapping's conditioning weight when ``cfg.num_labels``."""
    cond = torch.zeros((1, cfg.num_labels), device="meta") if cfg.num_labels else None
    return init_from_shape_passes(
        lambda s, z: _generator(s, z, 1.0, phase, cfg, cfg.leakiness, None, None, True, cond,
                                None, "direct"),
        lambda s, x: _discriminator(s, x, 1.0, phase, cfg, cfg.leakiness, cond, 1, "direct"),
        rng, phase=phase, cfg=cfg, device=device)


@torch.no_grad()
def refresh_state(g_params: Params, z: torch.Tensor, *, phase: int, cfg) -> Params:
    """The w-average moved toward the first style of the mapped latents `z` (no
    conditioning: it tracks the marginal w), beta 0.995."""
    d_z = _g_mapping(Scope(g_params).sub("generator"), z, _num_styles(phase), cfg.activation,
                     cfg.leakiness, None)
    return style_ops.update_dlatent_avg(g_params, "generator", d_z[:, 0])


register(Architecture("surfgan", init, generator, discriminator, adaptive_space_plan,
                      refresh_state=refresh_state))
