"""stylegan2 (3-D) (counterpart of ``saragan_tpu/models/stylegan2.py``).

Modulated convs (``style_ops.modulated_conv``: activations scaled by the style,
demodulated after), a skip-sum to_rgb chain with 3 * phase - 2 styles, a residual
discriminator with gain-normalized sums and no alpha path: stylegan2 trains one phase
(``Config.finalize`` refuses starting_phase != ending_phase, as the reference).  The
mapping's hidden layers are 512 wide, the last latent-sized, with the mapping lrmul on
the biases.  Style mixing (probability 0.9, no-mix cutoff num_styles) from phase 1 on;
truncation only when sampling (``train=False``) with a `truncation_psi`.
``refresh_state`` moves the w-average once per train step.  Under ``remat_offload``
each network is one recompute region (it has no block taps).

Spatial sharding (``space=``; ``models/common.py``, ``adaptive_space_plan``): the modulated
convs at a sharded resolution are halo convs (``style_ops.modulate`` with the plan; the
style and the demodulation, per (N, C) and (N, F), stay local), the kernels from the
global shape, each layer's noise its slab of the whole volume's draw; the to_rgb chain's
upscaled sum enters the slab where the resolution turns sharded.  The discriminator's
residual and main paths gather before a pool into a replicated resolution, and before the
head.
"""

from __future__ import annotations

import torch

from saragan_tpu_torch.core import Params, Scope, normal_initializer, zeros_initializer
from saragan_tpu_torch.models import style_ops
from saragan_tpu_torch.models.common import (adaptive_kernel, adaptive_space_plan,
                                              conv_layer, d_scope, init_from_shape_passes,
                                              noise_at, phase_filters, resolve_base_dim,
                                              segment, space_plan_for, spatial_at,
                                              spectral_iters, to_slab, to_whole)
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops

STYLE_MIXING_PROB = 0.9
TRUNCATION_LAYERS = 8


def _num_styles(phase: int) -> int:
    return phase * 3 - 2


def _epilogue(scope, x, activation, param, noise):
    x = style_ops.maybe_noise(scope, x, noise, "noise")
    return ops.act(ops.apply_bias(scope, x), activation, param)


def _synthesis_in(scope, d_z, base_dim, base_shape, activation, param, noise, engine,
                  sp=None):
    c = scope.sub("constant_in")
    const = c.get("input_constant", (1, base_dim, *base_shape[1:]), normal_initializer(1.0))
    x = const.to(d_z.dtype).expand(d_z.shape[0], *const.shape[1:])
    kernel = adaptive_kernel(x.shape[2:])
    x = to_slab(sp, x, None, 1)
    cv = scope.sub("conv")
    x = style_ops.modulated_conv(cv, x, d_z[:, 0], base_dim, kernel, activation, param=param,
                                 engine=engine, sp=sp, res=1)
    return _epilogue(cv, x, activation, param, noise_at(noise, sp, 1))


def _synthesis_block(scope, x, filters_out, d_z, layer_idx, activation, param, noise,
                     fused_transitions, engine, sp=None):
    i = layer_idx
    c1 = scope.sub("conv_1")
    # the kernel fits the dims before the upscale, as the reference reads them
    x = style_ops.modulated_conv(c1, x, d_z[:, layer_idx * 3 - 5], filters_out,
                                 adaptive_kernel(spatial_at(x, sp, i - 1)), activation,
                                 up=True, param=param, fused_transitions=fused_transitions,
                                 engine=engine, sp=sp, res=i)
    noise = noise_at(noise, sp, i)
    x = _epilogue(c1, x, activation, param, noise)
    c2 = scope.sub("conv_2")
    x = style_ops.modulated_conv(c2, x, d_z[:, layer_idx * 3 - 4], filters_out,
                                 adaptive_kernel(spatial_at(x, sp, i)), activation,
                                 param=param, engine=engine, sp=sp, res=i)
    return _epilogue(c2, x, activation, param, noise)


def _g_synthesis(scope, d_z, phase, cfg, param, noise, engine, sp=None):
    channels = cfg.base_shape[0]
    s = scope.sub("g_synthesis")
    x = _synthesis_in(s.sub("generator_in"), d_z, resolve_base_dim(cfg), cfg.base_shape,
                      cfg.activation, param, noise, engine, sp)
    x_out = style_ops.to_rgb_mod(s.sub("to_rgb_1"), x, d_z[:, 0], channels, engine=engine)
    for layer_idx in range(2, phase + 1):
        x = _synthesis_block(s.sub(f"generator_block_{layer_idx}"), x,
                             phase_filters(cfg, layer_idx), d_z, layer_idx, cfg.activation,
                             param, noise, cfg.fused_transitions, engine, sp)
        rgb = style_ops.to_rgb_mod(s.sub(f"to_rgb_{layer_idx}"), x, d_z[:, layer_idx * 3 - 3],
                                   channels, engine=engine)
        x_out = rgb + to_slab(sp, ops.upscale(x_out), layer_idx - 1, layer_idx)
    return x_out


def _mapping(g, z, phase, cfg, param):
    return style_ops.g_mapping(g, z, _num_styles(phase), activation=cfg.activation,
                               act_param=param, mapping_fmaps=512, last_layer_latent=True,
                               bias_lrmul=0.01)


def _generator(scope, z, phase, cfg, param, noise, mix, train, truncation_psi, engine,
               space=None):
    g = scope.sub("generator")
    num_styles = _num_styles(phase)
    d_z_avg = g.get("d_z_avg", (z.shape[1],), zeros_initializer())
    d_z = _mapping(g, z, phase, cfg, param)
    if train and mix is not None:
        d_z = style_ops.style_mixing(d_z, _mapping(g, mix.z.to(z.dtype), phase, cfg, param),
                                     mix, num_styles, STYLE_MIXING_PROB)
    if not train and truncation_psi is not None:
        d_z = style_ops.apply_truncation(d_z, d_z_avg, num_styles, truncation_psi,
                                         TRUNCATION_LAYERS)
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    return _g_synthesis(g, d_z, phase, cfg, param, noise, engine, sp)


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: ops.Engine = "direct", noise=None, mix=None, train: bool = True,
              truncation_psi=None, space=None) -> torch.Tensor:
    """G(z) at `phase` (alpha is not read: no progressive growing), with per-layer noise
    from `noise` and, in training, style mixing from `mix`; `truncation_psi` applies
    when sampling.  `space`: the output is this rank's slab of each volume."""
    return segment(lambda t: _generator(Scope(params), t, phase, cfg, cfg.leakiness, noise,
                                        mix, train, truncation_psi, conv_engine, space),
                   cfg, z)


def _conv_bias_act(c, x, fmaps, activation, param, engine, sp=None, res=None):
    x = conv_layer(c, x, fmaps, adaptive_kernel(spatial_at(x, sp, res)), activation, param,
                   engine, sp, res)
    return ops.act(ops.apply_bias(c, x), activation, param=param)


def _discriminator_block(scope, x, filters_in, filters_out, activation, param, engine,
                         sp=None, i=None):
    """Block at resolution `i`: both paths pool into `i` - 1 (gathered first where that
    is replicated)."""
    t = ops.conv(d_scope(sp, scope.sub("residual"), i), x, filters_out, (1,) * (x.ndim - 2),
                 activation, param=param, engine=engine)
    t = ops.downscale(to_whole(sp, t, i, i - 1), engine=engine)
    x = _conv_bias_act(d_scope(sp, scope.sub("conv_1"), i), x, filters_in, activation, param,
                       engine, sp, i)
    x = _conv_bias_act(d_scope(sp, scope.sub("conv_2"), i), x, filters_out, activation, param,
                       engine, sp, i)
    x = ops.downscale(to_whole(sp, x, i, i - 1), engine=engine)
    gain = ops.calculate_gain(activation, param)
    return (x + t) * ops.in_dtype(1.0 / gain, x.dtype)


def _discriminator(scope, x, phase, cfg, param, engine, space=None):
    activation = cfg.activation
    d = scope.sub("discriminator")
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    filters_out = phase_filters(cfg, phase)
    x = ops.from_rgb(d_scope(sp, d.sub(f"from_rgb_{phase}"), phase), x, filters_out,
                     activation, param=param, engine=engine)
    for i in reversed(range(2, phase + 1)):
        filters_out = phase_filters(cfg, i - 1)
        x = _discriminator_block(d.sub(f"discriminator_block_{i}"), x, phase_filters(cfg, i),
                                 filters_out, activation, param, engine, sp, i)
    o = d.sub("discriminator_out")
    x = _conv_bias_act(d_scope(sp, o.sub("conv"), 1), x, filters_out, activation, param,
                       engine, sp, 1)
    x = to_whole(sp, x, 1, None)
    d1 = d_scope(sp, o.sub("dense_1"), None)
    x = ops.act(ops.apply_bias(d1, ops.dense(d1, x, cfg.latent_dim, activation, param=param)),
                activation, param=param)
    d2 = d_scope(sp, o.sub("dense"), None)
    return ops.apply_bias(d2, ops.dense(d2, x, 1, activation="linear"))


def discriminator(params: Params, x: torch.Tensor, alpha, *, phase: int, cfg,
                  conv_engine: ops.Engine = "direct", passes: int = 1,
                  mesh=None, space=None) -> torch.Tensor:
    """D(x) at `phase`: (N, C, *spatial) -> (N, 1); alpha is not read.  No op mixes
    samples (`passes` and `mesh` change nothing).  `space`: x is this rank's slab of each
    volume."""
    return segment(lambda t: _discriminator(Scope(params, spectral=spectral_iters(cfg)), t,
                                            phase, cfg, cfg.leakiness, conv_engine, space),
                   cfg, x)


def init(rng: torch.Generator, *, phase: int, cfg, device) -> Params:
    """The full G+D parameters for `phase` (the reference's names and shapes)."""
    return init_from_shape_passes(
        lambda s, z: _generator(s, z, phase, cfg, cfg.leakiness, None, None, True, None,
                                "direct"),
        lambda s, x: _discriminator(s, x, phase, cfg, cfg.leakiness, "direct"),
        rng, phase=phase, cfg=cfg, device=device)


@torch.no_grad()
def refresh_state(g_params: Params, z: torch.Tensor, *, phase: int, cfg) -> Params:
    """The w-average moved toward the first style of the mapped latents `z`, beta 0.995."""
    d_z = _mapping(Scope(g_params).sub("generator"), z, phase, cfg, cfg.leakiness)
    return style_ops.update_dlatent_avg(g_params, "generator", d_z[:, 0])


register(Architecture("stylegan2", init, generator, discriminator, adaptive_space_plan,
                      refresh_state=refresh_state))
