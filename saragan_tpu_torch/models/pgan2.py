"""pgan2: progressive growing with residual blocks and a skip-sum to_rgb chain
(counterpart of ``saragan_tpu/models/pgan2.py``).

Generator blocks add a 1x1-conv residual of the upscaled input, gain-normalized,
``(x + t) / gain``; every level's RGB is upscaled and summed, the top level weighted by
(1 - alpha) during mixing.  The discriminator mirrors it with pooled 1x1 residuals.
Filters come from the num_filters tables (``models/common.py``), kernels shrink to 1 on
spatial axes shorter than 3.  Bias, activation and pixel norm stay separate ops, as in
the reference (no fused kernel).  Under ``remat_offload`` each network is one recompute
region (it has no block taps), as the reference's offload policy finds no names in it.

Spatial sharding (``space=``; ``models/common.py``, ``adaptive_space_plan``): the SAME convs
at a sharded resolution are halo convs, the fused transition ``halo_upscale_conv``; the
1x1 residuals, RGB heads, upscales, pools and pixel norm are local (a sharded slab's depth
is even wherever it pools into a sharded resolution); the kernels come from the global
shape.  Crossings as pgan's: the generator enters the slab where a resolution turns
sharded, the discriminator gathers before a pool into a replicated resolution and before
its head.
"""

from __future__ import annotations

import numpy as np
import torch

from saragan_tpu_torch.core import Params, Scope
from saragan_tpu_torch.models.common import (adaptive_kernel, adaptive_space_plan,
                                              conv_layer, d_scope, init_from_shape_passes,
                                              phase_filters, resolve_base_dim, segment,
                                              space_plan_for, spatial_at, spectral_iters,
                                              static_alpha_zero, to_slab, to_whole,
                                              up_conv_at)
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops


def _bias_act(scope, x, activation, param):
    return ops.act(ops.apply_bias(scope, x), activation, param=param)


def _residual_sum(x, t, activation, param):
    return (x + t) * ops.in_dtype(1.0 / ops.calculate_gain(activation, param), x.dtype)


def _generator_in(scope, x, filters, shape, activation, param, engine, sp=None):
    d = scope.sub("dense")
    x = ops.dense(d, x, int(np.prod(shape)) * filters, activation, param=param)
    x = _bias_act(d, x, activation, param).reshape((-1, filters, *shape))
    kernel = adaptive_kernel(x.shape[2:])
    x = to_slab(sp, x, None, 1)
    c = scope.sub("conv")
    x = conv_layer(c, x, filters, kernel, activation, param, engine, sp, 1)
    return ops.pixel_norm(_bias_act(c, x, activation, param), engine=engine)


def _generator_block(scope, x, filters_out, activation, param, fused_transitions, engine,
                     sp=None, i=None):
    """Block from resolution `i` - 1 into `i`."""
    r = scope.sub("residual")
    t = ops.conv(r, x, filters_out, (1,) * (x.ndim - 2), activation, param=param,
                 engine=engine)
    t = to_slab(sp, ops.upscale(t), i - 1, i)
    if fused_transitions:
        c = scope.sub("conv_1")
        kernel = adaptive_kernel([s * 2 for s in spatial_at(x, sp, i - 1)])
        w = ops.get_weight(c, (*kernel, x.shape[1], filters_out), activation, param=param)
        x = ops.pixel_norm(_bias_act(c, up_conv_at(x, w, engine, sp, i, True), activation,
                                     param), engine=engine)
        names = ("conv_2",)
    else:
        x = to_slab(sp, ops.upscale(x), i - 1, i)
        names = ("conv_1", "conv_2")
    for name in names:
        c = scope.sub(name)
        x = conv_layer(c, x, filters_out, adaptive_kernel(spatial_at(x, sp, i)), activation, param,
                  engine, sp, i)
        x = ops.pixel_norm(_bias_act(c, x, activation, param), engine=engine)
    return _residual_sum(x, t, activation, param)


def _generator(scope, z, alpha, phase, cfg, param, engine, space=None):
    channels = cfg.base_shape[0]
    activation = cfg.activation
    g = scope.sub("generator")
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    x = _generator_in(g.sub("generator_in"), z, resolve_base_dim(cfg), cfg.base_shape[1:],
                      activation, param, engine, sp)
    x_out = ops.to_rgb(g.sub("to_rgb_1"), x, channels, engine=engine)
    for i in range(2, phase + 1):
        x = _generator_block(g.sub(f"generator_block_{i}"), x, phase_filters(cfg, i),
                             activation, param, cfg.fused_transitions, engine, sp, i)
        rgb = ops.to_rgb(g.sub(f"to_rgb_{i}"), x, channels, engine=engine)
        up = to_slab(sp, ops.upscale(x_out), i - 1, i)
        if i == phase and not static_alpha_zero(alpha):
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x_out = (1 - a) * rgb + up
        else:
            x_out = rgb + up
    return x_out


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: ops.Engine = "direct", noise=None, mix=None,
              train: bool = True, space=None) -> torch.Tensor:
    """G(z) at `phase`.  pgan2 draws no noise and mixes no styles: `noise`, `mix` and
    `train` change nothing.  `space`: the output is this rank's slab of each volume."""
    return segment(lambda t: _generator(Scope(params), t, alpha, phase, cfg, cfg.leakiness,
                                        conv_engine, space), cfg, z)


def _discriminator_block(scope, x, filters_in, filters_out, activation, param, engine,
                         sp=None, i=None):
    """Block at resolution `i` (its residual pooled into `i` - 1 first)."""
    r = d_scope(sp, scope.sub("residual"), i - 1)
    t = ops.conv(r, ops.downscale(to_whole(sp, x, i, i - 1), engine=engine), filters_out,
                 (1,) * (x.ndim - 2), activation, param=param, engine=engine)
    kernel = adaptive_kernel(spatial_at(x, sp, i))
    c1 = d_scope(sp, scope.sub("conv_1"), i)
    x = _bias_act(c1, conv_layer(c1, x, filters_in, kernel, activation, param, engine, sp, i),
                  activation, param)
    c2 = d_scope(sp, scope.sub("conv_2"), i)
    x = _bias_act(c2, conv_layer(c2, x, filters_out, kernel, activation, param, engine, sp, i),
                  activation, param)
    x = ops.downscale(to_whole(sp, x, i, i - 1), engine=engine)
    return _residual_sum(x, t, activation, param)


def _discriminator_out(scope, x, latent_dim, filters_out, activation, param, engine, sp=None):
    o = d_scope(sp, scope.sub("discriminator_out"), 1)
    x = conv_layer(o, x, filters_out, adaptive_kernel(spatial_at(x, sp, 1)), activation, param,
              engine, sp, 1)
    x = to_whole(sp, _bias_act(o, x, activation, param), 1, None)
    d1 = d_scope(sp, o.sub("dense_1"), None)
    x = _bias_act(d1, ops.dense(d1, x, latent_dim, activation, param=param), activation,
                  param)
    d2 = d_scope(sp, o.sub("dense_2"), None)
    return ops.apply_bias(d2, ops.dense(d2, x, 1, activation="linear"))


def _discriminator(scope, x, alpha, phase, cfg, param, engine, space=None):
    activation = cfg.activation
    d = scope.sub("discriminator")
    image = x
    sp = space_plan_for(space, phase, cfg, adaptive_space_plan)
    filters_out = phase_filters(cfg, phase)
    x = ops.from_rgb(d_scope(sp, d.sub(f"from_rgb_{phase}"), phase), x, filters_out,
                     activation, param=param, engine=engine)
    for i in reversed(range(2, phase + 1)):
        filters_out = phase_filters(cfg, i - 1)
        x = _discriminator_block(d.sub(f"discriminator_block_{i}"), x, phase_filters(cfg, i),
                                 filters_out, activation, param, engine, sp, i)
        if i == phase and not static_alpha_zero(alpha):
            prev = ops.from_rgb(d_scope(sp, d.sub(f"from_rgb_{phase - 1}"), phase - 1),
                                ops.downscale(to_whole(sp, image, phase, phase - 1), engine=engine),
                                filters_out, activation, param=param, engine=engine)
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x = a * prev + (1 - a) * x
    return _discriminator_out(d, x, cfg.latent_dim, filters_out, activation, param, engine,
                              sp)


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
        lambda s, z: _generator(s, z, 1.0, phase, cfg, cfg.leakiness, "direct"),
        lambda s, x: _discriminator(s, x, 1.0, phase, cfg, cfg.leakiness, "direct"),
        rng, phase=phase, cfg=cfg, device=device)


register(Architecture("pgan2", init, generator, discriminator, adaptive_space_plan))
