"""pgan2: progressive growing with residual blocks and a skip-sum to_rgb chain
(counterpart of ``saragan_tpu/models/pgan2.py``).

Generator blocks add a 1x1-conv residual of the upscaled input, gain-normalized,
``(x + t) / gain``; every level's RGB is upscaled and summed, the top level weighted by
(1 - alpha) during mixing.  The discriminator mirrors it with pooled 1x1 residuals.
Filters come from the num_filters tables (``models/common.py``), kernels shrink to 1 on
spatial axes shorter than 3.  Bias, activation and pixel norm stay separate ops, as in
the reference (no fused kernel).  Under ``remat_offload`` each network is one recompute
region (it has no block taps), as the reference's offload policy finds no names in it.
"""

from __future__ import annotations

import numpy as np
import torch

from saragan_tpu_torch.core import Params, Scope
from saragan_tpu_torch.models.common import (adaptive_kernel, init_from_shape_passes,
                                              phase_filters, resolve_base_dim, segment,
                                              spectral_iters, static_alpha_zero)
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops


def _bias_act(scope, x, activation, param):
    return ops.act(ops.apply_bias(scope, x), activation, param=param)


def _residual_sum(x, t, activation, param):
    return (x + t) * ops.in_dtype(1.0 / ops.calculate_gain(activation, param), x.dtype)


def _generator_in(scope, x, filters, shape, activation, param, engine):
    d = scope.sub("dense")
    x = ops.dense(d, x, int(np.prod(shape)) * filters, activation, param=param)
    x = _bias_act(d, x, activation, param).reshape((-1, filters, *shape))
    c = scope.sub("conv")
    x = ops.conv(c, x, filters, adaptive_kernel(x.shape[2:]), activation, param=param,
                 engine=engine)
    return ops.pixel_norm(_bias_act(c, x, activation, param))


def _generator_block(scope, x, filters_out, activation, param, fused_transitions, engine):
    r = scope.sub("residual")
    t = ops.conv(r, x, filters_out, (1,) * (x.ndim - 2), activation, param=param,
                 engine=engine)
    t = ops.upscale(t)
    if fused_transitions:
        c = scope.sub("conv_1")
        kernel = adaptive_kernel([s * 2 for s in x.shape[2:]])
        w = ops.get_weight(c, (*kernel, x.shape[1], filters_out), activation, param=param)
        x = ops.pixel_norm(_bias_act(c, ops.upscale_conv(x, w.to(x.dtype)), activation, param))
        names = ("conv_2",)
    else:
        x = ops.upscale(x)
        names = ("conv_1", "conv_2")
    for name in names:
        c = scope.sub(name)
        x = ops.conv(c, x, filters_out, adaptive_kernel(x.shape[2:]), activation, param=param,
                     engine=engine)
        x = ops.pixel_norm(_bias_act(c, x, activation, param))
    return _residual_sum(x, t, activation, param)


def _generator(scope, z, alpha, phase, cfg, param, engine):
    channels = cfg.base_shape[0]
    activation = cfg.activation
    g = scope.sub("generator")
    x = _generator_in(g.sub("generator_in"), z, resolve_base_dim(cfg), cfg.base_shape[1:],
                      activation, param, engine)
    x_out = ops.to_rgb(g.sub("to_rgb_1"), x, channels, engine=engine)
    for i in range(2, phase + 1):
        x = _generator_block(g.sub(f"generator_block_{i}"), x, phase_filters(cfg, i),
                             activation, param, cfg.fused_transitions, engine)
        rgb = ops.to_rgb(g.sub(f"to_rgb_{i}"), x, channels, engine=engine)
        if i == phase and not static_alpha_zero(alpha):
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x_out = (1 - a) * rgb + ops.upscale(x_out)
        else:
            x_out = rgb + ops.upscale(x_out)
    return x_out


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: str = "direct", noise=None, mix=None,
              train: bool = True) -> torch.Tensor:
    """G(z) at `phase`.  pgan2 draws no noise and mixes no styles: `noise`, `mix` and
    `train` change nothing."""
    return segment(lambda t: _generator(Scope(params), t, alpha, phase, cfg, cfg.leakiness,
                                        conv_engine), cfg, z)


def _discriminator_block(scope, x, filters_in, filters_out, activation, param, engine):
    r = scope.sub("residual")
    t = ops.conv(r, ops.downscale(x), filters_out, (1,) * (x.ndim - 2), activation,
                 param=param, engine=engine)
    c1 = scope.sub("conv_1")
    x = ops.conv(c1, x, filters_in, adaptive_kernel(x.shape[2:]), activation, param=param,
                 engine=engine)
    x = _bias_act(c1, x, activation, param)
    c2 = scope.sub("conv_2")
    x = ops.conv(c2, x, filters_out, adaptive_kernel(x.shape[2:]), activation, param=param,
                 engine=engine)
    x = ops.downscale(_bias_act(c2, x, activation, param))
    return _residual_sum(x, t, activation, param)


def _discriminator_out(scope, x, latent_dim, filters_out, activation, param, engine):
    o = scope.sub("discriminator_out")
    x = ops.conv(o, x, filters_out, adaptive_kernel(x.shape[2:]), activation, param=param,
                 engine=engine)
    x = _bias_act(o, x, activation, param)
    d1 = o.sub("dense_1")
    x = _bias_act(d1, ops.dense(d1, x, latent_dim, activation, param=param), activation,
                  param)
    d2 = o.sub("dense_2")
    return ops.apply_bias(d2, ops.dense(d2, x, 1, activation="linear"))


def _discriminator(scope, x, alpha, phase, cfg, param, engine):
    activation = cfg.activation
    d = scope.sub("discriminator")
    image = x
    filters_out = phase_filters(cfg, phase)
    x = ops.from_rgb(d.sub(f"from_rgb_{phase}"), x, filters_out, activation, param=param,
                     engine=engine)
    for i in reversed(range(2, phase + 1)):
        filters_out = phase_filters(cfg, i - 1)
        x = _discriminator_block(d.sub(f"discriminator_block_{i}"), x, phase_filters(cfg, i),
                                 filters_out, activation, param, engine)
        if i == phase and not static_alpha_zero(alpha):
            prev = ops.from_rgb(d.sub(f"from_rgb_{phase - 1}"), ops.downscale(image),
                                filters_out, activation, param=param, engine=engine)
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x = a * prev + (1 - a) * x
    return _discriminator_out(d, x, cfg.latent_dim, filters_out, activation, param, engine)


def discriminator(params: Params, x: torch.Tensor, alpha, *, phase: int, cfg,
                  conv_engine: str = "direct", passes: int = 1,
                  mesh=None) -> torch.Tensor:
    """D(x) at `phase`: (N, C, *spatial) -> (N, 1).  No op mixes samples (`passes`
    and `mesh` change nothing)."""
    return segment(lambda t: _discriminator(Scope(params, spectral=spectral_iters(cfg)), t,
                                            alpha, phase, cfg, cfg.leakiness, conv_engine),
                   cfg, x)


def init(rng: torch.Generator, *, phase: int, cfg, device) -> Params:
    """The full G+D parameters for `phase` (the reference's names and shapes)."""
    return init_from_shape_passes(
        lambda s, z: _generator(s, z, 1.0, phase, cfg, cfg.leakiness, "direct"),
        lambda s, x: _discriminator(s, x, 1.0, phase, cfg, cfg.leakiness, "direct"),
        rng, phase=phase, cfg=cfg, device=device)


register(Architecture("pgan2", init, generator, discriminator))
