"""pgandeep: pgan with any number of conv layers per phase (counterpart of
``saragan_tpu/models/pgandeep.py``).

Each phase has ``len(kernel_spec[phase])`` layers.  The reference's index conventions
are kept: generator_in's layers 1..L-1 read spec[0][layer]; generator block layer j
(1-based) reads spec[i-1][j-1]; every discriminator block conv reads kernel_spec[i-1][1],
its last layer filter_spec[i-2][L-1] and the others filter_spec[i-1][L-j-1]; the
discriminator head's convs walk spec[0] backwards.  The head is called, as in the JAX
package (the original's discriminator forgot it).  Bias, activation and pixel norm stay
separate ops (no fused kernel), as in the reference.  Under ``remat_offload`` each network
is one recompute region (it has no block taps).
"""

from __future__ import annotations

import numpy as np
import torch

from saragan_tpu_torch.core import Params, Scope
from saragan_tpu_torch.models.common import (init_from_shape_passes, segment, spectral_iters,
                                              static_alpha_zero)
from saragan_tpu_torch.models.pgan import get_filters, get_kernels
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops


def _conv_bias_act(c, x, fmaps, kernel, activation, param, engine):
    x = ops.conv(c, x, fmaps, kernel, activation, param=param, engine=engine)
    return ops.act(ops.apply_bias(c, x), activation, param=param)


def _generator_in(scope, x, shape, activation, kernel_spec, filter_spec, param, engine):
    d = scope.sub("dense")
    f0 = get_filters(filter_spec, 0, 0)
    x = ops.dense(d, x, int(np.prod(shape)) * f0, activation, param=param)
    x = ops.act(ops.apply_bias(d, x), activation, param=param).reshape((-1, f0, *shape))
    for layer_i in range(1, len(kernel_spec[0])):
        x = ops.pixel_norm(_conv_bias_act(
            scope.sub(f"conv_{layer_i}"), x, get_filters(filter_spec, 0, layer_i),
            get_kernels(kernel_spec, 0, layer_i), activation, param, engine))
    return x


def _generator_block(scope, x, activation, kernel_spec, filter_spec, i, param, engine):
    x = ops.upscale(x)
    for layer_i in range(1, len(kernel_spec[i - 1]) + 1):
        x = ops.pixel_norm(_conv_bias_act(
            scope.sub(f"conv_{layer_i}"), x, get_filters(filter_spec, i - 1, layer_i - 1),
            get_kernels(kernel_spec, i - 1, layer_i - 1), activation, param, engine))
    return x


def _generator(scope, z, alpha, phase, cfg, param, engine):
    kernel_spec = cfg.resolved_kernel_spec()
    filter_spec = cfg.resolved_filter_spec()
    channels = cfg.base_shape[0]
    g = scope.sub("generator")
    x = _generator_in(g.sub("generator_in"), z, cfg.base_shape[1:], cfg.activation,
                      kernel_spec, filter_spec, param, engine)
    x_upsample = None
    for i in range(2, phase + 1):
        if i == phase and not static_alpha_zero(alpha):
            x_upsample = ops.upscale(ops.to_rgb(g.sub(f"to_rgb_{phase - 1}"), x, channels,
                                                engine=engine))
        x = _generator_block(g.sub(f"generator_block_{i}"), x, cfg.activation, kernel_spec,
                             filter_spec, i, param, engine)
    x_out = ops.to_rgb(g.sub(f"to_rgb_{phase}"), x, channels, engine=engine)
    if x_upsample is not None:
        a = torch.as_tensor(alpha, dtype=x_out.dtype)
        x_out = a * x_upsample + (1 - a) * x_out
    return x_out


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: str = "direct", noise=None, mix=None,
              train: bool = True) -> torch.Tensor:
    """G(z) at `phase`.  pgandeep draws no noise and mixes no styles: `noise`, `mix` and
    `train` change nothing."""
    return segment(lambda t: _generator(Scope(params), t, alpha, phase, cfg, cfg.leakiness,
                                        conv_engine), cfg, z)


def _discriminator_block(scope, x, activation, kernel_spec, filter_spec, i, param, engine):
    num_layers = len(kernel_spec[i - 1])
    for layer_i in range(1, num_layers + 1):
        if layer_i == num_layers:
            filters = get_filters(filter_spec, i - 2, num_layers - 1)
        else:
            filters = get_filters(filter_spec, i - 1, num_layers - layer_i - 1)
        x = _conv_bias_act(scope.sub(f"conv_{layer_i}"), x, filters,
                           get_kernels(kernel_spec, i - 1, 1), activation, param, engine)
    return ops.downscale(x)


def _discriminator_out(scope, x, latent_dim, activation, kernel_spec, filter_spec, param,
                       engine):
    o = scope.sub("discriminator_out")
    num_layers = len(kernel_spec[0])
    for layer_i in range(1, num_layers):
        x = _conv_bias_act(o.sub(f"conv_{layer_i}"), x,
                           get_filters(filter_spec, 0, num_layers - layer_i - 1),
                           get_kernels(kernel_spec, 0, num_layers - layer_i), activation,
                           param, engine)
    d1 = o.sub("dense_1")
    x = ops.act(ops.apply_bias(d1, ops.dense(d1, x, latent_dim, activation, param=param)),
                activation, param=param)
    d2 = o.sub("dense_2")
    return ops.apply_bias(d2, ops.dense(d2, x, 1, activation="linear"))


def _discriminator(scope, x, alpha, phase, cfg, param, engine):
    kernel_spec = cfg.resolved_kernel_spec()
    filter_spec = cfg.resolved_filter_spec()
    activation = cfg.activation
    d = scope.sub("discriminator")
    image = x
    x = ops.from_rgb(d.sub(f"from_rgb_{phase}"), x, get_filters(filter_spec, phase - 1, 1),
                     activation, param=param, engine=engine)
    for i in reversed(range(2, phase + 1)):
        x = _discriminator_block(d.sub(f"discriminator_block_{i}"), x, activation,
                                 kernel_spec, filter_spec, i, param, engine)
        if i == phase and not static_alpha_zero(alpha):
            prev = ops.from_rgb(d.sub(f"from_rgb_{phase - 1}"), ops.downscale(image),
                                get_filters(filter_spec, phase - 2, 1), activation,
                                param=param, engine=engine)
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x = a * prev + (1 - a) * x
    return _discriminator_out(d, x, cfg.latent_dim, activation, kernel_spec, filter_spec,
                              param, engine)


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


register(Architecture("pgandeep", init, generator, discriminator))
