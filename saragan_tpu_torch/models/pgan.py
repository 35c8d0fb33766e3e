"""pgan generator and discriminator (counterpart of ``saragan_tpu/models/pgan.py``).

Generator:
    dense -> reshape -> conv (+bias+act+pixelnorm)            [generator_in]
    per phase i in 2..phase: upscale, (conv+bias+act+pixelnorm) x2
    to_rgb of the final block, alpha-blended during mixing with the upscaled to_rgb
    of the previous resolution.
Discriminator:
    from_rgb (1x1 conv+bias+act)
    per phase i in phase..2: (conv+bias+act) x2, 2x average-pool; during mixing the
    first block is alpha-blended with from_rgb of the average-pooled input
    conv+bias+act, dense+bias+act, dense+bias -> (N, 1) scores  [discriminator_out]

With ``cfg.fused_transitions`` a block's upscale and first conv are one exact fused op,
``ops.upscale_conv`` (polyphase stride-1 convs, no upscaled activation).  With
``cfg.use_pallas_fusion`` every generator bias+act+pixelnorm is the fused kernel of
``ops/fused_bias_act.py`` (the discriminator has no pixel norm and never uses it).
``conv_engine`` picks the conv engine (see ``ops/core.py``).  Parameter names are the
reference's TF scope names.  pgan's discriminator has no cross-sample op (its
minibatch-stddev head is disabled in the reference), which the stacked critic pass of
the train step relies on.
"""

from __future__ import annotations

import numpy as np
import torch

from saragan_tpu_torch.core import Params, Scope, zeros_initializer
from saragan_tpu_torch.models.common import block_tap, static_alpha_zero
from saragan_tpu_torch.models.registry import Architecture, register
from saragan_tpu_torch.ops import core as ops
from saragan_tpu_torch.ops.fused_bias_act import bias_act_pixelnorm


def _get_spec(spec, phase_i, layer_i, what):
    if phase_i >= len(spec):
        raise ValueError(f"no {what} specified for phase {phase_i} (spec has {len(spec)})")
    if layer_i >= len(spec[phase_i]):
        raise ValueError(f"no {what} specified for layer {layer_i} in phase {phase_i}")
    return spec[phase_i][layer_i]


def get_filters(filter_spec, phase_i, layer_i):
    return _get_spec(filter_spec, phase_i, layer_i, "filter count")


def get_kernels(kernel_spec, phase_i, layer_i):
    return _get_spec(kernel_spec, phase_i, layer_i, "kernel shape")


def _bias_act_pn(scope, x, activation, param, fused: bool):
    """bias -> act -> pixel_norm; one fused kernel when enabled and the activation is
    leaky_relu."""
    if fused and activation == "leaky_relu":
        b = scope.get("bias", (x.shape[1],), zeros_initializer())
        return bias_act_pixelnorm(x, b, alpha_lr=param, pixelnorm=True)
    x = ops.apply_bias(scope, x)
    x = ops.act(x, activation, param=param)
    return ops.pixel_norm(x)


def _generator_in(scope, x, shape, activation, kernel_spec, filter_spec, param, fused, engine):
    d = scope.sub("dense")
    f0 = get_filters(filter_spec, 0, 0)
    x = ops.dense(d, x, int(np.prod(shape)) * f0, activation, param=param)
    x = ops.apply_bias(d, x)
    x = ops.act(x, activation, param=param)
    x = x.reshape((-1, f0, *shape))
    c = scope.sub("conv")
    x = ops.conv(c, x, get_filters(filter_spec, 0, 1), get_kernels(kernel_spec, 0, 1),
                 activation, param=param, engine=engine)
    return _bias_act_pn(c, x, activation, param, fused)


def _generator_block(scope, x, activation, kernel_spec, filter_spec, i, param, fused,
                     fused_transitions, engine, cfg):
    if fused_transitions:
        c = scope.sub("conv_1")
        kernel = tuple(int(k) for k in get_kernels(kernel_spec, i - 1, 0))
        fmaps = get_filters(filter_spec, i - 1, 0)
        w = ops.get_weight(c, (*kernel, x.shape[1], fmaps), activation, param=param)
        x = ops.upscale_conv(x, w.to(x.dtype))
        x = _bias_act_pn(c, x, activation, param, fused)
        x = block_tap(x, f"gen_block_{i}_mid", cfg)
        rest = (("conv_2", 1),)
    else:
        x = ops.upscale(x)
        rest = (("conv_1", 0), ("conv_2", 1))
    for name, li in rest:
        c = scope.sub(name)
        x = ops.conv(c, x, get_filters(filter_spec, i - 1, li),
                     get_kernels(kernel_spec, i - 1, li), activation, param=param,
                     engine=engine)
        x = _bias_act_pn(c, x, activation, param, fused)
        if name == "conv_1":
            x = block_tap(x, f"gen_block_{i}_mid", cfg)
    return x


def _generator(scope, z, alpha, phase, cfg, param, engine):
    base_shape = cfg.base_shape
    kernel_spec = cfg.resolved_kernel_spec()
    filter_spec = cfg.resolved_filter_spec()
    activation = cfg.activation
    g = scope.sub("generator")
    fused = cfg.use_pallas_fusion

    x = _generator_in(g.sub("generator_in"), z, base_shape[1:], activation, kernel_spec,
                      filter_spec, param, fused, engine)
    x = block_tap(x, "gen_in", cfg)

    x_upsample = None
    for i in range(2, phase + 1):
        if i == phase and not static_alpha_zero(alpha):
            x_upsample = ops.upscale(ops.to_rgb(g.sub(f"to_rgb_{phase - 1}"), x,
                                                channels=base_shape[0], engine=engine))
        x = _generator_block(g.sub(f"generator_block_{i}"), x, activation, kernel_spec,
                             filter_spec, i, param, fused, cfg.fused_transitions, engine, cfg)
        x = block_tap(x, f"gen_block_{i}", cfg)

    x_out = ops.to_rgb(g.sub(f"to_rgb_{phase}"), x, channels=base_shape[0], engine=engine)
    if x_upsample is not None:
        a = torch.as_tensor(alpha, dtype=x_out.dtype)
        x_out = a * x_upsample + (1 - a) * x_out
    return x_out


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: str = "direct") -> torch.Tensor:
    """G(z) at `phase`: (N, latent_dim) -> (N, C, *spatial).  `alpha` is a Python float
    (0 skips the transition branch) or a 0-dim tensor (the branch always runs)."""
    return _generator(Scope(params), z, alpha, phase, cfg, cfg.leakiness, conv_engine)


def _discriminator_block(scope, x, activation, kernel_spec, filter_spec, i, param, engine,
                         cfg):
    """The reference's index quirk (``saragan_tpu/models/pgan.py:185-187``) is kept:
    conv_1 uses kernel_spec[i-1][1] with filter_spec[i-1][0]; conv_2 uses
    kernel_spec[i-1][0] with filter_spec[i-2][1]."""
    c1 = scope.sub("conv_1")
    x = ops.conv(c1, x, get_filters(filter_spec, i - 1, 0), get_kernels(kernel_spec, i - 1, 1),
                 activation, param=param, engine=engine)
    x = ops.act(ops.apply_bias(c1, x), activation, param=param)
    x = block_tap(x, f"disc_block_{i}_mid", cfg)
    c2 = scope.sub("conv_2")
    x = ops.conv(c2, x, get_filters(filter_spec, i - 2, 1), get_kernels(kernel_spec, i - 1, 0),
                 activation, param=param, engine=engine)
    x = ops.act(ops.apply_bias(c2, x), activation, param=param)
    return ops.downscale(x)


def _discriminator_out(scope, x, latent_dim, activation, kernel_spec, filter_spec, param,
                       engine):
    o = scope.sub("discriminator_out")
    x = ops.conv(o, x, get_filters(filter_spec, 0, 0), get_kernels(kernel_spec, 0, 1),
                 activation, param=param, engine=engine)
    x = ops.act(ops.apply_bias(o, x), activation, param=param)
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

    x_downscale = x
    x = ops.from_rgb(d.sub(f"from_rgb_{phase}"), x, get_filters(filter_spec, phase - 1, 1),
                     activation, param=param, engine=engine)
    x = block_tap(x, "disc_in", cfg)
    for i in reversed(range(2, phase + 1)):
        x = _discriminator_block(d.sub(f"discriminator_block_{i}"), x, activation, kernel_spec,
                                 filter_spec, i, param, engine, cfg)
        x = block_tap(x, f"disc_block_{i}", cfg)
        if i == phase and not static_alpha_zero(alpha):
            prev = ops.from_rgb(d.sub(f"from_rgb_{phase - 1}"), ops.downscale(x_downscale),
                                get_filters(filter_spec, phase - 2, 1), activation,
                                param=param, engine=engine)
            a = torch.as_tensor(alpha, dtype=x.dtype)
            x = a * prev + (1 - a) * x
    return _discriminator_out(d, x, cfg.latent_dim, activation, kernel_spec, filter_spec,
                              param, engine)


def _check_spectral(cfg):
    if getattr(cfg, "use_spectral_norm", False):
        raise NotImplementedError("use_spectral_norm=True is not ported yet (ROADMAP queue 1 "
                                  "item 2: spectral norm of the discriminator)")


def discriminator(params: Params, x: torch.Tensor, alpha, *, phase: int, cfg,
                  conv_engine: str = "direct") -> torch.Tensor:
    """D(x) at `phase`: (N, C, *spatial) -> (N, 1) scores.  `alpha` as for the
    generator."""
    _check_spectral(cfg)
    return _discriminator(Scope(params), x, alpha, phase, cfg, cfg.leakiness, conv_engine)


def init(rng: torch.Generator, *, phase: int, cfg, device) -> Params:
    """The full G+D parameters for `phase` (names and shapes of the reference's
    ``arch.init``).  Both init forwards run on the meta device, so only the parameters
    are materialized, on `device`; each draws from a generator seeded by the root seed
    and the parameter's name."""
    _check_spectral(cfg)
    params: Params = {}
    scope = Scope(params, init=True, rng=rng, device=torch.device(device))
    z = torch.empty((1, cfg.latent_dim), device="meta")
    _generator(scope, z, 1.0, phase, cfg, cfg.leakiness, "direct")
    x = torch.empty(cfg.current_shape(phase, 1), device="meta")
    _discriminator(scope, x, 1.0, phase, cfg, cfg.leakiness, "direct")
    return params


register(Architecture("pgan", init, generator, discriminator))
