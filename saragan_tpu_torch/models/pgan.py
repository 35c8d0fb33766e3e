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

Each network is written as a chain of recompute regions between its block boundaries
(``models/common.py``: ``segment`` and ``block_tap``, at the reference's tap names), which
``remat_offload`` checkpoints and otherwise runs as plain calls.  ``use_spectral_norm``
spectrally normalizes every discriminator weight (``Scope(spectral=...)``), each with a
persisted ``<weight>_u`` start vector among the parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from saragan_tpu_torch.core import Params, Scope, zeros_initializer
from saragan_tpu_torch.models.common import (block_tap, init_from_shape_passes, segment,
                                              spectral_iters, static_alpha_zero)
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


def _conv_bias_act_pn(c, x, fmaps, kernel, activation, param, fused, engine):
    x = ops.conv(c, x, fmaps, kernel, activation, param=param, engine=engine)
    return _bias_act_pn(c, x, activation, param, fused)


def _generator_block(scope, x, activation, kernel_spec, filter_spec, i, param, fused,
                     fused_transitions, engine, cfg):
    """Block i from the previous block's output, as two recompute regions (``segment``):
    the transition up to the ``gen_block_{i}_mid`` tap, then conv_2."""
    c1, c2 = scope.sub("conv_1"), scope.sub("conv_2")

    def first(t):
        if fused_transitions:
            kernel = tuple(int(k) for k in get_kernels(kernel_spec, i - 1, 0))
            w = ops.get_weight(c1, (*kernel, t.shape[1], get_filters(filter_spec, i - 1, 0)),
                               activation, param=param)
            return _bias_act_pn(c1, ops.upscale_conv(t, w.to(t.dtype)), activation, param,
                                fused)
        return _conv_bias_act_pn(c1, ops.upscale(t), get_filters(filter_spec, i - 1, 0),
                                 get_kernels(kernel_spec, i - 1, 0), activation, param, fused,
                                 engine)

    def second(t):
        return _conv_bias_act_pn(c2, t, get_filters(filter_spec, i - 1, 1),
                                 get_kernels(kernel_spec, i - 1, 1), activation, param, fused,
                                 engine)

    mid = block_tap(segment(first, cfg, x), f"gen_block_{i}_mid", cfg)
    return segment(second, cfg, mid)


def _generator(scope, z, alpha, phase, cfg, param, engine):
    base_shape = cfg.base_shape
    kernel_spec = cfg.resolved_kernel_spec()
    filter_spec = cfg.resolved_filter_spec()
    activation = cfg.activation
    g = scope.sub("generator")
    fused = cfg.use_pallas_fusion

    x = segment(lambda t: _generator_in(g.sub("generator_in"), t, base_shape[1:], activation,
                                        kernel_spec, filter_spec, param, fused, engine),
                cfg, z)
    x = block_tap(x, "gen_in", cfg)

    x_prev = None  # the previous resolution's output, for the transition branch
    for i in range(2, phase + 1):
        if i == phase and not static_alpha_zero(alpha):
            x_prev = x
        x = _generator_block(g.sub(f"generator_block_{i}"), x, activation, kernel_spec,
                             filter_spec, i, param, fused, cfg.fused_transitions, engine, cfg)
        x = block_tap(x, f"gen_block_{i}", cfg)

    def out(t, t_prev):
        x_out = ops.to_rgb(g.sub(f"to_rgb_{phase}"), t, channels=base_shape[0], engine=engine)
        if t_prev is None:
            return x_out
        x_upsample = ops.upscale(ops.to_rgb(g.sub(f"to_rgb_{phase - 1}"), t_prev,
                                            channels=base_shape[0], engine=engine))
        a = torch.as_tensor(alpha, dtype=x_out.dtype)
        return a * x_upsample + (1 - a) * x_out

    return segment(out, cfg, x, x_prev)


def generator(params: Params, z: torch.Tensor, alpha, *, phase: int, cfg,
              conv_engine: str = "direct", noise=None, mix=None,
              train: bool = True) -> torch.Tensor:
    """G(z) at `phase`: (N, latent_dim) -> (N, C, *spatial).  `alpha` is a Python float
    (0 skips the transition branch) or a 0-dim tensor (the branch always runs).  pgan
    draws no noise and mixes no styles: `noise`, `mix` and `train` change nothing."""
    return _generator(Scope(params), z, alpha, phase, cfg, cfg.leakiness, conv_engine)


def _conv_bias_act(c, x, fmaps, kernel, activation, param, engine):
    x = ops.conv(c, x, fmaps, kernel, activation, param=param, engine=engine)
    return ops.act(ops.apply_bias(c, x), activation, param=param)


def _discriminator_out(scope, x, latent_dim, activation, kernel_spec, filter_spec, param,
                       engine):
    o = scope.sub("discriminator_out")
    x = _conv_bias_act(o, x, get_filters(filter_spec, 0, 0), get_kernels(kernel_spec, 0, 1),
                       activation, param, engine)
    d1 = o.sub("dense_1")
    x = ops.act(ops.apply_bias(d1, ops.dense(d1, x, latent_dim, activation, param=param)),
                activation, param=param)
    d2 = o.sub("dense_2")
    return ops.apply_bias(d2, ops.dense(d2, x, 1, activation="linear"))


def _discriminator(scope, x, alpha, phase, cfg, param, engine):
    """From_rgb, then per block i = phase .. 2 two recompute regions (``segment``), up to
    the ``disc_block_{i}_mid`` tap and from it through conv_2 and the pooling; the
    transition blend after the top block opens the region that follows it.  The
    reference's index quirk (``saragan_tpu/models/pgan.py:185-187``) is kept: conv_1 uses
    kernel_spec[i-1][1] with filter_spec[i-1][0]; conv_2 uses kernel_spec[i-1][0] with
    filter_spec[i-2][1]."""
    kernel_spec = cfg.resolved_kernel_spec()
    filter_spec = cfg.resolved_filter_spec()
    activation = cfg.activation
    d = scope.sub("discriminator")
    image = x

    def transition(t, img):
        prev = ops.from_rgb(d.sub(f"from_rgb_{phase - 1}"), ops.downscale(img),
                            get_filters(filter_spec, phase - 2, 1), activation, param=param,
                            engine=engine)
        a = torch.as_tensor(alpha, dtype=t.dtype)
        return a * prev + (1 - a) * t

    x = segment(lambda img: ops.from_rgb(d.sub(f"from_rgb_{phase}"), img,
                                         get_filters(filter_spec, phase - 1, 1), activation,
                                         param=param, engine=engine), cfg, image)
    x = block_tap(x, "disc_in", cfg)
    pending = None  # the transition blend, applied where the next region starts
    for i in reversed(range(2, phase + 1)):
        b = d.sub(f"discriminator_block_{i}")

        def first(t, img, b=b, i=i, pending=pending):
            if pending is not None:
                t = pending(t, img)
            return _conv_bias_act(b.sub("conv_1"), t, get_filters(filter_spec, i - 1, 0),
                                  get_kernels(kernel_spec, i - 1, 1), activation, param, engine)

        def second(t, b=b, i=i):
            t = _conv_bias_act(b.sub("conv_2"), t, get_filters(filter_spec, i - 2, 1),
                               get_kernels(kernel_spec, i - 1, 0), activation, param, engine)
            return ops.downscale(t)

        x = block_tap(segment(first, cfg, x, image), f"disc_block_{i}_mid", cfg)
        x = block_tap(segment(second, cfg, x), f"disc_block_{i}", cfg)
        pending = transition if i == phase and not static_alpha_zero(alpha) else None

    def out(t, img):
        if pending is not None:
            t = pending(t, img)
        return _discriminator_out(d, t, cfg.latent_dim, activation, kernel_spec, filter_spec,
                                  param, engine)

    return segment(out, cfg, x, image)


def discriminator(params: Params, x: torch.Tensor, alpha, *, phase: int, cfg,
                  conv_engine: str = "direct", passes: int = 1,
                  mesh=None) -> torch.Tensor:
    """D(x) at `phase`: (N, C, *spatial) -> (N, 1) scores.  `alpha` as for the
    generator.  No op mixes samples, so stacked passes (`passes`) and a
    data-parallel `mesh` need nothing."""
    return _discriminator(Scope(params, spectral=spectral_iters(cfg)), x, alpha, phase, cfg,
                          cfg.leakiness, conv_engine)


def init(rng: torch.Generator, *, phase: int, cfg, device) -> Params:
    """The full G+D parameters for `phase` (names and shapes of the reference's
    ``arch.init``), from shape-only passes on the meta device
    (``models.common.init_from_shape_passes``)."""
    # the fused op reads the same "bias" parameter; the shape-only pass skips its
    # dispatch, so an init never counts as a call of its plain version
    g_cfg = dataclasses.replace(cfg, use_pallas_fusion=False)
    return init_from_shape_passes(
        lambda s, z: _generator(s, z, 1.0, phase, g_cfg, cfg.leakiness, "direct"),
        lambda s, x: _discriminator(s, x, 1.0, phase, cfg, cfg.leakiness, "direct"),
        rng, phase=phase, cfg=cfg, device=device)


register(Architecture("pgan", init, generator, discriminator))
