"""The 3-D pgan generator and discriminator (Karras et al., arXiv:1710.10196, as the
saraGAN project grows it in 3-D), written plainly.

Generator: dense + bias + leaky ReLU to the base volume, a conv with bias, leaky ReLU and
pixel norm, then per resolution i = 2..phase a growing transition (nearest upscale, conv)
and a conv, each with bias, leaky ReLU and pixel norm; a 1x1 conv with bias to the image
channels.  While a phase fades in (alpha not the Python number 0) the output is
``alpha * upscale(to_rgb_{phase-1}(x_{phase-1})) + (1 - alpha) * to_rgb_phase(x)``.

Discriminator: a 1x1 conv with bias and leaky ReLU from the image, per resolution
i = phase..2 two convs with bias and leaky ReLU and a 2x average pool (the first of them
fed ``alpha * from_rgb_{phase-1}(pool(image)) + (1 - alpha) * x`` right after the top
block while fading in), then a conv, a dense layer to the latent size and a dense layer
to one score, with biases and leaky ReLU between.  Kernel and filter counts come from
the configuration's ``kernel_spec`` and ``filter_spec``; the discriminator reads them
crosswise as the saraGAN code does (conv_1: kernel [i-1][1], filters [i-1][0]; conv_2:
kernel [i-1][0], filters [i-2][1]).  Parameter names are the saraGAN scope names.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops
from portbench.reference.ops import NO_ROUNDING, Params, Rounding


def _fading(alpha) -> bool:
    return not (isinstance(alpha, (int, float)) and float(alpha) == 0.0)


def _bias_act_pn(p: Params, scope: str, x, leak, q: Rounding):
    b = p(f"{scope}/bias", (x.shape[1],))
    return q(ops.pixel_norm(q(ops.lrelu(q(ops.channel_bias(x, b)), leak))))


def _bias_act(p: Params, scope: str, x, leak, q: Rounding):
    b = p(f"{scope}/bias", (x.shape[-1] if x.ndim == 2 else x.shape[1],))
    y = x + b if x.ndim == 2 else ops.channel_bias(x, b)
    return q(ops.lrelu(q(y), leak))


def _conv_w(p, scope, kernel, cin, cout, activation, leak):
    return ops.weight(p, f"{scope}/weight", (*kernel, cin, cout), activation, leak)


def generator(p: Params, z: torch.Tensor, alpha, *, phase: int, cfg: dict,
              q: Rounding = NO_ROUNDING) -> torch.Tensor:
    ks, fs, leak = cfg["kernel_spec"], cfg["filter_spec"], cfg["leakiness"]
    base = cfg["base_shape"]
    g = "generator"
    f0 = fs[0][0]
    n_base = math.prod(base[1:]) * f0
    x = ops.dense(q(z), ops.weight(p, f"{g}/generator_in/dense/weight", (z.shape[1], n_base),
                                   "leaky_relu", leak), q)
    x = _bias_act(p, f"{g}/generator_in/dense", x, leak, q).reshape(-1, f0, *base[1:])
    s = f"{g}/generator_in/conv"
    x = ops.conv(x, _conv_w(p, s, ks[0][1], f0, fs[0][1], "leaky_relu", leak), q)
    x = _bias_act_pn(p, s, x, leak, q)
    x_prev = None
    for i in range(2, phase + 1):
        if i == phase and _fading(alpha):
            x_prev = x
        s1, s2 = f"{g}/generator_block_{i}/conv_1", f"{g}/generator_block_{i}/conv_2"
        x = ops.upconv(x, _conv_w(p, s1, ks[i - 1][0], x.shape[1], fs[i - 1][0],
                                  "leaky_relu", leak), q)
        x = _bias_act_pn(p, s1, x, leak, q)
        x = ops.conv(x, _conv_w(p, s2, ks[i - 1][1], x.shape[1], fs[i - 1][1],
                                "leaky_relu", leak), q)
        x = _bias_act_pn(p, s2, x, leak, q)
    out = _to_rgb(p, f"{g}/to_rgb_{phase}", x, base[0], q)
    if x_prev is None:
        return out
    prev = ops.upscale(_to_rgb(p, f"{g}/to_rgb_{phase - 1}", x_prev, base[0], q))
    a = torch.as_tensor(alpha, dtype=out.dtype, device=out.device)
    return q(a * prev + (1 - a) * out)


def _to_rgb(p, scope, x, channels, q):
    y = ops.conv(x, _conv_w(p, scope, (1, 1, 1), x.shape[1], channels, "linear", 0.0), q)
    return q(ops.channel_bias(y, p(f"{scope}/bias", (channels,))))


def _from_rgb(p, scope, x, filters, leak, q):
    y = ops.conv(x, _conv_w(p, scope, (1, 1, 1), x.shape[1], filters, "leaky_relu", leak), q)
    return _bias_act(p, scope, y, leak, q)


def discriminator(p: Params, x: torch.Tensor, alpha, *, phase: int, cfg: dict,
                  q: Rounding = NO_ROUNDING) -> torch.Tensor:
    ks, fs, leak = cfg["kernel_spec"], cfg["filter_spec"], cfg["leakiness"]
    d = "discriminator"
    image = q(x)
    x = _from_rgb(p, f"{d}/from_rgb_{phase}", image, fs[phase - 1][1], leak, q)
    for i in reversed(range(2, phase + 1)):
        if i == phase - 1 and _fading(alpha):
            prev = _from_rgb(p, f"{d}/from_rgb_{phase - 1}", q(ops.downscale(image)),
                             fs[phase - 2][1], leak, q)
            a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
            x = q(a * prev + (1 - a) * x)
        b = f"{d}/discriminator_block_{i}"
        x = ops.conv(x, _conv_w(p, f"{b}/conv_1", ks[i - 1][1], x.shape[1], fs[i - 1][0],
                                "leaky_relu", leak), q)
        x = _bias_act(p, f"{b}/conv_1", x, leak, q)
        x = ops.conv(x, _conv_w(p, f"{b}/conv_2", ks[i - 1][0], x.shape[1], fs[i - 2][1],
                                "leaky_relu", leak), q)
        x = _bias_act(p, f"{b}/conv_2", x, leak, q)
        x = q(ops.downscale(x))
    if phase == 2 and _fading(alpha):
        prev = _from_rgb(p, f"{d}/from_rgb_1", q(ops.downscale(image)), fs[0][1], leak, q)
        a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        x = q(a * prev + (1 - a) * x)
    o = f"{d}/discriminator_out"
    x = ops.conv(x, _conv_w(p, o, ks[0][1], x.shape[1], fs[0][0], "leaky_relu", leak), q)
    x = _bias_act(p, o, x, leak, q)
    x = ops.dense(x, ops.weight(p, f"{o}/dense_1/weight", (x[0].numel(), cfg["latent_dim"]),
                                "leaky_relu", leak), q)
    x = _bias_act(p, f"{o}/dense_1", x, leak, q)
    x = ops.dense(x, ops.weight(p, f"{o}/dense_2/weight", (x.shape[1], 1), "linear", leak), q)
    return q(x + p(f"{o}/dense_2/bias", (1,)))
