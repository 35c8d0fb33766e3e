"""surfgan, the saraGAN project's 3-D StyleGAN2 variant, written plainly.

Mapping: z normalized by its RMS, then 8 dense layers (learning-rate multiplier 0.01) with
bias and leaky ReLU, broadcast to ``4 * phase - 2`` styles.  In training, with the style
mixing draws given, a second mapping of ``z_mix`` replaces the styles from the cutoff on
(the drawn cutoff when the coin is below 0.9, else none).

Synthesis: a learned constant, a modulated conv (styles scale the input channels, the conv
runs with the unmodulated weight, the output is scaled by the demodulation
``rsqrt(sum over kernel and input channels of (w s)^2 + 1e-8)``) with per-voxel noise
times a learned strength, bias and leaky ReLU; per resolution i = 2..phase a residual
block: a modulated 1x1 transition (nearest upscale, conv) as the skip, a modulated
transition conv and a modulated conv each with noise, bias and leaky ReLU, summed with
the skip and divided by the leaky ReLU gain; a modulated 1x1 to_rgb without demodulation
per resolution, summed with the upscaled image of the resolution before (the newest one
scaled by ``1 - alpha`` while fading in).

Every bias and noise strength is scaled by its layer's weight coefficient
``gain / sqrt(fan_in) * lrmul``.  Kernels are 3 along an axis of 3 or more voxels, else
1.  Discriminator: a 1x1 conv from the image, residual blocks (1x1 conv of the pooled
input as the skip; two convs with bias and leaky ReLU, then the pool), the blend with
``from_rgb`` of the pooled image after the top block while fading in, then the
minibatch-stddev channel (groups of 4 strided across the batch), a conv, and two dense
layers to one score.  Filters per resolution are the configuration's ``filter_spec[i-1][0]``.

Noise comes from the caller: ``noise(name, shape)`` with the layer's name
``<conv scope>/apply_noise``.
"""

from __future__ import annotations

import torch

from portbench.reference import ops
from portbench.reference.ops import NO_ROUNDING, Params, Rounding

MAPPING_LAYERS = 8
MAPPING_LRMUL = 0.01
STYLE_MIXING_PROB = 0.9


def num_styles(phase: int) -> int:
    return 4 * phase - 2


def _filters(cfg, i):
    return cfg["filter_spec"][i - 1][0]


def _bias_rc(p, scope, x, rc):
    b = p(f"{scope}/bias", (x.shape[1],)) * rc
    return x + b if x.ndim == 2 else ops.channel_bias(x, b)


def mapping(p: Params, z: torch.Tensor, phase: int, cfg: dict, q: Rounding = NO_ROUNDING):
    leak = cfg["leakiness"]
    x = q(z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8))
    for k in range(MAPPING_LAYERS):
        s = f"generator/g_mapping/dense_{k}"
        shape = (x.shape[1], z.shape[1])
        x = ops.dense(x, ops.weight(p, f"{s}/weight", shape, "leaky_relu", leak,
                                    MAPPING_LRMUL), q)
        x = q(ops.lrelu(q(_bias_rc(p, s, x, ops.he_std(shape, "leaky_relu", leak,
                                                          MAPPING_LRMUL))), leak))
    return x[:, None].expand(-1, num_styles(phase), -1)


def _modulated(p, scope, x, style, cout, kernel, activation, leak, q, *, up=False,
               demodulate=True):
    shape = (*kernel, x.shape[1], cout)
    w = ops.weight(p, f"{scope}/weight", shape, activation, leak)
    mshape = (style.shape[1], x.shape[1])
    s = ops.dense(style, ops.weight(p, f"{scope}/modulate/weight", mshape, activation, leak),
                  q)
    s = q(_bias_rc(p, f"{scope}/modulate", s, ops.he_std(mshape, activation, leak)) + 1)
    if activation != "linear":
        s = q(ops.lrelu(s, leak))
    y = q(x * s[:, :, None, None, None])
    y = ops.upconv(y, w, q) if up else ops.conv(y, w, q)
    if demodulate:
        ww = q(w)[None] * s[:, None, None, None, :, None]
        d = torch.rsqrt(torch.sum(ww * ww, dim=(1, 2, 3, 4)) + 1e-8)
        y = q(y * q(d)[:, :, None, None, None])
    return y, ops.he_std(shape, activation, leak)


def _epilogue(p, scope, x, rc, leak, noise, q):
    strength = p(f"{scope}/apply_noise/noise_strength", ())
    if noise is not None:
        n = noise(f"{scope}/apply_noise", (x.shape[0], 1, *x.shape[2:]))
        x = q(x + q(n) * (strength * rc))
    return q(ops.lrelu(q(_bias_rc(p, scope, x, rc)), leak))


def _to_rgb(p, scope, x, style, channels, q):
    y, rc = _modulated(p, scope, x, style, channels, (1, 1, 1), "linear", 0.0, q,
                       demodulate=False)
    return q(_bias_rc(p, scope, y, rc))


def generator(p: Params, z, alpha, *, phase: int, cfg: dict, noise=None, mix=None,
              q: Rounding = NO_ROUNDING) -> torch.Tensor:
    """`mix`: (z_mix, coin, cutoff) of style mixing in training, or None."""
    leak, base = cfg["leakiness"], cfg["base_shape"]
    z = q(z)
    d_z = mapping(p, z, phase, cfg, q)
    p("generator/d_z_avg", (z.shape[1],))
    if mix is not None and phase > 1:
        z_mix, coin, cutoff = mix
        d_mix = mapping(p, q(z_mix), phase, cfg, q)
        cut = torch.where(coin < STYLE_MIXING_PROB, cutoff,
                          torch.as_tensor(num_styles(phase), device=cutoff.device))
        idx = torch.arange(num_styles(phase), device=d_z.device)[None, :, None]
        d_z = torch.where(idx < cut.to(d_z.device), d_z, d_mix)
    s = "generator/g_synthesis"
    f1 = _filters(cfg, 1)
    const = p(f"{s}/generator_in/constant_in/input_constant", (1, f1, *base[1:]))
    x = q(const).expand(z.shape[0], *const.shape[1:])
    sc = f"{s}/generator_in/conv"
    x, rc = _modulated(p, sc, x, d_z[:, 0], f1, ops.adaptive_kernel(x.shape[2:]),
                       "leaky_relu", leak, q)
    x = _epilogue(p, sc, x, rc, leak, noise, q)
    out = _to_rgb(p, f"{s}/to_rgb_1", x, d_z[:, 1], base[0], q)
    inv_gain = 1.0 / ops.gain("leaky_relu", leak)
    for i in range(2, phase + 1):
        b = f"{s}/generator_block_{i}"
        f = _filters(cfg, i)
        t, _ = _modulated(p, f"{b}/residual", x, d_z[:, 4 * i - 6], f, (1, 1, 1), "leaky_relu",
                          leak, q, up=True)
        y, rc = _modulated(p, f"{b}/conv_1", x, d_z[:, 3 * i - 5], f,
                           ops.adaptive_kernel(x.shape[2:]), "leaky_relu", leak, q, up=True)
        y = _epilogue(p, f"{b}/conv_1", y, rc, leak, noise, q)
        y, rc = _modulated(p, f"{b}/conv_2", y, d_z[:, 3 * i - 4], f,
                           ops.adaptive_kernel(y.shape[2:]), "leaky_relu", leak, q)
        y = _epilogue(p, f"{b}/conv_2", y, rc, leak, noise, q)
        x = q((y + t) * inv_gain)
        rgb = _to_rgb(p, f"{s}/to_rgb_{i}", x, d_z[:, 4 * i - 3], base[0], q)
        up = ops.upscale(out)
        if i == phase and not (isinstance(alpha, (int, float)) and float(alpha) == 0.0):
            a = torch.as_tensor(alpha, dtype=rgb.dtype, device=rgb.device)
            out = q((1 - a) * rgb + up)
        else:
            out = q(rgb + up)
    return out


def _conv_rc(p, scope, x, cout, kernel, leak, q):
    shape = (*kernel, x.shape[1], cout)
    return (ops.conv(x, ops.weight(p, f"{scope}/weight", shape, "leaky_relu", leak), q),
            ops.he_std(shape, "leaky_relu", leak))


def _from_rgb(p, scope, x, cout, leak, q):
    y, rc = _conv_rc(p, scope, x, cout, (1, 1, 1), leak, q)
    return q(ops.lrelu(q(_bias_rc(p, scope, y, rc)), leak))


def discriminator(p: Params, x, alpha, *, phase: int, cfg: dict,
                  q: Rounding = NO_ROUNDING) -> torch.Tensor:
    leak = cfg["leakiness"]
    d = "discriminator"
    image = q(x)
    x = _from_rgb(p, f"{d}/from_rgb_{phase}", image, _filters(cfg, phase), leak, q)
    inv_gain = 1.0 / ops.gain("leaky_relu", leak)
    for i in reversed(range(2, phase + 1)):
        b = f"{d}/discriminator_block_{i}"
        f_out = _filters(cfg, i - 1)
        t, _ = _conv_rc(p, f"{b}/residual", q(ops.downscale(x)), f_out, (1, 1, 1), leak, q)
        kernel = ops.adaptive_kernel(x.shape[2:])
        y, rc = _conv_rc(p, f"{b}/conv_1", x, _filters(cfg, i), kernel, leak, q)
        y = q(ops.lrelu(q(_bias_rc(p, f"{b}/conv_1", y, rc)), leak))
        y, rc = _conv_rc(p, f"{b}/conv_2", y, f_out, kernel, leak, q)
        y = q(ops.lrelu(q(_bias_rc(p, f"{b}/conv_2", y, rc)), leak))
        x = q((q(ops.downscale(y)) + t) * inv_gain)
        if i == phase and not (isinstance(alpha, (int, float)) and float(alpha) == 0.0):
            prev = _from_rgb(p, f"{d}/from_rgb_{phase - 1}", q(ops.downscale(image)), f_out,
                             leak, q)
            a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
            x = q(a * prev + (1 - a) * x)
    o = f"{d}/discriminator_out"
    x = q(ops.minibatch_stddev(x))
    y, rc = _conv_rc(p, f"{o}/conv1", x, _filters(cfg, 1), ops.adaptive_kernel(x.shape[2:]),
                     leak, q)
    x = q(ops.lrelu(q(_bias_rc(p, f"{o}/conv1", y, rc)), leak))
    shape = (x[0].numel(), cfg["latent_dim"])
    x = ops.dense(x, ops.weight(p, f"{o}/dense1/weight", shape, "leaky_relu", leak), q)
    x = q(ops.lrelu(q(_bias_rc(p, f"{o}/dense1", x, ops.he_std(shape, "leaky_relu", leak))),
                    leak))
    shape = (x.shape[1], 1)
    x = ops.dense(x, ops.weight(p, f"{o}/dense2/weight", shape, "linear", leak), q)
    return q(_bias_rc(p, f"{o}/dense2", x, ops.he_std(shape, "linear", leak)))


@torch.no_grad()
def refresh_w_average(p: Params, refresh_z, phase: int, cfg: dict) -> torch.Tensor:
    """The new ``generator/d_z_avg``: 0.995 * avg + 0.005 * the batch mean of the first
    style of the mapped refresh latents (float32)."""
    d_z = mapping(p, refresh_z.float(), phase, cfg)
    return 0.995 * p("generator/d_z_avg", (refresh_z.shape[1],)) + 0.005 * d_z[:, 0].mean(0)
