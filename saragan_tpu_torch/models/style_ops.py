"""Style-family building blocks: the mapping network, the modulated conv, style mixing,
truncation and the w-average (counterpart of ``saragan_tpu/models/style_ops.py``).

The modulated conv keeps the reference's formulation (``style_ops.py:82-126`` there): the
activations are scaled by the style s, the plain conv runs with the unmodulated weight
(``ops.conv_apply`` under the step's engine, so under ``flat`` every 3x3x3 modulated conv
runs kernels #1, #1' and #2), and the result is scaled by the demodulation d.  d is
formed in f32 from the f32 weight and the style, and cast at use, as there.

Random inputs are explicit.  Per-layer noise comes from a noise source (``ops.core``)
under the layer's name, ``<scope>/noise`` (the reference's ``layer_rng`` name).  Style
mixing takes a ``StyleMix``: the second latent batch, the coin and the cutoff the
reference draws from its key (``style_mixing``: ``uniform() < prob`` picks the drawn
cutoff in [1, max(phase, 2)), else the family's no-mix cutoff).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from saragan_tpu_torch.core import Scope, zeros_initializer
from saragan_tpu_torch.models.common import conv_at, up_conv_at
from saragan_tpu_torch.ops import core as ops


class StyleMix(NamedTuple):
    """One step's style-mixing draws."""
    z: torch.Tensor       # (N, latent_dim), the second mapping pass's latents
    coin: torch.Tensor    # () U(0, 1): mix when below the family's probability
    cutoff: torch.Tensor  # () int, in [1, max(phase, 2)): the styles below it keep d_z


def maybe_noise(scope: Scope, x: torch.Tensor, noise, name: str) -> torch.Tensor:
    """``ops.apply_noise`` under the layer name ``<scope>/<name>`` when a noise source is
    given; otherwise x, with the strength parameter still read (init and restore see
    it), as the reference does without an rng."""
    if noise is None:
        scope.get("noise_strength", (), zeros_initializer())
        return x
    return ops.apply_noise(scope, x, noise, scope.path(name))


def normalize_latents(z: torch.Tensor) -> torch.Tensor:
    """z * rsqrt(mean(z^2) + 1e-8) over the latent axis, rounded as the reference's."""
    return z * torch.rsqrt(ops.mean_keepdim(torch.square(z), (1,)) + ops.in_dtype(1e-8, z.dtype))


def g_mapping(scope: Scope, z: torch.Tensor, num_styles: int, *, mapping_layers: int = 8,
              mapping_fmaps: Optional[int] = None, mapping_lrmul: float = 0.01,
              activation: str = "leaky_relu", act_param: float = 0.2,
              last_layer_latent: bool = False,
              bias_lrmul: Optional[float] = None) -> torch.Tensor:
    """z -> dlatents broadcast to (N, num_styles, latent_dim).  stylegan: every layer
    latent-sized, bias lrmul 1; stylegan2: hidden layers `mapping_fmaps` wide, the last
    latent-sized, bias lrmul = `bias_lrmul`."""
    m = scope.sub("g_mapping")
    x = normalize_latents(z)
    latent_fmaps = z.shape[1]
    for layer_idx in range(mapping_layers):
        fmaps = latent_fmaps
        if last_layer_latent and mapping_fmaps is not None and layer_idx < mapping_layers - 1:
            fmaps = mapping_fmaps
        d = m.sub(f"dense_{layer_idx}")
        x = ops.dense(d, x, fmaps, activation, lrmul=mapping_lrmul, param=act_param)
        x = ops.apply_bias(d, x, lrmul=bias_lrmul if bias_lrmul is not None else 1.0)
        x = ops.act(x, activation, param=act_param)
    return x[:, None].expand(-1, num_styles, -1)


def modulate(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, *, up: bool = False,
             demodulate: bool = True, fused_transitions: bool = False,
             engine: ops.Engine = "direct", sp=None, res=None) -> torch.Tensor:
    """The modulated conv given the weight w (*kernel, C, F) and the style s (N, C):
    conv(x * s, w) * d (with a nearest 2x upscale before the conv when `up`, fused into
    ``ops.upscale_conv`` under `fused_transitions`), d = rsqrt(sum over the kernel and C
    of (w s)^2 + 1e-8) in f32.  Under a spatial plan `sp` (``models/common.py``) the conv
    of the output's resolution `res` is the halo conv where `res` runs sharded; s and d
    are per (N, C) and (N, F), the same on every slab."""
    r = x.ndim - 2
    d = None
    if demodulate:
        ww = w[None] * s.reshape((s.shape[0],) + (1,) * r + (s.shape[1], 1))
        d = torch.rsqrt(torch.sum(torch.square(ww), dim=tuple(range(1, r + 2))) + 1e-8)
        d = d.reshape(d.shape + (1,) * r)
    x = x * s.reshape(s.shape + (1,) * r).to(x.dtype)
    if up:
        x = up_conv_at(x, w, engine, sp, res, fused_transitions)
    else:
        x = conv_at(x, w, engine, sp, res)
    return x if d is None else x * d.to(x.dtype)


def modulated_conv(scope: Scope, x: torch.Tensor, z: torch.Tensor, fmaps: int, kernel,
                   activation: str, up: bool = False, demodulate: bool = True, param=None,
                   lrmul: float = 1.0, fused_transitions: bool = False,
                   engine: ops.Engine = "direct", sp=None, res=None) -> torch.Tensor:
    """The reference's modulated conv (``style_ops.py:82-126``), rank-generic: the style
    is dense(z) + bias + 1 through the activation, under ``<scope>/modulate``; `sp` and
    `res` as for ``modulate``."""
    kernel = tuple(int(k) for k in kernel)
    w = ops.get_weight(scope, (*kernel, x.shape[1], fmaps), activation, param=param,
                       lrmul=lrmul)
    mod = scope.sub("modulate")
    s = ops.dense(mod, z, fmaps=x.shape[1], activation=activation, param=param)
    s = ops.act(ops.apply_bias(mod, s) + 1, activation, param)
    return modulate(x, w, s, up=up, demodulate=demodulate,
                    fused_transitions=fused_transitions, engine=engine, sp=sp, res=res)


def to_rgb_mod(scope: Scope, x: torch.Tensor, z: torch.Tensor, channels: int = 1,
               engine: ops.Engine = "direct") -> torch.Tensor:
    """Modulated 1x1 to_rgb without demodulation, plus bias."""
    x = modulated_conv(scope, x, z, channels, (1,) * (x.ndim - 2), activation="linear",
                       demodulate=False, engine=engine)
    return ops.apply_bias(scope, x)


def style_mixing(d_z: torch.Tensor, d_z_reg: torch.Tensor, mix: StyleMix, num_styles: int,
                 style_mixing_prob: float, no_mix_cutoff: Optional[int] = None) -> torch.Tensor:
    """Styles at and past the cutoff from the second mapping pass: the drawn cutoff when
    ``mix.coin < style_mixing_prob``, else `no_mix_cutoff` (stylegan v1 passes `phase`,
    stylegan2 and surfgan all `num_styles`, the default).  On the device, no sync."""
    if no_mix_cutoff is None:
        no_mix_cutoff = num_styles
    cutoff = torch.where(mix.coin < style_mixing_prob, mix.cutoff,
                         torch.as_tensor(no_mix_cutoff, device=mix.cutoff.device))
    layer_idx = torch.arange(num_styles, device=d_z.device)[None, :, None]
    return torch.where(layer_idx < cutoff.to(d_z.device), d_z, d_z_reg)


def apply_truncation(d_z: torch.Tensor, d_z_avg: torch.Tensor, num_styles: int,
                     truncation_psi: float, truncation_layers: int) -> torch.Tensor:
    """The truncation trick on the first `truncation_layers` styles.  d_z_avg takes no
    gradient (it is updated only by ``update_dlatent_avg``)."""
    layer_idx = torch.arange(num_styles, device=d_z.device)[None, :, None]
    coefs = torch.where(layer_idx < truncation_layers, truncation_psi, 1.0).to(d_z.dtype)
    return coefs * d_z + (1 - coefs) * d_z_avg.detach().to(d_z.dtype)


@torch.no_grad()
def update_dlatent_avg(params, prefix: str, d_z_first: torch.Tensor, beta: float = 0.995):
    """params with ``<prefix>/d_z_avg`` moved toward the batch mean of `d_z_first` (the
    first style's dlatents): beta * avg + (1 - beta) * mean."""
    key = f"{prefix}/d_z_avg"
    return {**params, key: beta * params[key] + (1 - beta) * torch.mean(d_z_first, dim=0)}
