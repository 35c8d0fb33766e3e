"""GAN losses of the simultaneous G/D step: WGAN-GP and non-saturating logistic, with
instance noise (counterpart of ``saragan_tpu/losses.py:35-333``).

The gradient penalty differentiates the discriminator with respect to its input inside
the loss (``torch.autograd.grad(..., create_graph=True)``), and the step then
differentiates the loss with respect to the discriminator's parameters: grad-of-grad.
Under the ``flat`` engine every conv of that double backward re-enters the hand-written
kernels through ``ops/conv3d_grad.py``.

Random inputs are explicit: ``Draws`` holds the latents, the penalty's interpolation
weights and the instance noise, drawn by ``draw_inputs`` from a ``torch.Generator`` on
the device, or handed in pre-drawn (the parity tests feed the reference's own draws,
``losses.py:237-241,287`` there).

Reference quirk kept: the simultaneous penalty reduces the gradient norm over axes
(1, 2, 3), which for 3-D volumes leaves per-(sample, W-slice) slopes (reference
``loss.py:140``); ``gp_full_reduction=True`` reduces over every non-batch axis.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from saragan_tpu_torch.ops.core import in_dtype

Params = Dict[str, torch.Tensor]


class LossOutput(NamedTuple):
    gen_loss: torch.Tensor
    disc_loss: torch.Tensor
    gp_loss: torch.Tensor
    gen_sample: torch.Tensor


class Draws(NamedTuple):
    """The random inputs of one step, in the compute dtype."""
    z: torch.Tensor                       # (N, latent_dim)
    gamma: Optional[torch.Tensor] = None  # (N, 1, ..., 1) U(0, 1), when the GP runs
    noise_real: Optional[torch.Tensor] = None  # N(0, 1) like real, when noise_stddev
    noise_fake: Optional[torch.Tensor] = None


def draw_inputs(generator: Optional[torch.Generator], n: int, latent_dim: int,
                sample_shape: Sequence[int], dtype: torch.dtype, device, *,
                noise_stddev: float = 0.0, compute_gp: bool = True) -> Draws:
    """One step's draws from `generator` (on `device`), in f32 and then cast to
    `dtype`.  JAX's threefry bits are not reproduced, only the distributions."""
    def normal(shape):
        return torch.randn(shape, generator=generator, device=device).to(dtype)

    z = normal((n, latent_dim))
    gamma = None
    if compute_gp:
        shape = (n,) + (1,) * len(sample_shape)
        gamma = torch.rand(shape, generator=generator, device=device).to(dtype)
    noise_real = noise_fake = None
    if noise_stddev:
        noise_real = normal((n, *sample_shape))
        noise_fake = normal((n, *sample_shape))
    return Draws(z, gamma, noise_real, noise_fake)


def _instance_noise(x: torch.Tensor, noise: Optional[torch.Tensor], noise_stddev: float):
    if noise_stddev:
        return x + noise.to(x.dtype) * in_dtype(noise_stddev, x.dtype)
    return x


def _slopes_from_grads(grads: torch.Tensor, axes) -> torch.Tensor:
    """||g|| over `axes` in f32: the one definition of the penalty's slope norm."""
    return torch.sqrt(torch.sum(torch.square(grads.float()), dim=axes))


def _gp_slopes(disc_fn: Callable, d_params: Params, interp: torch.Tensor, axes):
    """||d D(x)/d x|| over `axes`, itself differentiable (the graph of the input
    gradient is kept for the parameter gradient)."""
    interp = interp.detach().requires_grad_(True)
    score = disc_fn(d_params, interp).sum().float()
    (grads,) = torch.autograd.grad(score, interp, create_graph=True)
    return _slopes_from_grads(grads, axes)


def _simultaneous_axes(ndim: int, full: bool) -> Tuple[int, ...]:
    if full:
        return tuple(range(1, ndim))
    return tuple(a for a in (1, 2, 3) if a < ndim)  # reference loss.py:140, literally


def _interpolates(draws: Draws, real: torch.Tensor, fake_sg: torch.Tensor) -> torch.Tensor:
    gamma = draws.gamma.to(real.dtype)
    return gamma * real + (1 - gamma) * fake_sg


def param_grads(output, params: Params, retain_graph=None):
    """d output / d params as a dict; parameters the output does not reach get zeros,
    as jax.grad gives them."""
    grads = torch.autograd.grad(output, list(params.values()), retain_graph=retain_graph,
                                allow_unused=True, materialize_grads=True)
    return dict(zip(params, grads))


def forward_simultaneous(gen_fn: Callable, disc_fn: Callable, g_params: Params,
                         d_params: Params, real: torch.Tensor, draws: Draws, *,
                         loss_fn: str = "wgan", gp_weight: float = 1.0,
                         noise_stddev: float = 0.0, gp_full_reduction: bool = False,
                         compute_gp: bool = True) -> LossOutput:
    """Joint G+D forward (reference ``forward_simultaneous``): the discriminator's
    terms see a detached fake sample and the generator's term a detached critic, so the
    gradient of gen_loss + disc_loss with respect to (g_params, d_params) is the pair of
    the reference's two separate minimizations.  gen_fn(params, z) -> images,
    disc_fn(params, x) -> (N, 1) scores."""
    gen_sample = gen_fn(g_params, draws.z)
    real = _instance_noise(real, draws.noise_real, noise_stddev)
    fake = _instance_noise(gen_sample, draws.noise_fake, noise_stddev)
    fake_sg = fake.detach()

    disc_fake_d = disc_fn(d_params, fake_sg)
    disc_real = disc_fn(d_params, real)
    if compute_gp:
        axes = _simultaneous_axes(real.ndim, gp_full_reduction)
        slopes = _gp_slopes(disc_fn, d_params, _interpolates(draws, real, fake_sg), axes)
    disc_fake_g = disc_fn({k: v.detach() for k, v in d_params.items()}, fake)

    disc_fake_d, disc_real, disc_fake_g = (s.float() for s in (disc_fake_d, disc_real,
                                                               disc_fake_g))
    zero = torch.zeros((), dtype=torch.float32, device=real.device)
    if loss_fn == "wgan":
        gp_loss = zero
        if compute_gp:
            gp_loss = gp_weight * (slopes - 1.0) ** 2
            if gp_loss.ndim == 1:
                gp_loss = gp_loss[:, None]  # full reduction: pair (N,) with the (N, 1) scores
        drift_loss = 1e-3 * disc_real ** 2
        disc_loss = torch.mean(disc_fake_d - disc_real + gp_loss + drift_loss)
        gen_loss = -torch.mean(disc_fake_g)
    elif loss_fn == "logistic":
        gp_loss = gp_weight * torch.mean(slopes ** 2) if compute_gp else zero
        disc_loss = (torch.mean(F.softplus(disc_fake_d)) + torch.mean(F.softplus(-disc_real))
                     + gp_loss)
        gen_loss = torch.mean(F.softplus(-disc_fake_g))
    else:
        raise ValueError(f"Unknown loss function: {loss_fn}")
    return LossOutput(gen_loss, disc_loss, torch.mean(gp_loss), gen_sample)


def grads_simultaneous(gen_fn: Callable, disc_fn: Callable, g_params: Params,
                       d_params: Params, real: torch.Tensor, draws: Draws, *,
                       gp_weight: float = 1.0, noise_stddev: float = 0.0,
                       gp_full_reduction: bool = False, compute_gp: bool = True,
                       gp_grad_mode: str = "revrev", batched_passes: bool = False,
                       disc_cross_sample: bool = False
                       ) -> Tuple[Tuple[Params, Params], LossOutput]:
    """WGAN simultaneous gradients with the fake critic pass shared (reference
    ``grads_simultaneous``): for the WGAN loss the cotangents of D(fake) in the
    generator's and the discriminator's terms are exactly opposite, so one gradient of
    mean(D(G(z))) with respect to both parameter sets gives g_grads = -that and the
    fake part of d_grads = +that; the real term and the penalty are added to d_grads.

    ``batched_passes`` runs the fake and real critic passes as one discriminator call on
    ``cat([fake, real])``.  The reference vmaps D over a stacked pair; for a
    discriminator with no cross-sample op (pgan's) that is exactly one call at batch 2N.
    A discriminator that mixes samples (a minibatch-stddev layer, ``disc_cross_sample``)
    would need the two passes kept apart, which is not ported: it raises.

    Only ``gp_grad_mode="revrev"`` is ported (reverse over reverse: the penalty's
    parameter gradient differentiates through the inner input gradient).
    Returns ((g_grads, d_grads), LossOutput) with detached values."""
    if gp_grad_mode == "revfwd":
        raise NotImplementedError("gp_grad_mode='revfwd' (reverse over forward) is not "
                                  "ported yet (ROADMAP queue 1 item 3)")
    if gp_grad_mode != "revrev":
        raise ValueError(f"Unknown gp_grad_mode: {gp_grad_mode}")
    n = real.shape[0]
    real = _instance_noise(real, draws.noise_real, noise_stddev)
    both = {**{("g", k): v for k, v in g_params.items()},
            **{("d", k): v for k, v in d_params.items()}}

    gen_sample = gen_fn(g_params, draws.z)
    fake = _instance_noise(gen_sample, draws.noise_fake, noise_stddev)
    if batched_passes:
        if disc_cross_sample:
            raise NotImplementedError("batched_passes with a discriminator that mixes "
                                      "samples keeps the passes apart; not ported yet "
                                      "(ROADMAP queue 1 item 8)")
        scores = disc_fn(d_params, torch.cat([fake, real.to(fake.dtype)])).float()
        fake_score = torch.mean(scores[:n])
        rs = scores[n:]
        real_term = torch.mean(-rs + 1e-3 * torch.square(rs))  # -critic(real) + drift
        joint = param_grads(fake_score + real_term, both)  # the real term has no g path
        greal_d = None
    else:
        fake_score = torch.mean(disc_fn(d_params, fake).float())
        joint = param_grads(fake_score, both)
        rs = disc_fn(d_params, real).float()
        real_term = torch.mean(-rs + 1e-3 * torch.square(rs))
        greal_d = param_grads(real_term, d_params)
    gfake_g = {k: joint[("g", k)] for k in g_params}
    gfake_d = {k: joint[("d", k)] for k in d_params}

    ggp_d = None
    gp_mean = torch.zeros((), dtype=torch.float32, device=real.device)
    if compute_gp:
        axes = _simultaneous_axes(real.ndim, gp_full_reduction)
        slopes = _gp_slopes(disc_fn, d_params, _interpolates(draws, real, fake.detach()), axes)
        gp_mean = torch.mean(gp_weight * (slopes - 1.0) ** 2)
        ggp_d = param_grads(gp_mean, d_params)

    g_grads = {k: -g for k, g in gfake_g.items()}
    terms = [t for t in (gfake_d, greal_d, ggp_d) if t is not None]
    d_grads = {k: sum(t[k] for t in terms) for k in d_params}
    fake_score, real_term, gp_mean = (v.detach() for v in (fake_score, real_term, gp_mean))
    out = LossOutput(-fake_score, fake_score + real_term + gp_mean, gp_mean,
                     gen_sample.detach())
    return (g_grads, d_grads), out
