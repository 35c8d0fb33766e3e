"""GAN losses of the simultaneous G/D step: WGAN-GP and non-saturating logistic, with
instance noise (counterpart of ``saragan_tpu/losses.py:35-333``).

The gradient penalty differentiates the discriminator with respect to its input inside
the loss (``torch.autograd.grad(..., create_graph=True)``), and the step then
differentiates the loss with respect to the discriminator's parameters: grad-of-grad.
Under the ``flat`` engine every conv of that double backward re-enters the hand-written
kernels through ``ops/conv3d_grad.py``.

Random inputs are explicit: ``Draws`` holds the latents, the penalty's interpolation
weights and the instance noise, and for the style families the inputs the reference's
generator draws from its key (the second latents, coin and cutoff of style mixing, the
per-layer noise source) and the step's ``refresh_state`` latents; drawn by
``draw_inputs`` from a ``torch.Generator`` on the device, or handed in pre-drawn (the
parity tests feed the reference's own draws, ``losses.py:237-241,287`` there).  The
losses read z, gamma and the instance noise; the step binds the style draws into the
generator (``train/step.py::model_fns``).  Under data parallelism a step's draws are the
global batch's, and each rank takes its rows (``shard_draws``).

Reference quirk kept: the simultaneous penalty reduces the gradient norm over axes
(1, 2, 3), which for 3-D volumes leaves per-(sample, W-slice) slopes (reference
``loss.py:140``); ``gp_full_reduction=True`` reduces over every non-batch axis.  The
discriminator-only loss of the ``alternate`` strategy (``forward_discriminator``)
reduces over every non-batch axis, as the reference's does.

``gp_disc_fn``, where given, replaces ``disc_fn`` inside the penalty term only: the
same function under another recompute wrapping (``remat_offload`` gives the penalty
plain recompute, as the reference's ``gp_disc`` does).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from saragan_tpu_torch.ops.core import LayerNoise, RankRowsNoise, generator_seed, in_dtype

Params = Dict[str, torch.Tensor]


class LossOutput(NamedTuple):
    gen_loss: torch.Tensor
    disc_loss: torch.Tensor
    gp_loss: torch.Tensor
    gen_sample: torch.Tensor


class Draws(NamedTuple):
    """The random inputs of one step (or micro-batch), in the compute dtype but for
    ``refresh_z`` (f32, as the reference draws it)."""
    z: torch.Tensor                       # (N, latent_dim)
    gamma: Optional[torch.Tensor] = None  # (N, 1, ..., 1) U(0, 1), when the GP runs
    noise_real: Optional[torch.Tensor] = None  # N(0, 1) like real, when noise_stddev
    noise_fake: Optional[torch.Tensor] = None
    # the style families' draws (None for the others):
    z_mix: Optional[torch.Tensor] = None      # (N, latent_dim), style mixing's 2nd latents
    mix_coin: Optional[torch.Tensor] = None   # () U(0, 1)
    mix_cutoff: Optional[torch.Tensor] = None  # () int in [1, max(phase, 2))
    refresh_z: Optional[torch.Tensor] = None  # (64, latent_dim) f32, refresh_state's
    noise: Optional[Callable] = None          # per-layer noise source (ops.core)


REFRESH_BATCH = 64  # latents per refresh_state, as the reference draws


def draw_inputs(generator: Optional[torch.Generator], n: int, latent_dim: int,
                sample_shape: Sequence[int], dtype: torch.dtype, device, *,
                noise_stddev: float = 0.0, compute_gp: bool = True,
                style_phase: Optional[int] = None) -> Draws:
    """One step's draws from `generator` (on `device`), in f32 and then cast to
    `dtype`.  With `style_phase` (a style family's phase) also its style-mixing draws,
    the refresh latents and a ``LayerNoise`` seeded from the generator's state.  JAX's
    threefry bits are not reproduced, only the distributions."""
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
    draws = Draws(z, gamma, noise_real, noise_fake)
    if style_phase is None:
        return draws
    return draws._replace(
        z_mix=normal((n, latent_dim)),
        mix_coin=torch.rand((), generator=generator, device=device),
        mix_cutoff=torch.randint(1, max(style_phase, 2), (), generator=generator,
                                 device=device),
        refresh_z=torch.randn((REFRESH_BATCH, latent_dim), generator=generator,
                              device=device),
        noise=LayerNoise(generator_seed(generator)))


ROW_DRAWS = ("z", "gamma", "noise_real", "noise_fake", "z_mix")


def shard_draws(draws: Draws, mesh) -> Draws:
    """This rank's rows of the global batch's draws under a data-parallel `mesh`
    (``parallel.Mesh``): the per-sample draws' rows (``parallel.shard_rows``), the noise
    source's rows of its global draw (``ops.core.RankRowsNoise``); the mixing coin and
    cutoff and the refresh latents are shared.  `draws` itself without a mesh."""
    if mesh is None or mesh.world_size == 1:
        return draws
    from saragan_tpu_torch.parallel.mesh import shard_rows

    rows = {f: shard_rows(getattr(draws, f), mesh) for f in ROW_DRAWS
            if getattr(draws, f) is not None}
    noise = (None if draws.noise is None
             else RankRowsNoise(draws.noise, mesh.rank, mesh.world_size))
    return draws._replace(**rows, noise=noise)


def _instance_noise(x: torch.Tensor, noise: Optional[torch.Tensor], noise_stddev: float):
    if noise_stddev:
        return x + noise.to(x.dtype) * in_dtype(noise_stddev, x.dtype)
    return x


def _slopes_from_grads(grads: torch.Tensor, axes) -> torch.Tensor:
    """||g|| over `axes` in f32: the one definition of the penalty's slope norm."""
    return torch.sqrt(torch.sum(torch.square(grads.float()), dim=axes))


def _input_grad(disc_fn: Callable, d_params: Params, interp: torch.Tensor,
                create_graph: bool) -> torch.Tensor:
    """d sum(D(x)) / d x at `interp`."""
    interp = interp.detach().requires_grad_(True)
    score = disc_fn(d_params, interp).sum().float()
    (grads,) = torch.autograd.grad(score, interp, create_graph=create_graph)
    return grads


def _gp_slopes(disc_fn: Callable, d_params: Params, interp: torch.Tensor, axes):
    """||d D(x)/d x|| over `axes`, itself differentiable (the graph of the input
    gradient is kept for the parameter gradient)."""
    return _slopes_from_grads(_input_grad(disc_fn, d_params, interp, True), axes)


def _detached(params: Params) -> Params:
    return {k: v.detach() for k, v in params.items()}


def _gp_revfwd(gp_dfn: Callable, d_params: Params, interp: torch.Tensor, axes,
               gp_weight: float):
    """The penalty and its parameter gradient by the reference's ``revfwd`` algebra
    (``saragan_tpu/losses.py:211-233``): with g = dD/dx at the interpolates and P(g) the
    mean penalty, dP/dtheta = (dg/dtheta)^T c for the frozen cotangent c = P'(g), so the
    gradient is that of the directional derivative <dD/dx, c> with respect to the
    parameters.  The reference forms that directional derivative in forward mode
    (``jax.jvp``); the kernels' autograd Functions have no forward mode, so here it is the
    contraction of a ``create_graph`` input gradient with c, whose parameter gradient is
    the same function: one D forward and input backward, as ``revrev``'s.  Returns
    (penalty, {name: gradient})."""
    gx = _input_grad(gp_dfn, d_params, interp, True)
    g = gx.detach().requires_grad_(True)
    penalty = torch.mean(gp_weight * (_slopes_from_grads(g, axes) - 1.0) ** 2)
    (c,) = torch.autograd.grad(penalty, g)
    c = c.to(interp.dtype)
    directional = torch.sum(gx.float() * c.float())
    return penalty.detach(), param_grads(directional, d_params)


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
                         compute_gp: bool = True,
                         gp_disc_fn: Optional[Callable] = None) -> LossOutput:
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
        slopes = _gp_slopes(gp_disc_fn or disc_fn, d_params,
                            _interpolates(draws, real, fake_sg), axes)
    disc_fake_g = disc_fn(_detached(d_params), fake)

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
                       gp_disc_fn: Optional[Callable] = None
                       ) -> Tuple[Tuple[Params, Params], LossOutput]:
    """WGAN simultaneous gradients with the fake critic pass shared (reference
    ``grads_simultaneous``): for the WGAN loss the cotangents of D(fake) in the
    generator's and the discriminator's terms are exactly opposite, so one gradient of
    mean(D(G(z))) with respect to both parameter sets gives g_grads = -that and the
    fake part of d_grads = +that; the real term and the penalty are added to d_grads.

    ``batched_passes`` runs the fake and real critic passes as one discriminator call on
    ``cat([fake, real])`` with ``passes=2``.  The reference vmaps D over a stacked pair;
    for a discriminator with no cross-sample op (pgan's) that is exactly one call at batch
    2N, and it ignores `passes`.  A discriminator that mixes samples (surfgan's
    minibatch-stddev head) forms its groups inside each half, as under the reference's
    vmap.  The penalty's D runs on the N interpolates as
    one batch and keeps its cross-sample terms, as the reference's does.

    ``gp_grad_mode``: "revrev" (reverse over reverse: the penalty's parameter gradient
    differentiates through the inner input gradient) or "revfwd" (``_gp_revfwd``); both
    exact, summed in other orders.
    Returns ((g_grads, d_grads), LossOutput) with detached values."""
    if gp_grad_mode not in ("revrev", "revfwd"):
        raise ValueError(f"Unknown gp_grad_mode: {gp_grad_mode}")
    n = real.shape[0]
    real = _instance_noise(real, draws.noise_real, noise_stddev)
    both = {**{("g", k): v for k, v in g_params.items()},
            **{("d", k): v for k, v in d_params.items()}}

    gen_sample = gen_fn(g_params, draws.z)
    fake = _instance_noise(gen_sample, draws.noise_fake, noise_stddev)
    if batched_passes:
        stacked = torch.cat([fake, real.to(fake.dtype)])
        scores = disc_fn(d_params, stacked, passes=2).float()
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
        interp = _interpolates(draws, real, fake.detach())
        if gp_grad_mode == "revfwd":
            gp_mean, ggp_d = _gp_revfwd(gp_disc_fn or disc_fn, d_params, interp, axes,
                                        gp_weight)
        else:
            slopes = _gp_slopes(gp_disc_fn or disc_fn, d_params, interp, axes)
            gp_mean = torch.mean(gp_weight * (slopes - 1.0) ** 2)
            ggp_d = param_grads(gp_mean, d_params)

    g_grads = {k: -g for k, g in gfake_g.items()}
    terms = [t for t in (gfake_d, greal_d, ggp_d) if t is not None]
    d_grads = {k: sum(t[k] for t in terms) for k in d_params}
    fake_score, real_term, gp_mean = (v.detach() for v in (fake_score, real_term, gp_mean))
    out = LossOutput(-fake_score, fake_score + real_term + gp_mean, gp_mean,
                     gen_sample.detach())
    return (g_grads, d_grads), out


def forward_generator(gen_fn: Callable, disc_fn: Callable, g_params: Params,
                      d_params: Params, draws: Draws, *, loss_fn: str = "wgan",
                      noise_stddev: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generator-only forward of the ``alternate`` strategy (reference
    ``forward_generator``): the critic's parameters detached.  Uses ``draws.z`` and
    ``draws.noise_fake``.  Returns (gen_sample, gen_loss)."""
    gen_sample = gen_fn(g_params, draws.z)
    fake = _instance_noise(gen_sample, draws.noise_fake, noise_stddev)
    disc_fake_g = disc_fn(_detached(d_params), fake).float()
    if loss_fn == "wgan":
        gen_loss = -torch.mean(disc_fake_g)
    elif loss_fn == "logistic":
        gen_loss = torch.mean(F.softplus(-disc_fake_g))
    else:
        raise ValueError(f"Unknown loss function: {loss_fn}")
    return gen_sample, gen_loss


def forward_discriminator(gen_fn: Callable, disc_fn: Callable, g_params: Params,
                          d_params: Params, real: torch.Tensor, draws: Draws, *,
                          loss_fn: str = "wgan", gp_weight: float = 1.0,
                          noise_stddev: float = 0.0, compute_gp: bool = True,
                          gp_disc_fn: Optional[Callable] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discriminator-only forward of the ``alternate`` strategy (reference
    ``forward_discriminator``): the generator's sample without a graph, the penalty's
    norm over every non-batch axis.  Returns (disc_loss, gp_loss)."""
    with torch.no_grad():
        gen_sample = gen_fn(_detached(g_params), draws.z)
    real = _instance_noise(real, draws.noise_real, noise_stddev)
    fake = _instance_noise(gen_sample, draws.noise_fake, noise_stddev)
    disc_fake_d = disc_fn(d_params, fake).float()
    disc_real = disc_fn(d_params, real).float()
    zero = torch.zeros((), dtype=torch.float32, device=real.device)
    if compute_gp:
        axes = tuple(range(1, real.ndim))
        slopes = _gp_slopes(gp_disc_fn or disc_fn, d_params, _interpolates(draws, real, fake),
                            axes)
    if loss_fn == "wgan":
        gp_term = gp_out = zero
        if compute_gp:
            gp_loss = gp_weight * (slopes - 1.0) ** 2
            gp_term, gp_out = gp_loss[:, None], torch.mean(gp_loss)
        disc_loss = torch.mean(disc_fake_d - disc_real + gp_term + 1e-3 * disc_real ** 2)
    elif loss_fn == "logistic":
        gp_out = gp_weight * torch.mean(slopes ** 2) if compute_gp else zero
        disc_loss = (torch.mean(F.softplus(disc_fake_d)) + torch.mean(F.softplus(-disc_real))
                     + gp_out)
    else:
        raise ValueError(f"Unknown loss function: {loss_fn}")
    return disc_loss, gp_out
