"""The training step (counterpart of ``saragan_tpu/train/step.py``).

One step of the simultaneous G/D update: the losses' gradients with respect to both
parameter sets, optional global-norm clipping per network (with per-variable norms
reported on the clipped gradients), the configured optimizer (any of the eight of
``optim/factory.py``) with ``-lr * u`` applied at update time, and the EMA over G+D.  Two gradient paths, as in the reference:

* ``fused_grads`` with the WGAN loss (the flagship): ``losses.grads_simultaneous``, one
  discriminator backward over the fake batch for both networks, the fake and real
  critic passes stacked into one call when ``batched_passes``;
* otherwise ``losses.forward_simultaneous`` and one gradient of gen_loss + disc_loss
  (the logistic loss always takes this path).

Numerics: parameters, gradients, optimizer state and EMA are f32; with
``compute_dtype="bfloat16"`` the batch and latents are bf16 and the models cast weights
to the activation dtype at use (no autocast).  Library convs (the ``direct`` engine, the
polyphase transitions) run under deterministic cuDNN with TF32 off, as serving does,
and matmuls with TF32 off (``_train_numerics``).

Previous-phase freezing (``freeze`` with ``frozen_names``): frozen parameters and their
optimizer slots keep their old values, and the clip norm and every gradient statistic cover
only the other names.  ``grad_histograms``: the step also returns per-variable 64-bin
gradient histograms, binned on the device (the trainer's variant for summary steps).

``optim_strategy="alternate"`` (reference ``saragan_tpu/train/step.py:306-365``): the
discriminator's step first (``losses.forward_discriminator``), then the generator's
against the updated discriminator (``losses.forward_generator``).

Memory levers, as the reference wraps its model closures (``step.py:189-220``):

* ``remat``: G and D each one recompute region (non-reentrant
  ``torch.utils.checkpoint``): the backward recomputes their forwards;
* ``remat_offload``: the models' own regions between block boundaries
  (``models/common.py``) under the ``offload_taps`` scope, so the tensors kept from
  forward to backward are the block taps, parked in pinned host memory; the penalty's
  D call gets plain recompute instead (``gp_disc_fn``), as the reference's ``gp_disc``;
* ``gradient_accumulation`` K > 1: K micro-batches, gradients and reported scalars
  averaged in f32 (``optim/accumulate.py``), one optimizer apply.

Recompute runs the same deterministic kernels on the same inputs, and the style
families' noise source redraws each layer's noise from its own seeded generator, so a
step under either lever is bit-equal to the plain step.  After the updates, in the
reference's order (``step.py:367-385``): the style families' ``refresh_state`` moves
``generator/d_z_avg`` from the draws' 64 refresh latents (its gradient is exactly 0, so
only a weight decay moves it in the update; the EMA averages it); under
``use_spectral_norm`` every ``*_u`` vector of D is power-iterated against its new
weight (``ops.core.refresh_spectral_u``); then the EMA.

The step builds its graph eagerly and makes no host synchronisation: losses and metrics
come back as device tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, FrozenSet, List, NamedTuple, Optional, Sequence, Tuple

import torch

from saragan_tpu_torch import losses
from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.core import Params, filter_params
from saragan_tpu_torch.models.common import offload_taps, recompute
from saragan_tpu_torch.models.style_ops import StyleMix
from saragan_tpu_torch.ops.core import refresh_spectral_u
from saragan_tpu_torch.optim.accumulate import grad_accumulate, split_microbatches
from saragan_tpu_torch.optim.ema import ema_init, ema_update
from saragan_tpu_torch.optim.factory import Optimizer, make_optimizers_from_config
from saragan_tpu_torch.optim.freeze import freeze_select
from saragan_tpu_torch.parallel.mesh import (allreduce_mean_, allreduce_min, gather_rows,
                                             shard_rows, world_size)

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}


class TrainState(NamedTuple):
    g_params: Params
    d_params: Params
    g_opt: Any
    d_opt: Any
    ema: Params  # over G+D


class StepMetrics(NamedTuple):
    gen_loss: torch.Tensor
    disc_loss: torch.Tensor
    gp_loss: torch.Tensor
    max_g_norm: torch.Tensor
    max_d_norm: torch.Tensor
    g_norms: Optional[Dict[str, torch.Tensor]] = None
    d_norms: Optional[Dict[str, torch.Tensor]] = None
    # per-variable 64-bin gradient histograms {name: (counts, edges)}, on the device
    g_hists: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
    d_hists: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
    fake_min: Optional[torch.Tensor] = None
    fake_max: Optional[torch.Tensor] = None
    real_min: Optional[torch.Tensor] = None
    real_max: Optional[torch.Tensor] = None


def compute_dtype(cfg) -> torch.dtype:
    return _COMPUTE_DTYPES.get(cfg.compute_dtype, torch.float32)


def split_params(params: Params) -> Tuple[Params, Params]:
    return filter_params(params, "generator"), filter_params(params, "discriminator")


def init_train_state(arch, rng: torch.Generator, *, phase: int, cfg,
                     device=None) -> Tuple[TrainState, Tuple[Optimizer, Optimizer]]:
    """Parameters from the port's seeded init on `device` (CUDA unless named), optimizer
    state and EMA; returns (state, (g_optimizer, d_optimizer))."""
    params = arch.init(rng, phase=phase, cfg=cfg, device=resolve_device(device))
    g_params, d_params = split_params(params)
    g_optimizer, d_optimizer = make_optimizers_from_config(cfg)
    state = TrainState(g_params, d_params, g_optimizer.init(g_params),
                       d_optimizer.init(d_params), ema_init({**g_params, **d_params}))
    return state, (g_optimizer, d_optimizer)


def histogram(g: torch.Tensor, bins: int = 64):
    """``jnp.histogram(g, bins)`` on the device.  The edges are ``linspace(min, max,
    bins + 1)`` computed as XLA computes them: ``lo * (1 - i/bins)`` rounded to f32, then
    ``+ hi * i/bins`` with one rounding (a fused multiply-add), the last edge exactly the
    maximum; a constant tensor gets the range min +- 0.5.  Bin i counts
    edges[i] <= v < edges[i + 1], the last bin also v == max.  ``torch.histc`` places
    values by its own arithmetic, so a value next to an edge could land in the other bin;
    ``bucketize`` against the edges is the reference's ``searchsorted(side='right')``.
    Returns (counts f32, edges f32)."""
    v = g.detach().reshape(-1).float()
    lo, hi = torch.min(v), torch.max(v)
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    step = torch.arange(bins, dtype=torch.float32, device=v.device) / bins
    head = (lo * (1 - step)).double() + hi.double() * step.double()
    edges = torch.cat([head.float(), hi.reshape(1)])
    idx = torch.bucketize(v, edges, right=True)
    idx = torch.where(v == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1].float()
    return counts, edges


@torch.no_grad()
def _clip_and_norms(grads: Params, clipping: bool, hist_bins: int = 0,
                    frozen: FrozenSet[str] = frozenset()):
    """Optional global-norm-1 clip, then per-variable norms of the (clipped) gradients
    and their maximum, and with `hist_bins` per-variable histograms.  The clip norm and
    every statistic cover only the names not in `frozen` (the reference clips over the
    limited variable list of its freeze path)."""
    live = [k for k in grads if k not in frozen]
    if clipping:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k])) for k in live))
        scale = torch.clamp(1.0 / (gnorm + 1e-16), max=1.0)
        grads = {k: (g * scale if k not in frozen else g) for k, g in grads.items()}
    norms = {k: torch.linalg.vector_norm(grads[k].reshape(-1)) for k in live}
    hists = {k: histogram(grads[k], hist_bins) for k in live} if hist_bins else None
    return grads, torch.max(torch.stack(list(norms.values()))), norms, hists


@contextlib.contextmanager
def _train_numerics():
    """Deterministic cuDNN, no TF32 in convs or matmuls; restored on exit."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _check_options(cfg):
    if cfg.optim_strategy not in ("simultaneous", "alternate"):
        raise ValueError(f"Unknown optim strategy {cfg.optim_strategy}")
    if int(cfg.gradient_accumulation) < 1:
        raise ValueError(f"gradient_accumulation must be >= 1; got {cfg.gradient_accumulation}")


def _remat(fn):
    """``fn(params, x, **kw)`` as one recompute region (params from the call's
    closure)."""
    def wrapped(params, x, **kw):
        return recompute(lambda t: fn(params, t, **kw), x)

    return wrapped


def style_phase(arch, phase: int) -> Optional[int]:
    """`phase` for a style family (one with a w-average to refresh: it also draws
    per-layer noise and style-mixing inputs each step), else None: the ``style_phase``
    of ``losses.draw_inputs``."""
    return phase if arch.refresh_state is not None else None


def model_fns(arch, cfg, phase: int, alpha, conv_engine: str,
              draws: Optional[losses.Draws] = None, mesh=None):
    """(gen_fn, disc_fn, gp_disc_fn) of one step at `alpha` (a number or a 0-dim
    tensor), wrapped as the memory levers of `cfg` ask; gp_disc_fn is None where the
    penalty uses disc_fn.  gen_fn(p, z) runs in training mode with the style draws of
    `draws` (its noise source and style mixing; none without draws);
    disc_fn(p, x, passes=1) over this rank's rows of a data-parallel `mesh`'s batch."""
    mix = None
    if draws is not None and draws.z_mix is not None:
        mix = StyleMix(draws.z_mix, draws.mix_coin, draws.mix_cutoff)
    noise = None if draws is None else draws.noise

    def wrap(c):
        def gen_fn(p, z):
            return arch.generator(p, z, alpha, phase=phase, cfg=c, conv_engine=conv_engine,
                                  noise=noise, mix=mix)

        def disc_fn(p, x, passes=1):
            return arch.discriminator(p, x, alpha, phase=phase, cfg=c, conv_engine=conv_engine,
                                      passes=passes, mesh=mesh)

        return gen_fn, disc_fn

    gen_fn, disc_fn = wrap(cfg)
    if cfg.remat_offload:
        # the penalty's D: the same function without the block regions, one plain
        # recompute region (its double backward keeps nothing on the host)
        return gen_fn, disc_fn, _remat(wrap(dataclasses.replace(cfg, remat_offload=False))[1])
    if cfg.remat:
        return _remat(gen_fn), _remat(disc_fn), None
    return gen_fn, disc_fn, None


@contextlib.contextmanager
def _lever_scope(cfg, record: List):
    """The offload scope under ``remat_offload`` (its ``ParkedTaps`` appended to
    `record`), else nothing."""
    if not cfg.remat_offload:
        yield
        return
    with offload_taps() as parked:
        record.append(parked)
        yield


def make_grads_fn(arch, cfg, phase: int, apply_gp: bool = True,
                  static_alpha: Optional[float] = None, *, conv_engine: str = "direct",
                  mesh=None):
    """The gradient half of the simultaneous train step for one (micro-)batch:
    ``grads(g_params, d_params, real, draws, alpha) -> ((g_grads, d_grads), LossOutput)``
    with `real` in the compute dtype and the draws given; arguments as for
    ``make_train_step``.  ``grads.parked`` lists the ``ParkedTaps`` of each call under
    ``remat_offload`` (the caller may clear it)."""
    lazy_k = max(1, int(cfg.lazy_gp))
    gp_weight = cfg.gp_weight * lazy_k if apply_gp else 0.0
    fused = cfg.loss_fn == "wgan" and cfg.fused_grads

    def grads_fn(g_params: Params, d_params: Params, real: torch.Tensor,
                 draws: losses.Draws, alpha):
        a = torch.tensor(float(alpha)) if static_alpha is None else static_alpha
        gen_fn, disc_fn, gp_disc_fn = model_fns(arch, cfg, phase, a, conv_engine, draws, mesh)
        g_p = {k: v.detach().requires_grad_(True) for k, v in g_params.items()}
        d_p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        common = dict(gp_weight=gp_weight, noise_stddev=cfg.noise_stddev,
                      gp_full_reduction=cfg.gp_full_reduction, compute_gp=apply_gp,
                      gp_disc_fn=gp_disc_fn)
        with _train_numerics(), _lever_scope(cfg, grads_fn.parked):
            if fused:
                return losses.grads_simultaneous(
                    gen_fn, disc_fn, g_p, d_p, real, draws, gp_grad_mode=cfg.gp_grad_mode,
                    batched_passes=cfg.batched_passes, **common)
            out = losses.forward_simultaneous(gen_fn, disc_fn, g_p, d_p, real, draws,
                                              loss_fn=cfg.loss_fn, **common)
            grads = losses.param_grads(out.gen_loss + out.disc_loss, {**g_p, **d_p})
        return (({k: grads[k] for k in g_p}, {k: grads[k] for k in d_p}),
                losses.LossOutput(*(v.detach() for v in out)))

    grads_fn.parked = []
    return grads_fn


def _alternate_grads_fns(arch, cfg, phase: int, apply_gp: bool,
                         static_alpha: Optional[float], conv_engine: str, parked: List,
                         mesh=None):
    """The two gradient halves of the ``alternate`` strategy for one (micro-)batch:
    ``d_grads(g_params, d_params, real, draws, alpha) -> (grads, (disc_loss, gp_loss))``
    and ``g_grads(g_params, d_params, draws, alpha) -> (grads, (gen_loss, (min, max)))``
    of the fake sample."""
    gp_weight = cfg.gp_weight * max(1, int(cfg.lazy_gp)) if apply_gp else 0.0

    def fns(alpha, draws):
        a = torch.tensor(float(alpha)) if static_alpha is None else static_alpha
        return model_fns(arch, cfg, phase, a, conv_engine, draws, mesh)

    def d_grads(g_params, d_params, real, draws, alpha):
        gen_fn, disc_fn, gp_disc_fn = fns(alpha, draws)
        d_p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        with _train_numerics(), _lever_scope(cfg, parked):
            disc_loss, gp_loss = losses.forward_discriminator(
                gen_fn, disc_fn, g_params, d_p, real, draws, loss_fn=cfg.loss_fn,
                gp_weight=gp_weight, noise_stddev=cfg.noise_stddev, compute_gp=apply_gp,
                gp_disc_fn=gp_disc_fn)
            grads = losses.param_grads(disc_loss, d_p)
        return grads, (disc_loss.detach(), gp_loss.detach())

    def g_grads(g_params, d_params, draws, alpha):
        gen_fn, disc_fn, _ = fns(alpha, draws)
        g_p = {k: v.detach().requires_grad_(True) for k, v in g_params.items()}
        with _train_numerics(), _lever_scope(cfg, parked):
            sample, gen_loss = losses.forward_generator(gen_fn, disc_fn, g_p, d_params, draws,
                                                        loss_fn=cfg.loss_fn,
                                                        noise_stddev=cfg.noise_stddev)
            grads = losses.param_grads(gen_loss, g_p)
        sample = sample.detach()
        return grads, (gen_loss.detach(), (torch.min(sample), torch.max(sample)))

    return d_grads, g_grads


def micro_draws(draws, num_micro: int) -> Sequence[losses.Draws]:
    """A step's draws as one ``losses.Draws`` per micro-batch: a sequence as given, or
    one batch's ``Draws`` split into `num_micro`: the per-sample draws along the batch,
    the noise source by its ``chunk``, the mixing coin and cutoff shared, the refresh
    latents with the first part (the step reads them there)."""
    if not isinstance(draws, losses.Draws):
        return list(draws)
    if num_micro == 1:
        return [draws]
    parts = {f: getattr(draws, f).chunk(num_micro) for f in losses.ROW_DRAWS
             if getattr(draws, f) is not None}
    noise = None if draws.noise is None else draws.noise.chunk(num_micro)
    return [draws._replace(**{f: p[k] for f, p in parts.items()},
                           noise=None if noise is None else noise[k],
                           refresh_z=draws.refresh_z if k == 0 else None)
            for k in range(num_micro)]


def make_train_step(arch, cfg, phase: int, g_optimizer: Optimizer, d_optimizer: Optimizer,
                    frozen_names: FrozenSet[str] = frozenset(), freeze: bool = False,
                    apply_gp: bool = True, grad_histograms: bool = False,
                    static_alpha: Optional[float] = None, *, conv_engine: str = "direct",
                    mesh=None):
    """The train step for one phase:
    ``step(state, real, rng, alpha, g_lr, d_lr, draws=None) -> (state, StepMetrics)``.

    `rng` is a ``torch.Generator`` on the batch's device that draws the latents, the
    penalty's interpolation weights, the instance noise and a style family's draws,
    unless `draws` hands them in: a ``losses.Draws`` of the batch, or one per
    micro-batch under ``gradient_accumulation``; under ``optim_strategy="alternate"`` a
    pair (the discriminator's, the generator's), each of those forms.  A style family's
    ``refresh_state`` takes the refresh latents of the (generator's) first micro-batch.
    `alpha`, `g_lr` and `d_lr` are per-step numbers.

    static_alpha: bind alpha as a Python constant.  With ``static_alpha=0.0`` the models
    skip the phase-transition branches, which contribute exactly 0 in the stabilizing
    half of a phase (their parameters get zero gradients, as in the reference).
    Otherwise alpha goes in as a 0-dim tensor and the branches always run, as the
    reference's traced alpha does.  `conv_engine` is "direct" (cuDNN) or "flat" (the
    hand-written kernels).  Under ``remat_offload`` ``step.parked_bytes`` is what the
    last step parked in host memory.

    `mesh` (a ``parallel.Mesh``): data parallelism.  `real` is then this rank's rows of
    the global batch (rank-major), and the draws, drawn or given, are the global batch's,
    of which each rank takes its rows (``losses.shard_draws``).  Under accumulation,
    micro-batch k is the global batch's k-th contiguous slice, as the reference splits its
    global array, and its draws are that slice's: each rank takes its rows of both (the
    real rows regathered by one all-gather of the batch per step).  After the
    micro-batches, one ``parallel.allreduce_mean_`` averages the G and D gradients and
    the reported losses over the ranks (the generated sample's min and max are the
    global ones; the real batch's first sample is each rank's own), before clipping,
    freezing, the optimizer and the EMA, so every rank applies the same update.  Models are not wrapped in ``DistributedDataParallel``:
    its hooks follow ``backward()``, and the step takes its gradients with
    ``torch.autograd.grad``."""
    _check_options(cfg)
    dtype = compute_dtype(cfg)
    frozen = frozenset(frozen_names) if freeze else frozenset()
    hist_bins = 64 if grad_histograms else 0
    accum = int(cfg.gradient_accumulation)
    alternate = cfg.optim_strategy == "alternate"
    world = world_size(mesh)
    grads_fn = make_grads_fn(arch, cfg, phase, apply_gp, static_alpha,
                             conv_engine=conv_engine, mesh=mesh)
    parked = grads_fn.parked
    if alternate:
        d_grads_fn, g_grads_fn = _alternate_grads_fns(arch, cfg, phase, apply_gp, static_alpha,
                                                      conv_engine, parked, mesh)

    def apply_updates(optimizer, params, opt_state, grads, lr, clipping):
        grads, max_norm, norms, hists = _clip_and_norms(grads, clipping, hist_bins, frozen)
        new_params, new_opt = optimizer.update(grads, opt_state, params, lr)
        return (freeze_select(params, new_params, frozen),
                freeze_select(opt_state, new_opt, frozen), max_norm, norms, hists)

    def draw(rng, n, real, compute_gp):
        """The global batch's draws, one per micro-batch."""
        return [losses.draw_inputs(rng, n * world // accum, cfg.latent_dim, real.shape[1:],
                                   dtype, real.device, noise_stddev=cfg.noise_stddev,
                                   compute_gp=compute_gp,
                                   style_phase=style_phase(arch, phase))
                for _ in range(accum)]

    def rank_draws(draws):
        return [losses.shard_draws(d, mesh) for d in micro_draws(draws, accum)]

    def rank_micro_rows(real):
        """This rank's rows of each global micro-batch, concatenated in micro-batch
        order (so that ``split_microbatches`` of the result gives them back)."""
        if world == 1 or accum == 1:
            return real
        split_microbatches(real, accum)  # the per-process batch must split
        micro = split_microbatches(gather_rows(real, mesh), accum)
        return torch.cat([shard_rows(m, mesh) for m in micro])

    def dp_reduce(grads, loss_terms, minmax=None):
        """The gradient dicts (G and D, or one) and the loss scalars averaged over the
        ranks in one all-reduce; (min, max) of the sample over the ranks."""
        if mesh is None:
            return grads, loss_terms, minmax
        merged = {k: v for g in grads for k, v in g.items()}
        merged["step/losses"] = torch.stack([t.float() for t in loss_terms])
        allreduce_mean_(merged, mesh)
        grads = tuple({k: merged[k] for k in g} for g in grads)
        loss_terms = tuple(merged["step/losses"].unbind())
        if minmax is not None:
            lo, hi = minmax
            both = allreduce_min(torch.stack([lo.float(), -hi.float()]), mesh)
            minmax = (both[0].to(lo.dtype), (-both[1]).to(hi.dtype))
        return grads, loss_terms, minmax

    def train_step(state: TrainState, real: torch.Tensor, rng: Optional[torch.Generator],
                   alpha, g_lr, d_lr, draws=None):
        real = real.to(dtype)
        n = real.shape[0]
        micro_real = rank_micro_rows(real)
        parked.clear()
        if alternate:
            d_draws, g_draws = (draws if draws is not None else
                                (draw(rng, n, real, apply_gp), draw(rng, n, real, False)))
            d_draws, g_draws = rank_draws(d_draws), rank_draws(g_draws)
            refresh_z = g_draws[0].refresh_z

            def d_micro(mb, dr):
                return d_grads_fn(state.g_params, state.d_params, mb, dr, alpha)

            def d_reduce(out):
                grads, (disc, gp) = out
                (grads,), (disc, gp), _ = dp_reduce((grads,), (disc, gp))
                return grads, (disc, gp)

            d_grads, (disc_loss, gp_loss) = grad_accumulate(d_micro, micro_real, d_draws,
                                                            accum, d_reduce)
            with torch.no_grad():
                d_params, d_opt, max_d_norm, d_norms, d_hists = apply_updates(
                    d_optimizer, state.d_params, state.d_opt, d_grads, d_lr, cfg.d_clipping)

            def g_micro(mb, dr):
                return g_grads_fn(state.g_params, d_params, dr, alpha)

            def g_reduce(out):
                grads, (gen, minmax) = out
                (grads,), (gen,), minmax = dp_reduce((grads,), (gen,), minmax)
                return grads, (gen, minmax)

            # G trains against the updated discriminator
            g_grads, (gen_loss, (fake_min, fake_max)) = grad_accumulate(
                g_micro, real, g_draws, accum, g_reduce)
            with torch.no_grad():
                g_params, g_opt, max_g_norm, g_norms, g_hists = apply_updates(
                    g_optimizer, state.g_params, state.g_opt, g_grads, g_lr, cfg.g_clipping)
        else:
            def micro(mb, dr):
                grads, out = grads_fn(state.g_params, state.d_params, mb, dr, alpha)
                return grads, (out.gen_loss, out.disc_loss, out.gp_loss,
                               torch.min(out.gen_sample), torch.max(out.gen_sample))

            def reduce(out):
                grads, (gen, disc, gp, lo, hi) = out
                grads, (gen, disc, gp), (lo, hi) = dp_reduce(grads, (gen, disc, gp), (lo, hi))
                return grads, (gen, disc, gp, lo, hi)

            draws = rank_draws(draw(rng, n, real, apply_gp) if draws is None else draws)
            refresh_z = draws[0].refresh_z
            (g_grads, d_grads), (gen_loss, disc_loss, gp_loss, fake_min, fake_max) = (
                grad_accumulate(micro, micro_real, draws, accum, reduce))
            with torch.no_grad():
                g_params, g_opt, max_g_norm, g_norms, g_hists = apply_updates(
                    g_optimizer, state.g_params, state.g_opt, g_grads, g_lr, cfg.g_clipping)
                d_params, d_opt, max_d_norm, d_norms, d_hists = apply_updates(
                    d_optimizer, state.d_params, state.d_opt, d_grads, d_lr, cfg.d_clipping)

        with torch.no_grad():
            if arch.refresh_state is not None:
                g_params = arch.refresh_state(g_params, refresh_z, phase=phase, cfg=cfg)
            if cfg.use_spectral_norm:
                d_params = refresh_spectral_u(d_params, iterations=int(cfg.spectral_iterations))
            ema = ema_update(state.ema, {**g_params, **d_params}, cfg.ema_beta)
            metrics = StepMetrics(gen_loss, disc_loss, gp_loss, max_g_norm, max_d_norm,
                                  g_norms, d_norms, g_hists, d_hists, fake_min, fake_max,
                                  torch.min(real[0]), torch.max(real[0]))
        train_step.parked_bytes = sum(p.nbytes for p in parked)
        return TrainState(g_params, d_params, g_opt, d_opt, ema), metrics

    train_step.parked_bytes = 0
    return train_step
