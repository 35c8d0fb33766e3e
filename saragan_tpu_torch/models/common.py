"""Shared model helpers: the static-alpha test, the num_filters-table sizing of the
families after pgan (counterpart of ``saragan_tpu/models/common.py:78-108``), and the
block boundaries and recompute regions of ``remat_offload`` (``:41-74`` there).

Under ``cfg.remat_offload`` a model's forward is a chain of recompute regions
(``segment``), each running from one block boundary to the next, and ``block_tap`` marks
each boundary tensor with its name.  A region is a non-reentrant
``torch.utils.checkpoint``: autograd keeps only its inputs and recomputes everything
inside it in the backward, one region at a time.  Inside the train step's
``offload_taps`` scope the inputs that are block taps are parked in pinned host memory
between the forward and the backward and copied back when their region is recomputed;
every other kept input (the latents, the images, the parameters) stays where it is.  So
the tensors kept from forward to backward are the block taps, on the host, as under the
reference's ``save_and_offload_only_these_names`` policy; the peak on the device is about
one region's working set.  Without ``remat_offload``, ``segment`` calls its function and
``block_tap`` is the identity.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from saragan_tpu_torch.core import Scope
from saragan_tpu_torch.ops.core import num_filters, num_filters_2d


def static_alpha_zero(alpha) -> bool:
    """True when alpha is a Python 0: the models then skip the phase-transition branch
    (previous-resolution to_rgb and blend), which contributes exactly 0 there."""
    return isinstance(alpha, (int, float)) and float(alpha) == 0.0


def adaptive_kernel(spatial_shape) -> List[int]:
    """Per-axis kernel size: 1 where the axis is shorter than 3, else 3."""
    return [1 if s < 3 else 3 for s in spatial_shape]


def phase_filters(cfg, i: int) -> int:
    """Filters at phase `i` from the num_filters tables of the network size."""
    size = cfg.network_size or "xs"
    if cfg.ndim == 3:
        return num_filters(i, cfg.num_phases, cfg.base_shape, size=size)
    return num_filters_2d(i, cfg.num_phases, size=size)


def resolve_base_dim(cfg) -> int:
    """Filters of the first (constant or dense) layer: ``cfg.first_conv_nfilters``, else
    the table's entry at phase 1."""
    if cfg.first_conv_nfilters:
        return int(cfg.first_conv_nfilters)
    return phase_filters(cfg, 1)


def spectral_iters(cfg) -> int:
    """Power iterations of the discriminator's scope: 0 (off) unless
    ``cfg.use_spectral_norm`` (reference ``saragan_tpu/models/common.py:96-101``)."""
    if getattr(cfg, "use_spectral_norm", False):
        return max(1, int(getattr(cfg, "spectral_iterations", 3)))
    return 0


def init_from_shape_passes(g_pass, d_pass, rng: torch.Generator, *, phase: int, cfg,
                           device):
    """The full G+D parameters for `phase`: `g_pass(scope, z)` and `d_pass(scope, x)`
    run once each on the meta device (shapes only, no graph, so no recompute region)
    with init-mode scopes, which create every parameter they read on `device`, each from
    a generator seeded by the root seed and its name (the discriminator's scope spectral
    under ``use_spectral_norm``).  No activation is materialized, as the reference's
    ``jax.eval_shape`` init."""
    params = {}
    dev = torch.device(device)
    with torch.no_grad():
        g_pass(Scope(params, init=True, rng=rng, device=dev),
               torch.empty((1, cfg.latent_dim), device="meta"))
        d_pass(Scope(params, init=True, rng=rng, device=dev, spectral=spectral_iters(cfg)),
               torch.empty(cfg.current_shape(phase, 1), device="meta"))
    return params


def block_tap(x: torch.Tensor, name: str, cfg) -> torch.Tensor:
    """Per-resolution-block activation boundary.  Under ``cfg.remat_offload`` it marks
    `x` as the block tap `name` (``offload_taps`` parks it in pinned host memory where
    autograd keeps it); otherwise, and always on the values, the identity."""
    if getattr(cfg, "remat_offload", False):
        x.block_tap = name
    return x


def offload_block_names(phase: int) -> List[str]:
    """Every name ``block_tap`` can emit up to `phase`."""
    names = ["gen_in", "disc_in"]
    for i in range(2, phase + 1):
        names += [f"gen_block_{i}", f"gen_block_{i}_mid",
                  f"disc_block_{i}", f"disc_block_{i}_mid"]
    return names


def recompute(fn, *inputs):
    """``fn(*inputs)`` as one recompute region whose kept inputs are `inputs` (``fn``
    reads the parameters from its closure).  No RNG state is kept: the only random
    numbers inside a model, the style families' noise, come from a noise source that
    seeds each layer's draw by name (``ops.core.LayerNoise``), so the recompute draws
    them again bit for bit."""
    return checkpoint(fn, *inputs, use_reentrant=False, preserve_rng_state=False)


def segment(fn, cfg, *inputs):
    """``fn(*inputs)``; under ``cfg.remat_offload`` with gradients on, as a
    ``recompute`` region."""
    if getattr(cfg, "remat_offload", False) and torch.is_grad_enabled():
        return recompute(fn, *inputs)
    return fn(*inputs)


class ParkedTaps:
    """What one ``offload_taps`` scope parked: (name, bytes) per block tap, once each."""

    def __init__(self):
        self.taps: List[Tuple[str, int]] = []

    @property
    def nbytes(self) -> int:
        return sum(b for _, b in self.taps)


@contextlib.contextmanager
def offload_taps():
    """Saved-tensor hooks that park every block tap autograd keeps in host memory
    (pinned, copied without a sync, for a CUDA tensor) and copy it back to its device
    when the backward unpacks it; any other saved tensor is kept as it is.  A tap kept
    twice is copied to the host once.  Yields the scope's ``ParkedTaps``."""
    parked = ParkedTaps()

    def pack(t: torch.Tensor):
        name = getattr(t, "block_tap", None)
        if name is None:
            return t
        host = getattr(t, "parked_on_host", None)
        if host is None:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            host.copy_(t.detach(), non_blocking=t.is_cuda)
            t.parked_on_host = host
            parked.taps.append((name, host.numel() * host.element_size()))
        return t.device, host

    def unpack(p):
        if isinstance(p, tuple):
            device, host = p
            return host.to(device, non_blocking=True)
        return p

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield parked
