"""Shared model helpers: the static-alpha test, the num_filters-table sizing of the
families after pgan (counterpart of ``saragan_tpu/models/common.py:78-108``), the
block boundaries and recompute regions of ``remat_offload`` (``:41-74`` there), and the
spatial sharding plan every family runs under.

Spatial sharding (``space``, a ``parallel.Mesh`` with a space axis; what the JAX package's
GSPMD annotations do, ``saragan_tpu/parallel/mesh.py:62-72``): a family's ``space_plan``
says per resolution whether it runs sharded.  A resolution is sharded where its volume
and every finer one split over the space axes with at least max(1, radius) slices a rank
(``parallel.halo.space_splits``) under the depth/height radii of its convs and of the fused
transition out of it (``plan_from_radii``; the families with adaptive kernels,
``adaptive_space_plan``, have radii of at most 1).  A model builds one ``SpacePlan`` per
call (``space_plan_for``) and reads it through the helpers below, which are the plain ops
where the plan is None or the resolution is replicated:

* ``conv_at`` / ``up_conv_at``: a SAME conv (``parallel.halo_conv3d``: under ``flat``
  kernels #1, #1' and #2 on the extended slab) and a nearest-2x upscale followed by one
  (fused: ``halo_upscale_conv``; entering a sharded resolution from a replicated one:
  upscale, ``enter_slab``, halo conv);
* ``to_slab`` (the generator's crossing, ``enter_slab``) and ``to_whole`` (the
  discriminator's, ``gather_slabs``, before a pool into a replicated resolution and
  before the head);
* ``d_scope``: a discriminator layer's scope, its parameters read through
  ``halo.lead_only`` where the layer is replicated (its cotangent is the same on every
  rank: it comes from the replicated scores).  A generator reads none through it: its
  replicated tensors carry partial cotangents (``enter_slab``), so every parameter's
  gradient on a rank is its slab's part and the step's all-reduce sums them;
* ``spatial_at`` (the global spatial shape, which an adaptive kernel is chosen from),
  ``noise_at`` (``halo.SlabNoise``), ``instance_norm_at`` (moments summed over the space
  group, ``halo.space_allreduce``).

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
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from saragan_tpu_torch.core import Scope
from saragan_tpu_torch.ops import core as ops
from saragan_tpu_torch.ops.core import num_filters, num_filters_2d
from saragan_tpu_torch.parallel.halo import (SlabNoise, enter_slab, gather_slabs,
                                             halo_conv3d, halo_upscale_conv, lead_only,
                                             space_axes, space_splits)


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


# ---------------------------------------------------------------------------
# Spatial sharding
# ---------------------------------------------------------------------------


def kernel_radii(*kernels) -> List[int]:
    """The largest depth and height halo radius (k // 2) over `kernels`."""
    return [max((int(k[a]) // 2 for k in kernels if len(k)), default=0) for a in (0, 1)]


def plan_from_radii(cfg, phase: int, mesh, radii: Callable[[int], Sequence[int]]) -> tuple:
    """Per resolution 1..`phase`: True where it runs sharded on `mesh`: where its volume and
    every finer one's split over the space axes (``space_splits``) under `radii(res)`, the
    [depth, height] halo radii of the convs at `res` and of the transition out of it."""
    ok = [space_splits(mesh, cfg.current_shape(res, 1)[2:], radii(res))
          for res in range(1, phase + 1)]
    return tuple(all(ok[r:]) for r in range(phase))


def adaptive_space_plan(cfg, phase: int, mesh) -> tuple:
    """``plan_from_radii`` for the families whose kernels are ``adaptive_kernel``'s (3, or
    1 on an axis shorter than 3, of the global shape): every halo radius at most 1, the
    fused transitions' coarse halos too."""
    return plan_from_radii(cfg, phase, mesh, lambda res: kernel_radii(
        adaptive_kernel(cfg.current_shape(res, 1)[2:])))


class SpacePlan:
    """One call's spatial sharding: the mesh and, per resolution 1..phase, whether it runs
    sharded."""

    def __init__(self, mesh, sharded: Sequence[bool]):
        self.mesh = mesh
        self.sharded = tuple(sharded)

    def at(self, res: Optional[int]) -> bool:
        """Whether resolution `res` runs sharded (None: a dense layer, replicated)."""
        return res is not None and self.sharded[res - 1]


def space_plan_for(space, phase: int, cfg, plan: Callable) -> Optional[SpacePlan]:
    """The ``SpacePlan`` of one call on the mesh `space` under the family's `plan`
    (``Architecture.space_plan``); None without a space axis."""
    if not space_axes(space):
        return None
    return SpacePlan(space, plan(cfg, phase, space))


def sharded(sp: Optional[SpacePlan], res: Optional[int]) -> bool:
    return sp is not None and sp.at(res)


def d_scope(sp: Optional[SpacePlan], scope: Scope, res: Optional[int]) -> Scope:
    """A discriminator layer's scope at `res` (None: the dense head): its parameters read
    through ``lead_only`` where the layer runs replicated."""
    if sp is None or sp.at(res):
        return scope
    return scope.hooked(lead_only(sp.mesh))


def to_slab(sp: Optional[SpacePlan], x, src: Optional[int], dst: int):
    """The generator's `x` from resolution `src`'s layout to `dst`'s: ``enter_slab`` where
    `src` is replicated (None: a dense layer) and `dst` sharded."""
    if sharded(sp, dst) and not sharded(sp, src):
        return enter_slab(x, sp.mesh)
    return x


def to_whole(sp: Optional[SpacePlan], x, src: int, dst: Optional[int]):
    """The discriminator's `x` from resolution `src`'s layout to `dst`'s (None: the head):
    ``gather_slabs`` where `src` is sharded and `dst` replicated."""
    if sharded(sp, src) and not sharded(sp, dst):
        return gather_slabs(x, sp.mesh)
    return x


def conv_layer(scope: Scope, x, fmaps: int, kernel, activation: str, param=None,
               engine: ops.Engine = "direct", sp: Optional[SpacePlan] = None,
               res: Optional[int] = None):
    """``ops.conv`` (the layer's weight (*kernel, C, fmaps) under `scope`, its SAME conv)
    as ``conv_at`` at resolution `res`."""
    kernel = tuple(int(k) for k in kernel)
    w = ops.get_weight(scope, (*kernel, x.shape[1], fmaps), activation, param=param)
    return conv_at(x, w, engine, sp, res)


def conv_at(x, w, engine: ops.Engine, sp: Optional[SpacePlan] = None, res: Optional[int] = None):
    """The SAME conv of `x` at resolution `res` with the weight w (*kernel, C, F): the halo
    conv where `res` runs sharded."""
    if sharded(sp, res):
        return halo_conv3d(x, w.to(x.dtype), sp.mesh, engine=engine)
    return ops.conv_apply(x, w.to(x.dtype), engine)


def up_conv_at(x, w, engine: ops.Engine, sp: Optional[SpacePlan] = None,
               res: Optional[int] = None, fused: bool = False):
    """conv(upscale(x), w) from resolution `res` - 1 into `res`: ``ops.upscale_conv`` under
    `fused`, else the upscale and ``conv_at``; where `res` is sharded, fused from a
    sharded input through ``halo_upscale_conv``, and from a replicated one upscale,
    ``enter_slab`` and the halo conv."""
    if not sharded(sp, res):
        if fused:
            return ops.upscale_conv(x, w.to(x.dtype))
        return conv_at(ops.upscale(x), w, engine)
    if fused and sharded(sp, res - 1):
        return halo_upscale_conv(x, w.to(x.dtype), sp.mesh)
    return conv_at(to_slab(sp, ops.upscale(x), res - 1, res), w, engine, sp, res)


def spatial_at(x, sp: Optional[SpacePlan], res: Optional[int]) -> List[int]:
    """The global spatial shape of `x` at resolution `res`: its own, times the ranks along
    each sharded axis where `res` runs sharded (an adaptive kernel comes from it)."""
    shape = [int(s) for s in x.shape[2:]]
    if sharded(sp, res):
        for a in space_axes(sp.mesh):
            shape[a - 2] *= sp.mesh.axis_size(a)
    return shape


def noise_at(noise, sp: Optional[SpacePlan], res: Optional[int]):
    """The noise source of a layer at `res`: `noise`, or this rank's slab of its draw over
    the whole volume where `res` runs sharded."""
    if noise is None or not sharded(sp, res):
        return noise
    return SlabNoise(noise, sp.mesh)


def instance_norm_at(x, sp: Optional[SpacePlan], res: Optional[int]):
    """``ops.instance_norm`` of the volume whose slab (where `res` runs sharded) is `x`."""
    return ops.instance_norm(x, space=sp.mesh if sharded(sp, res) else None)
