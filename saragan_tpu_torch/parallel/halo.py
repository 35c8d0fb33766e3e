"""Spatial sharding (counterpart of ``saragan_tpu/parallel/halo.py``): a volume's depth
(axis 2, over the mesh's ``space`` ranks) and height (axis 3, over ``space2``) split
across the ranks of a mesh, and the ops of a layer that runs on its slab.

Rank (s, s2) holds depth slab s and height slab s2 of every sample of its rows.  The JAX
package annotates shardings and GSPMD inserts every exchange, in the forward and in the
penalty's double backward; here each is an ``autograd.Function`` whose backward is
another such Function, so gradients of any order re-enter the exchanges:

* ``halo_exchange``: `radius` slices from each neighbour along an axis appended to the
  slab (point-to-point; zero slabs at the volume's ends, as SAME padding).  Its backward
  is the adjoint: each halo's cotangent goes back to its owner and is added to that
  owner's edge slices; the adjoint's backward is the exchange again.  On both axes the
  depth goes first and the height is exchanged on the depth-extended slab, so the
  corner voxels arrive;
* ``halo_conv3d``: a SAME conv of the sharded volume.  The conv of the extended slab is
  VALID on the exchanged axes and SAME on the others.  Under every engine but
  ``direct`` it is the engine's own SAME conv of the extended slab (``ops.conv_apply``:
  under ``flat`` kernel #1 through ``ops/conv3d_grad.py``, #1, #1' and #2 in the
  backward) with `radius` slices cropped at each end, exact because the interior outputs
  of a SAME conv are the VALID ones.  It computes 2 radius slices per exchanged axis that
  it then drops; ``s2d`` judges its applicability on the extended slab (an odd extent
  takes the direct conv);
* ``halo_upscale_conv``: the fused nearest-2x upscale and conv (``ops.upscale_conv``'s
  polyphase convs) of a sharded coarse input: a halo of ceil(k // 2 / 2) coarse slices,
  the polyphase conv of the extended slab, 2 such fine slices cropped at each end.
  Exact (each output voxel sums the same terms) up to the library conv's summation
  order on another shape;
* ``take_slab`` (replicated -> sharded: this rank's slab) and ``gather_slabs`` (sharded ->
  replicated: an all-gather along each sharded axis).  Each is the other's backward: a
  replicated tensor's cotangent is the same on every rank of the space group, so the
  gather's adjoint keeps this rank's slab without communication, and the slab's adjoint
  gathers every rank's slab cotangents;
* ``enter_slab``: this rank's slab of a replicated tensor whose cotangents upstream are
  *partial* (the generator's crossing): its adjoint places this rank's slab cotangent in
  a zero volume without communication, so each rank's cotangent of every replicated
  tensor upstream is its slab's part, and the parts sum over the space group to the whole
  (the step's all-reduce sums them).  Every replicated tensor of a generator (the dense
  input, the styles, a replicated low resolution) then carries one convention, whether it
  feeds a sharded layer directly (a style scales the slab) or through the crossing;
* ``space_sum``: the sum over the space group of per-slab partial sums (the penalty's
  gradient norm); its adjoint on a replicated downstream is the identity;
* ``space_allreduce``: the same sum where the downstream is sharded (instance norm's
  moments at a sharded resolution): its adjoint all-reduces the slabs' partial
  cotangents, and is itself, to any order;
* ``SlabNoise``: a noise source's draw over the whole volume, cut to this rank's slab, so
  a sharded layer's noise is its slab of the one-device draw;
* ``lead_only``: the parameter of a replicated layer whose cotangent is the same on every
  rank (the discriminator's, downstream of a gather) as read on this rank: its gradient
  kept on the lead rank of the space group, zero elsewhere, so that every parameter's
  gradient counts each voxel of each sample once across the space group (a sharded
  layer's on the rank of the slab, such a replicated layer's on the lead, the
  generator's as its slabs' parts, ``enter_slab``) and the step sums the space group's
  gradients (``mesh.allreduce_mean_(..., space_sum=True)``).

``space_splits`` is the rule of a model's per-resolution plan: a resolution runs sharded
where each sharded axis splits evenly with at least max(1, radius) slices a rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from saragan_tpu_torch.ops.core import Engine, as_ops, conv_apply, upscale_conv
from saragan_tpu_torch.parallel.mesh import Mesh, _bits, _unbits, _unwire, _wire

_AXIS_NAMES = {2: "depth", 3: "height"}


def space_axes(mesh: Optional[Mesh]):
    """The volume axes of NCDHW that `mesh` splits (2: depth, 3: height)."""
    if mesh is None:
        return ()
    return tuple(a for a in (2, 3) if mesh.axis_size(a) > 1)


def space_splits(mesh: Mesh, spatial: Sequence[int], radii: Sequence[int]) -> bool:
    """Whether a volume of `spatial` (D, H, W) runs sharded on `mesh` under halos of
    `radii` (per axis D, H): every sharded axis splits evenly with at least
    max(1, radius) slices a rank."""
    for a in space_axes(mesh):
        n, size = int(spatial[a - 2]), mesh.axis_size(a)
        if n % size or n // size < max(1, int(radii[a - 2])):
            return False
    return True


def _p2p(mesh: Mesh, pairs):
    """[(send, recv buffer, peer)]: one batch of point-to-point ops, waited for."""
    import torch.distributed as dist

    ops = []
    for send, recv, peer in pairs:
        ops += [dist.P2POp(dist.isend, send, peer, mesh.group),
                dist.P2POp(dist.irecv, recv, peer, mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _check_radius(x: torch.Tensor, radius: int, axis: int):
    if x.shape[axis] < radius:
        # a rank must hold at least `radius` slices, else the halo would need slices of
        # the second neighbour
        raise ValueError(f"halo radius {radius} exceeds local shard {_AXIS_NAMES[axis]} "
                         f"{x.shape[axis]}; use fewer ranks (or a smaller kernel) so each "
                         f"holds >= radius slices")


def _exchange(x: torch.Tensor, radius: int, mesh: Mesh, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    first = _bits(mesh, x.narrow(axis, 0, radius))
    last = _bits(mesh, x.narrow(axis, n - radius, radius))
    from_lo, from_hi = torch.zeros_like(first), torch.zeros_like(last)
    lo, hi = mesh.neighbour(axis, -1), mesh.neighbour(axis, 1)
    _p2p(mesh, [(first, from_lo, lo)] * (lo is not None)
         + [(last, from_hi, hi)] * (hi is not None))
    return torch.cat([_unbits(from_lo, x), x, _unbits(from_hi, x)], dim=axis)


def _exchange_adjoint(g: torch.Tensor, radius: int, mesh: Mesh, axis: int) -> torch.Tensor:
    n = g.shape[axis] - 2 * radius
    to_lo = _bits(mesh, g.narrow(axis, 0, radius))
    to_hi = _bits(mesh, g.narrow(axis, n + radius, radius))
    from_lo, from_hi = torch.zeros_like(to_lo), torch.zeros_like(to_hi)
    lo, hi = mesh.neighbour(axis, -1), mesh.neighbour(axis, 1)
    _p2p(mesh, [(to_lo, from_lo, lo)] * (lo is not None)
         + [(to_hi, from_hi, hi)] * (hi is not None))
    out = g.narrow(axis, radius, n).clone(memory_format=torch.contiguous_format)
    if lo is not None:  # the cotangent of my first slices, held as the lower rank's halo
        out.narrow(axis, 0, radius).add_(_unbits(from_lo, g))
    if hi is not None:
        out.narrow(axis, n - radius, radius).add_(_unbits(from_hi, g))
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, radius, mesh, axis):
        ctx.args = (radius, mesh, axis)
        return _exchange(x, radius, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _HaloAdjoint.apply(g, *ctx.args), None, None, None


class _HaloAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, radius, mesh, axis):
        ctx.args = (radius, mesh, axis)
        return _exchange_adjoint(g, radius, mesh, axis)

    @staticmethod
    def backward(ctx, u):
        return _HaloExchange.apply(u, *ctx.args), None, None, None


def halo_exchange(x: torch.Tensor, radius: int, mesh: Mesh, axis: int) -> torch.Tensor:
    """`x` (a slab) with `radius` slices of each neighbour along `axis` (2 or 3) added at
    its ends (zero slabs at the volume's ends); differentiable to any order.  Every rank
    of the axis calls it together."""
    _check_radius(x, radius, axis)
    if radius == 0:
        return x
    return _HaloExchange.apply(x, radius, mesh, axis)


def _crop(y: torch.Tensor, radii) -> torch.Tensor:
    for axis, r in radii.items():
        if r:
            y = y.narrow(axis, r, y.shape[axis] - 2 * r)
    return y


def halo_conv3d(x_local: torch.Tensor, w: torch.Tensor, mesh: Mesh, *,
                engine: Engine = "direct") -> torch.Tensor:
    """SAME stride-1 NCDHW conv of the sharded volume whose rank-local slab is `x_local`
    (N, C, d, h, W); w: (kd, kh, kw, C, F), odd kd and kh.  Returns this rank's slab of
    the output, (N, F, d, h, W), differentiable to any order.  `engine` (``ops.core.Ops``
    or an engine name): "direct" is the library conv, VALID on the exchanged axes; any
    other engine its SAME conv of the extended slab, cropped.  Without a space axis it is
    the SAME conv of `x_local`.  Every rank of the space group calls it together."""
    engine = as_ops(engine)
    kernel = tuple(int(k) for k in w.shape[:3])
    if kernel[0] % 2 == 0 or kernel[1] % 2 == 0:
        raise ValueError(f"the halo conv needs odd depth and height kernels, got {kernel}")
    radii = {a: kernel[a - 2] // 2 for a in space_axes(mesh)}
    x_ext = x_local
    for axis, r in radii.items():  # depth first, then height on the extended slab
        x_ext = halo_exchange(x_ext, r, mesh, axis)
    if engine.conv != "direct":
        return _crop(conv_apply(x_ext, w, engine), radii)
    pad = tuple(0 if (a + 2) in radii else k // 2 for a, k in enumerate(kernel))
    wt = w.permute(4, 3, 0, 1, 2).to(x_ext.dtype)
    return F.conv3d(x_ext, wt, padding=pad)


def halo_upscale_conv(x_local: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``ops.upscale_conv`` (nearest 2x upscale, then the SAME conv w) of the sharded
    coarse volume whose slab is `x_local`: this rank's slab of the fine output, from a
    halo of ceil(k // 2 / 2) coarse slices per sharded axis, cropped by twice that."""
    radii = {a: (int(w.shape[a - 2]) // 2 + 1) // 2 for a in space_axes(mesh)}
    x_ext = x_local
    for axis, r in radii.items():
        x_ext = halo_exchange(x_ext, r, mesh, axis)
    return _crop(upscale_conv(x_ext, w), {a: 2 * r for a, r in radii.items()})


def _gather_axis(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    import torch.distributed as dist

    wire = _bits(mesh, x)
    parts = [torch.empty_like(wire) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, wire, group=mesh.axis_group(axis))
    return _unbits(torch.cat(parts, dim=axis), x)


def _slab_axis(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    size = mesh.axis_size(axis)
    n = x.shape[axis] // size
    if n * size != x.shape[axis]:
        raise ValueError(f"{_AXIS_NAMES[axis]} {x.shape[axis]} does not split over {size} "
                         f"ranks")
    return x.narrow(axis, mesh.axis_index(axis) * n, n).clone(
        memory_format=torch.contiguous_format)


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _gather_axis(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _SlabAxis.apply(g, *ctx.args), None, None


class _SlabAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _slab_axis(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _GatherAxis.apply(g, *ctx.args), None, None


def take_slab(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's slab of the replicated volume `x` (replicated -> sharded); its backward
    gathers the slabs' cotangents.  Also the plain slice of a batch or a draw."""
    for axis in space_axes(mesh):
        x = _SlabAxis.apply(x, mesh, axis)
    return x


def gather_slabs(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole volume from every rank's slab `x` (sharded -> replicated), depth first;
    its backward keeps this rank's slab of the (replicated) cotangent."""
    for axis in space_axes(mesh):
        x = _GatherAxis.apply(x, mesh, axis)
    return x


class _EnterSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis, x.shape[axis])
        return _slab_axis(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _PadSlab.apply(g, *ctx.args), None, None


class _PadSlab(torch.autograd.Function):
    """This rank's slab placed in a zero volume of `full` slices along `axis`."""

    @staticmethod
    def forward(ctx, g, mesh, axis, full):
        ctx.args = (mesh, axis)
        shape = list(g.shape)
        shape[axis] = full
        out = g.new_zeros(shape)
        n = g.shape[axis]
        out.narrow(axis, mesh.axis_index(axis) * n, n).copy_(g)
        return out

    @staticmethod
    def backward(ctx, u):
        return _EnterSlab.apply(u, *ctx.args), None, None, None


def enter_slab(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's slab of the replicated volume `x`, whose adjoint zero-pads this rank's
    slab cotangent back to the volume (no communication): upstream of it each rank holds
    its slab's part of every cotangent.  `x` itself without a space axis."""
    for axis in space_axes(mesh):
        x = _EnterSlab.apply(x, mesh, axis)
    return x


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        import torch.distributed as dist

        wire = _wire(mesh, x).clone()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.space_group)
        return _unwire(wire, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def space_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum over the space group of each rank's partial `x` (replicated result); its
    backward hands the (replicated) cotangent to every partial.  `x` itself without a
    space axis."""
    if mesh is None or mesh.space_group is None:
        return x
    return _SpaceSum.apply(x, mesh)


class _SpaceAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        import torch.distributed as dist

        ctx.mesh = mesh
        wire = _wire(mesh, x).clone()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.space_group)
        return _unwire(wire, x)

    @staticmethod
    def backward(ctx, g):
        return _SpaceAllReduce.apply(g, ctx.mesh), None


def space_allreduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum over the space group of each rank's partial `x`, for a sharded downstream:
    its adjoint sums the ranks' partial cotangents (the same all-reduce, whose own
    adjoint it is, so gradients of any order go through).  `x` itself without a space
    group; f32 or f64 (gloo sums no bf16)."""
    if mesh is None or mesh.space_group is None:
        return x
    return _SpaceAllReduce.apply(x, mesh)


class SlabNoise:
    """This rank's slab of another noise source's draw over the whole volume: a layer at
    a sharded resolution asking for (n, 1, d, h, W) gets its slab of the source's (n, 1,
    d S, h S2, W) draw, so that its noise is the one-device draw's (rows first, where the
    source is a ``RankRowsNoise``, then the slab).  A recompute draws it again alike."""

    def __init__(self, source, mesh: Mesh):
        self.source = source
        self.mesh = mesh

    def __call__(self, name: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
        full = list(shape)
        for a in space_axes(self.mesh):
            full[a] *= self.mesh.axis_size(a)
        return take_slab(self.source(name, tuple(full), dtype, device), self.mesh)


class _LeadOnly(torch.autograd.Function):
    """The identity whose backward passes the cotangent on the space group's lead rank and
    zeros on the others.  Not a ``detach``: every rank keeps the same graph, so every rank
    runs the same collectives in its backward passes."""

    @staticmethod
    def forward(ctx, w, lead):
        ctx.lead = lead
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.lead else torch.zeros_like(g)), None


def lead_only(mesh: Mesh):
    """The parameter hook of a replicated layer (``core.Scope``'s `hook`): its gradient
    kept on the space group's lead rank, zero on the others."""
    lead = mesh.space_lead
    return lambda w: _LeadOnly.apply(w, lead)
