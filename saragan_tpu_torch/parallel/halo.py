"""The depth-halo conv (counterpart of ``saragan_tpu/parallel/halo.py``): a SAME conv of a
volume whose depth axis is split across the ranks of a mesh.

Rank r holds depth slices [r d, (r + 1) d) of every sample.  Before the conv each rank
sends its top `radius` slices to its left neighbour and its bottom ones to its right
(point-to-point), and the end ranks pad with zero slabs, as the conv's SAME padding
would.  The conv of the extended slab is then VALID in depth and SAME in height and
width.  Under the ``flat`` engine that conv is kernel #1 itself: the SAME conv of the
extended slab with `radius` slices cropped at each end, exact because the interior
outputs of a SAME conv are the VALID ones.

No counterpart: ``volume_sharding`` and ``with_spatial_sharding``, GSPMD annotations from
which XLA derives the exchanges of every conv of a sharded step.  A spatially sharded
training step (halos on every conv and transition, the exchange's backward) is ROADMAP.md
queue 1 item 16; this module's conv is forward only and raises under autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from saragan_tpu_torch.ops.core import CONV_ENGINES, conv_apply
from saragan_tpu_torch.parallel.mesh import Mesh, _unwire, _wire


def _halo_exchange_depth(x_local: torch.Tensor, radius: int, mesh: Mesh) -> torch.Tensor:
    """`x_local` with `radius` slices of each depth neighbour prepended and appended
    (zero slabs at the ends of the volume)."""
    import torch.distributed as dist

    if x_local.shape[2] < radius:
        # a rank must hold at least `radius` slices, else the halo would need slices of
        # the second neighbour
        raise ValueError(f"halo radius {radius} exceeds local shard depth {x_local.shape[2]}; "
                         f"use fewer ranks (or a smaller kernel) so each holds >= radius "
                         f"slices")
    top = _wire(mesh, x_local[:, :, :radius])
    bottom = _wire(mesh, x_local[:, :, -radius:])
    from_left, from_right = torch.zeros_like(top), torch.zeros_like(bottom)
    ops = []
    if mesh.rank > 0:
        ops += [dist.P2POp(dist.isend, top, mesh.rank - 1, mesh.group),
                dist.P2POp(dist.irecv, from_left, mesh.rank - 1, mesh.group)]
    if mesh.rank < mesh.world_size - 1:
        ops += [dist.P2POp(dist.isend, bottom, mesh.rank + 1, mesh.group),
                dist.P2POp(dist.irecv, from_right, mesh.rank + 1, mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([_unwire(from_left, x_local), x_local, _unwire(from_right, x_local)],
                     dim=2)


def halo_conv3d(x_local: torch.Tensor, w: torch.Tensor, mesh: Mesh, *,
                engine: str = "direct") -> torch.Tensor:
    """SAME stride-1 NCDHW conv of the depth-split volume whose rank-local slab is
    `x_local` (N, C, d, H, W); w: (kd, kh, kw, C, F), odd kd.  Returns this rank's slab of
    the output, (N, F, d, H, W).  `engine`: "flat" (kernel #1 on the extended slab,
    cropped) or "direct" (the library conv, VALID in depth).  Every rank calls it
    together."""
    if engine not in CONV_ENGINES:
        raise ValueError(f"conv engine {engine!r} not in {CONV_ENGINES}")
    if torch.is_grad_enabled() and (x_local.requires_grad or w.requires_grad):
        raise NotImplementedError("the halo conv's backward is not ported yet (ROADMAP.md "
                                  "queue 1 item 16)")
    kd, kh, kw = w.shape[:3]
    if kd % 2 == 0:
        raise ValueError(f"the halo conv needs an odd depth kernel, got {kd}")
    radius = kd // 2
    x_ext = _halo_exchange_depth(x_local, radius, mesh) if radius > 0 else x_local
    if engine == "flat":
        y = conv_apply(x_ext, w, "flat")
        return y[:, :, radius:y.shape[2] - radius]
    wt = w.permute(4, 3, 0, 1, 2).to(x_ext.dtype)
    return F.conv3d(x_ext, wt, padding=(0, kh // 2, kw // 2))
