"""Data parallelism over ``torch.distributed`` (counterpart of
``saragan_tpu/parallel/mesh.py``).

The JAX package jits its train step over a device mesh ('data', 'space'): the batch
sharded on 'data', parameters and optimizer state replicated, and XLA inserts the
gradient all-reduce.  The port keeps PyTorch's own idiom:

* one process per device, each in one explicit process group: ``init_mesh`` joins the
  group that ``torchrun``'s environment describes (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), uses the one the caller has already
  initialised, or, with neither, makes a group of one;
* the backend ``nccl`` for CUDA devices and ``gloo`` for the CPU, and ``gloo`` too where
  the ranks of a host share one card (a device named for every rank while torchrun's
  ``LOCAL_WORLD_SIZE`` is above 1), which NCCL refuses.  Under gloo on a card the
  collectives carry their tensors through host memory (``Mesh.transport`` is "host"),
  since gloo does not take CUDA tensors for every collective.  Both choices are made
  here, once, from the device and the group's backend, and the log names them;
* replicated init: ``broadcast_params_`` from rank 0 (the counterpart of the replicated
  ``device_put``, ``mesh.py:8-12`` there);
* the gradient all-reduce is explicit: ``allreduce_mean_`` (one flat bucket per dtype,
  the names in sorted order), which the train step calls once per step, after its
  micro-batches;
* ``shard_rows``: a rank's contiguous rows of a global tensor.  The JAX package's
  global batch is the rank-major concatenation of each process's local batch
  (``make_array_from_process_local_data``, ``mesh.py:87`` there), and one traced key
  partitioned by XLA gives each shard its rows of the global draws: here every rank
  draws the global draws from the one seeded generator all ranks hold and takes its rows;
* ``gather_rows``: the rank-major all-gather of every rank's rows, differentiable to any
  order (its backward sums the cotangents over the ranks and keeps this rank's rows),
  for the one op that mixes samples across the global batch (surfgan's minibatch
  stddev).

Control decisions (a broadcast trial parameter, "does another trial start", "did any
rank get a signal") travel over a gloo group on host memory (``Mesh.host_group``), so
they never wait on the device.

The 'space' axes (``make_mesh``'s reshape, ``mesh.py:50-64`` there): the world is
data x space x space2, rank = (d S + s) S2 + s2.  Ranks of one data index d hold the same
rows (``shard_rows`` and ``gather_rows`` go by the data index, over the data group: the
ranks of the same (s, s2)); within them, rank (s, s2) holds depth slab s of S and height
slab s2 of S2 of every sample (``parallel/halo.py``: the halo exchanges, the crossings
between sharded and replicated layers, the penalty's sum over the space group).  Each
rank's gradient of a sharded layer counts its slab's voxels, that of a replicated layer
comes from the lead rank of its space group alone (``halo.lead_only`` zeroes it on the
others), so the step's one all-reduce sums over the space group and averages over the
data axis (``allreduce_mean_(..., space_sum=True)``).

No counterpart: ``aot_with_options`` and ``resolve_compiler_options`` (XLA compiler
options, TPU only), and ``jit_train_step``'s shardings (the port's step all-reduces its
gradients itself, ``train/step.py``).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from saragan_tpu_torch._device import resolve_device

@dataclass
class Mesh:
    """The process group this process joined: its device, rank and world size, and the
    layout data x space x space2 of the world (``num_space`` depth slabs, ``num_space2``
    height slabs of every sample).  ``group`` carries the tensors of the step (the world),
    ``host_group`` (gloo) the control decisions; ``data_group`` the ranks of this rank's
    (space, space2) index (None: ``group``, when there is no space axis), ``space_group``
    those of its data index, ``axis_groups`` those along the depth and the height axis
    (None where that axis has one rank); ``owned`` says whether ``init_mesh`` initialised
    the default group (and ``close`` destroys it)."""
    group: Any
    host_group: Any
    device: torch.device
    rank: int
    world_size: int
    backend: str
    owned: bool = False
    num_space: int = 1
    num_space2: int = 1
    data_group: Any = None
    space_group: Any = None
    axis_groups: Tuple[Any, Any] = (None, None)

    @property
    def space_size(self) -> int:
        return self.num_space * self.num_space2

    @property
    def data_size(self) -> int:
        return self.world_size // self.space_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.space_size

    @property
    def space_rank(self) -> int:
        return (self.rank // self.num_space2) % self.num_space

    @property
    def space2_rank(self) -> int:
        return self.rank % self.num_space2

    @property
    def space_lead(self) -> bool:
        """Whether this rank is the first of its space group."""
        return self.rank % self.space_size == 0

    @property
    def rows_group(self):
        """The group ``gather_rows`` and the row collectives run over."""
        return self.group if self.data_group is None else self.data_group

    def global_rank(self, d: int, s: int, s2: int) -> int:
        return (d * self.num_space + s) * self.num_space2 + s2

    def axis_size(self, axis: int) -> int:
        """Ranks along a volume axis of NCDHW: 2 (depth) over space, 3 (height) over
        space2, 1 for any other."""
        return {2: self.num_space, 3: self.num_space2}.get(axis, 1)

    def axis_index(self, axis: int) -> int:
        return {2: self.space_rank, 3: self.space2_rank}.get(axis, 0)

    def axis_group(self, axis: int):
        return self.axis_groups[axis - 2]

    def neighbour(self, axis: int, step: int) -> Optional[int]:
        """The global rank of the neighbour `step` (+-1) along `axis`, or None past the
        volume's end."""
        i = self.axis_index(axis) + step
        if not 0 <= i < self.axis_size(axis):
            return None
        s, s2 = (i, self.space2_rank) if axis == 2 else (self.space_rank, i)
        return self.global_rank(self.data_rank, s, s2)

    @property
    def transport(self) -> str:
        """"host" when the collectives stage CUDA tensors through host memory (gloo on a
        CUDA device), else "device"."""
        return "host" if self.backend == "gloo" and self.device.type == "cuda" else "device"

    def describe(self) -> str:
        text = (f"rank {self.rank} of {self.world_size} on {self.device}, {self.backend} "
                f"collectives over {'host memory' if self.transport == 'host' else 'the device'}")
        if self.space_size > 1:
            text += (f"; data {self.data_size} x space {self.num_space} x space2 "
                     f"{self.num_space2} (this rank: data {self.data_rank}, space "
                     f"{self.space_rank}, space2 {self.space2_rank})")
        return text

    def close(self):
        """Destroy the default group if ``init_mesh`` made it."""
        import torch.distributed as dist

        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
            self.owned = False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_device(device) -> torch.device:
    """The named device, else ``cuda:LOCAL_RANK`` (raising without a CUDA device or when
    LOCAL_RANK is not a card of this machine)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without a CUDA device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"LOCAL_RANK {local} but this machine has {count} CUDA device(s); "
                           f"launch at most {count} processes per node or name a device")
    return torch.device("cuda", local)


def default_backend(dev: torch.device, device_named: bool) -> str:
    """``gloo`` on the CPU or where this host's ranks share the one card named for them
    all (torchrun's ``LOCAL_WORLD_SIZE`` above 1), else ``nccl``."""
    if dev.type != "cuda":
        return "gloo"
    shared = device_named and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1
    return "gloo" if shared else "nccl"


def _launcher_world() -> int:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return 1


def mesh_shape(world: int, num_data: Optional[int], num_space: int,
               num_space2: int) -> int:
    """The data axis of a world of `world` processes split data x space x space2
    (`num_data` None: the rest); raises ValueError where the product is not the world."""
    if num_space < 1 or num_space2 < 1:
        raise ValueError(f"--num_space_shards {num_space} / --num_space2_shards "
                         f"{num_space2} must be >= 1")
    space = num_space * num_space2
    if num_data is None:
        num_data = world // space if world % space == 0 else 0
    if num_data < 1 or num_data * space != world:
        shown = "None" if num_data == 0 else num_data
        raise ValueError(f"--num_data_shards {shown} x --num_space_shards {num_space} x "
                         f"--num_space2_shards {num_space2} does not make the world size "
                         f"{world}: the port runs one process per device, so data x space x "
                         f"space2 is the world")
    return num_data


def _own_group(dist, lists, rank: int):
    """Every rank creates every group of `lists` (torch.distributed's rule: all ranks call
    ``new_group`` in the same order); returns this rank's, None for a group of one."""
    mine = None
    for ranks in lists:
        if len(ranks) == 1:
            continue
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def init_mesh(device=None, *, num_data: Optional[int] = None, num_space: int = 1,
              num_space2: int = 1, verbose: bool = True) -> Mesh:
    """Join the process group and return this process's ``Mesh``.

    `device`: this rank's device; default ``cuda:LOCAL_RANK``.  The backend is
    ``default_backend``'s, or that of the group the caller already initialised.
    `num_data` (``--num_data_shards``), `num_space` and `num_space2` split the world as
    the JAX package's ``make_mesh`` (rank = (d S + s) S2 + s2): their product must be the
    world size (one process per device), `num_data` None takes the rest.  The product
    is checked before the group is joined.  Called again on a joined group (every rank
    alike), it makes another layout of the same world."""
    import torch.distributed as dist

    num_data = mesh_shape(_launcher_world(), num_data, num_space, num_space2)
    dev = _mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owned = False
    if not dist.is_initialized():
        backend = default_backend(dev, device is not None)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        else:  # no launcher: a group of one
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    rank=0, world_size=1)
        owned = True
    backend = dist.get_backend()
    world = dist.get_world_size()
    me = dist.get_rank()
    host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    mesh = Mesh(dist.group.WORLD, host_group, dev, me, world, backend, owned, num_space,
                num_space2)
    if mesh.space_size > 1:
        g = mesh.global_rank
        ds, ss, s2s = range(num_data), range(num_space), range(num_space2)
        mesh.data_group = _own_group(dist, [[g(d, s, s2) for d in ds] for s in ss
                                            for s2 in s2s], me)
        mesh.space_group = _own_group(dist, [[g(d, s, s2) for s in ss for s2 in s2s]
                                             for d in ds], me)
        mesh.axis_groups = (
            _own_group(dist, [[g(d, s, s2) for s in ss] for d in ds for s2 in s2s], me),
            _own_group(dist, [[g(d, s, s2) for s2 in s2s] for d in ds for s in ss], me))
    if verbose and mesh.rank == 0:
        print(f"Data parallel: {world} process(es); {mesh.describe()}", flush=True)
    return mesh


def world_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world_size


def rank(mesh: Optional[Mesh]) -> int:
    return 0 if mesh is None else mesh.rank


# ---------------------------------------------------------------------------
# Collectives on the step's tensors
# ---------------------------------------------------------------------------


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective takes: `t` itself, or its host copy under the "host"
    transport."""
    t = t.contiguous()
    return t.cpu() if mesh.transport == "host" and t.is_cuda else t


def _unwire(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return wire if wire.device == like.device else wire.to(like.device)


def _bits(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`t`'s wire for a collective that only moves data (a gather, a send): bf16 as its
    bytes under gloo, which takes neither bf16 nor int16 for every collective (the last
    axis doubles; the collectives here concatenate along the others)."""
    wire = _wire(mesh, t)
    if mesh.backend == "gloo" and wire.dtype == torch.bfloat16:
        return wire.view(torch.uint8)
    return wire


def _unbits(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if wire.dtype != like.dtype:
        wire = wire.view(like.dtype)
    return _unwire(wire, like)


def _mean_(mesh: Mesh, flat: torch.Tensor, space_sum: bool = False):
    """`flat` in place to its mean over the ranks: NCCL's AVG (each term scaled by 1/W
    before the sum), or under gloo the sum divided by W.  At world size 1 NCCL still
    runs its own path (a one-rank reduction kernel).  With `space_sum`: the sum over
    every rank divided by the data axis (the mean over the data axis of each space
    group's sum)."""
    import torch.distributed as dist

    divisor = mesh.data_size if space_sum else mesh.world_size
    if mesh.backend == "nccl" and not space_sum:
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=mesh.group)
        return
    wire = _wire(mesh, flat)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
    if divisor != 1:
        wire.div_(divisor)
    if wire is not flat:
        flat.copy_(wire)


def _buckets(tensors: Dict[str, torch.Tensor]):
    """{dtype: names} in sorted-name order, the dtypes in a fixed order: every rank
    builds the same buckets."""
    by_dtype: Dict[torch.dtype, list] = {}
    for k in sorted(tensors):
        by_dtype.setdefault(tensors[k].dtype, []).append(k)
    return sorted(by_dtype.items(), key=lambda kv: str(kv[0]))


def _flat_in_place(tensors: Dict[str, torch.Tensor], keys, fn):
    """Concatenate `keys`' tensors into one flat buffer, apply `fn` to it, and replace each
    entry of `tensors` by its view of the result."""
    flat = fn(torch.cat([tensors[k].detach().reshape(-1) for k in keys]))
    offset = 0
    for k in keys:
        n = tensors[k].numel()
        tensors[k] = flat[offset:offset + n].view(tensors[k].shape)
        offset += n


def allreduce_mean_(tensors: Dict[str, torch.Tensor], mesh: Optional[Mesh], *,
                    space_sum: bool = False) -> Dict[str, torch.Tensor]:
    """Each entry of `tensors`, in place in the dict, replaced by its mean over the ranks
    (a view of its bucket): one flat bucket per dtype, the names in sorted order.
    With `space_sum` (a spatially sharded step, each rank holding its slab's part): the
    sum over each space group, averaged over the data axis.  Identity without a mesh.
    Returns `tensors`."""
    if mesh is None:
        return tensors

    def mean(flat):
        _mean_(mesh, flat, space_sum)
        return flat

    for _, keys in _buckets(tensors):
        _flat_in_place(tensors, keys, mean)
    return tensors


def allreduce_min(t: torch.Tensor, mesh: Optional[Mesh], *,
                  space_only: bool = False) -> torch.Tensor:
    """The elementwise minimum of `t` over the ranks (a new tensor); with `space_only`
    over this rank's space group (the slabs of the same samples)."""
    if mesh is None:
        return t
    group = mesh.space_group if space_only else mesh.group
    if space_only and group is None:
        return t
    import torch.distributed as dist

    wire = _wire(mesh, t).clone()
    dist.all_reduce(wire, op=dist.ReduceOp.MIN, group=group)
    return _unwire(wire, t)


def broadcast_params_(tensors: Dict[str, torch.Tensor],
                      mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Each entry of `tensors`, in place in the dict, replaced by rank 0's values
    (replicated init): one flat bucket per dtype.  Identity without a mesh or at world
    size 1.  Returns `tensors`."""
    if mesh is None or mesh.world_size == 1:
        return tensors
    import torch.distributed as dist

    def from_rank0(flat):
        wire = _wire(mesh, flat)
        dist.broadcast(wire, src=0, group=mesh.group)
        return _unwire(wire, flat)

    for _, keys in _buckets(tensors):
        _flat_in_place(tensors, keys, from_rank0)
    return tensors


def shard_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous rows of the global tensor `t` (rank-major, as the JAX
    package's global batch), by its data index: the ranks of one space group take the
    same rows.  `t` itself without a mesh."""
    if mesh is None or mesh.data_size == 1:
        return t
    n = t.shape[0]
    if n % mesh.data_size:
        raise ValueError(f"{n} rows do not split over {mesh.data_size} ranks")
    m = n // mesh.data_size
    return t[mesh.data_rank * m:(mesh.data_rank + 1) * m]


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist

    wire = _bits(mesh, x)
    parts = [torch.empty_like(wire) for _ in range(mesh.data_size)]
    dist.all_gather(parts, wire, group=mesh.rows_group)
    return _unbits(torch.cat(parts), x)


def _sum_scatter(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the data axis of `g` (global rows), this rank's rows of it."""
    import torch.distributed as dist

    wire = _wire(mesh, g).clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.rows_group)
    return shard_rows(_unwire(wire, g), mesh)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _SumScatterRows.apply(g, ctx.mesh), None


class _SumScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, mesh):
        ctx.mesh = mesh
        return _sum_scatter(g, mesh)

    @staticmethod
    def backward(ctx, h):
        return _GatherRows.apply(h, ctx.mesh), None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every data index's rows of `x`, concatenated in rank order (the global batch), over
    the data group.  Its backward sums the cotangent over the data group and keeps this
    rank's rows (a reduce-scatter), whose own backward is this gather again, so gradients
    of any order (the penalty's ``create_graph`` pass) go through.  Every rank must call
    it in the same order."""
    if mesh is None or mesh.data_size == 1:
        return x
    return _GatherRows.apply(x, mesh)
