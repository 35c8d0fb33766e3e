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

No counterpart: ``aot_with_options`` and ``resolve_compiler_options`` (XLA compiler
options, TPU only), and ``jit_train_step``'s shardings (the port's step all-reduces its
gradients itself, ``train/step.py``).  The 'space' axes (a volume's depth and height
sharded across devices) are ROADMAP.md queue 1 item 16: ``num_space`` or ``num_space2``
above 1 raises.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from saragan_tpu_torch._device import resolve_device

SPACE_NOT_PORTED = ("spatial sharding (num_space_shards / num_space2_shards > 1: a volume's "
                    "depth and height split across devices) is not ported yet (ROADMAP.md "
                    "queue 1 item 16)")


@dataclass
class Mesh:
    """The process group this process joined: its device, rank and world size.
    ``group`` carries the tensors of the step, ``host_group`` (gloo) the control
    decisions; ``owned`` says whether ``init_mesh`` initialised the default group (and
    ``close`` destroys it)."""
    group: Any
    host_group: Any
    device: torch.device
    rank: int
    world_size: int
    backend: str
    owned: bool = False

    @property
    def transport(self) -> str:
        """"host" when the collectives stage CUDA tensors through host memory (gloo on a
        CUDA device), else "device"."""
        return "host" if self.backend == "gloo" and self.device.type == "cuda" else "device"

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.world_size} on {self.device}, {self.backend} "
                f"collectives over {'host memory' if self.transport == 'host' else 'the device'}")

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


def init_mesh(device=None, *, num_data: Optional[int] = None, num_space: int = 1,
              num_space2: int = 1, verbose: bool = True) -> Mesh:
    """Join the process group and return this process's ``Mesh``.

    `device`: this rank's device; default ``cuda:LOCAL_RANK``.  The backend is
    ``default_backend``'s, or that of the group the caller already initialised.
    `num_data` (``--num_data_shards``) must be None or the world size: one process per
    device."""
    import torch.distributed as dist

    if num_space > 1 or num_space2 > 1:
        raise NotImplementedError(SPACE_NOT_PORTED)
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
    if num_data is not None and num_data != world:
        raise ValueError(f"--num_data_shards {num_data} != the world size {world}: the port "
                         f"runs one process per device, so the data axis is the world")
    host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    mesh = Mesh(dist.group.WORLD, host_group, dev, dist.get_rank(), world, backend, owned)
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


def _mean_(mesh: Mesh, flat: torch.Tensor):
    """`flat` in place to its mean over the ranks: NCCL's AVG (each term scaled by 1/W
    before the sum), or under gloo the sum divided by W.  At world size 1 NCCL still
    runs its own path (a one-rank reduction kernel)."""
    import torch.distributed as dist

    if mesh.backend == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=mesh.group)
        return
    wire = _wire(mesh, flat)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
    wire.div_(mesh.world_size)
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


def allreduce_mean_(tensors: Dict[str, torch.Tensor],
                    mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Each entry of `tensors`, in place in the dict, replaced by its mean over the ranks
    (a view of its bucket): one flat bucket per dtype, the names in sorted order.
    Identity without a mesh.  Returns `tensors`."""
    if mesh is None:
        return tensors

    def mean(flat):
        _mean_(mesh, flat)
        return flat

    for _, keys in _buckets(tensors):
        _flat_in_place(tensors, keys, mean)
    return tensors


def allreduce_min(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise minimum of `t` over the ranks (a new tensor)."""
    if mesh is None:
        return t
    import torch.distributed as dist

    wire = _wire(mesh, t).clone()
    dist.all_reduce(wire, op=dist.ReduceOp.MIN, group=mesh.group)
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
    package's global batch); `t` itself without a mesh."""
    if mesh is None or mesh.world_size == 1:
        return t
    n = t.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not split over {mesh.world_size} ranks")
    m = n // mesh.world_size
    return t[mesh.rank * m:(mesh.rank + 1) * m]


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist

    wire = _wire(mesh, x)
    parts = [torch.empty_like(wire) for _ in range(mesh.world_size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return _unwire(torch.cat(parts), x)


def _sum_scatter(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the ranks of `g` (global rows), this rank's rows of it."""
    import torch.distributed as dist

    wire = _wire(mesh, g).clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
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
    """Every rank's rows of `x`, concatenated in rank order (the global batch).  Its
    backward sums the cotangent over the ranks and keeps this rank's rows (a reduce-
    scatter), whose own backward is this gather again, so gradients of any order
    (the penalty's ``create_graph`` pass) go through.  Every rank must call it in the
    same order."""
    if mesh is None or mesh.world_size == 1:
        return x
    return _GatherRows.apply(x, mesh)
