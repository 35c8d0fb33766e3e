"""HPO in lockstep across processes (counterpart of ``saragan_tpu/parallel/multihost.py``).

Under data parallelism every rank trains the same trial.  Rank 0 owns the study; each
suggestion, and each prune decision, is decided on rank 0 and broadcast, so every rank
samples the same parameters and raises ``TrialPruned`` on the same step (the reference's
``hvd.rank() == 0`` + bcast choreography).  Without that the ranks would diverge and the
survivors would hang in the next collective.  The broadcasts go over the mesh's host
group (gloo, host memory).  Without a mesh, or at world size 1, every function here is a
pass-through.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from saragan_tpu_torch.parallel.mesh import Mesh


def _single(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.world_size == 1


def broadcast_scalar(value: float, mesh: Optional[Mesh]) -> float:
    """Rank 0's float on every rank (the others may pass any placeholder); the float64 is
    shipped as its 8 raw bytes, so it arrives bit for bit."""
    if _single(mesh):
        return value
    import torch.distributed as dist

    buf = torch.from_numpy(np.frombuffer(np.float64(value).tobytes(), np.uint8).copy())
    dist.broadcast(buf, src=0, group=mesh.host_group)
    return float(np.frombuffer(buf.numpy().tobytes(), np.float64)[0])


def broadcast_json(obj, mesh: Optional[Mesh]):
    """Rank 0's JSON-serialisable object on every rank: its byte length first (so every
    rank allocates the same buffer), then the payload.  A payload that does not encode
    or decode raises on every rank, none is left inside the collective."""
    if _single(mesh):
        return obj
    import torch.distributed as dist

    raw = b""
    if mesh.rank == 0:
        try:
            raw = json.dumps(obj).encode("utf-8")
        except (TypeError, ValueError):
            raw = b"\xff"  # not JSON: every rank fails below
    n = int(broadcast_scalar(float(len(raw)), mesh))
    buf = torch.zeros(n, dtype=torch.uint8)
    if mesh.rank == 0:
        buf.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    dist.broadcast(buf, src=0, group=mesh.host_group)
    return json.loads(buf.numpy().tobytes().decode("utf-8"))


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Whether `flag` is true on some rank (every rank gets the same answer)."""
    if _single(mesh):
        return bool(flag)
    import torch.distributed as dist

    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


class SynchronizedTrial:
    """An HPO trial kept in lockstep across the ranks of `mesh`.

    Rank 0 wraps the real trial; the others pass ``trial=None``.  Every suggestion is
    decided on rank 0 and broadcast, ``report`` lands on rank 0 only, and
    ``should_prune`` broadcasts rank 0's decision so every rank prunes on the same step.
    Only the duck-typed suggest / report / should_prune surface is used (the port's HPO
    engine's trials and Optuna's alike)."""

    def __init__(self, trial: Optional[object], mesh: Mesh):
        self._trial = trial
        self._mesh = mesh
        self._coordinator = mesh.rank == 0
        if self._coordinator and trial is None and mesh.world_size > 1:
            raise ValueError("rank 0 must hold the real trial")
        number = getattr(trial, "number", -1) if trial is not None else -1
        self.number = int(broadcast_scalar(float(number), mesh))

    def _sync(self, local_fn):
        return broadcast_scalar(local_fn() if self._coordinator else 0.0, self._mesh)

    def suggest_float(self, name, low, high, **kw):
        return self._sync(lambda: self._trial.suggest_float(name, low, high, **kw))

    def suggest_uniform(self, name, low, high):
        return self._sync(lambda: self._trial.suggest_uniform(name, low, high))

    def suggest_loguniform(self, name, low, high):
        return self._sync(lambda: self._trial.suggest_loguniform(name, low, high))

    def suggest_int(self, name, low, high, step=1, **kw):
        return int(self._sync(lambda: self._trial.suggest_int(name, low, high, step=step,
                                                              **kw)))

    def suggest_categorical(self, name, choices):
        choices = list(choices)
        idx = int(self._sync(
            lambda: choices.index(self._trial.suggest_categorical(name, choices))))
        return choices[idx]

    @property
    def params(self):
        return getattr(self._trial, "params", {}) if self._coordinator else {}

    def report(self, value: float, step: int):
        if self._coordinator:
            self._trial.report(value, step)

    def should_prune(self) -> bool:
        decision = float(self._trial.should_prune()) if self._coordinator else 0.0
        return bool(broadcast_scalar(decision, self._mesh))


def synchronized_trial(trial, mesh: Optional[Mesh]):
    """`trial` wrapped for lockstep HPO over `mesh`; `trial` itself without a mesh or at
    world size 1.  Whether a trial exists at all is rank 0's decision, broadcast, so a
    run without HPO gives None on every rank."""
    if _single(mesh):
        return trial
    has_trial = broadcast_scalar(float(trial is not None) if mesh.rank == 0 else 0.0, mesh)
    if not has_trial:
        return None
    return SynchronizedTrial(trial, mesh)
