"""Checkpoints (counterpart of ``saragan_tpu/train/checkpoint.py``).

* npz checkpoints in the reference's layout: one ``.npz`` holds the flat name->array
  dicts under ``params/`` and ``ema/`` and scalar counters under ``meta/``, so a
  checkpoint written by either package loads in the other.  Cadence checkpoints are
  ``model_<phase>_ckpt_<step>``, the phase-final one (EMA folded in) ``model_<phase>``.
* full-state files (``..._full.pkl`` at the cadence, ``..._interrupt.pkl`` on a signal)
  for an exact mid-phase resume: the whole ``TrainState`` with the optimizer slots, plus the
  trainer's counters.  Their format is the port's own, a ``torch.save`` of plain dicts
  of CPU tensors; the port cannot read the reference's pickles of JAX arrays, nor the
  reference the port's.  The ``.pkl`` suffix keeps the reference's file names, which
  ``find_auto_resume`` and ``prune_cadence_checkpoints`` rank.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.convert import params_from_numpy, params_to_numpy
from saragan_tpu_torch.core import Params, intersect_restore


def save_params(path: str, params: Params, ema: Optional[Params] = None,
                meta: Optional[Dict[str, float]] = None) -> str:
    """Save params (+ optional EMA and scalar meta) to `path`.npz, atomically."""
    out: Dict[str, np.ndarray] = {}
    for k, v in params_to_numpy(params).items():
        out[f"params/{k}"] = v
    if ema is not None:
        for k, v in params_to_numpy(ema).items():
            out[f"ema/{k}"] = v
    for k, v in (meta or {}).items():
        out[f"meta/{k}"] = np.asarray(v)
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, path)
    return path


def load_params(path: str, device=None) -> Tuple[Params, Optional[Params], Dict[str, float]]:
    """(params, ema or None, meta) with tensors on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    params, ema, meta = {}, {}, {}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("params/"):
                params[k[len("params/"):]] = data[k]
            elif k.startswith("ema/"):
                ema[k[len("ema/"):]] = data[k]
            elif k.startswith("meta/"):
                meta[k[len("meta/"):]] = float(data[k])
    return params_from_numpy(params, dev), (params_from_numpy(ema, dev) if ema else None), meta


def restore_into(current: Params, checkpoint_params, strict: bool = False) -> Params:
    """Name-intersection restore; `strict=True` demands full coverage of `current`."""
    if strict:
        missing = [k for k in current if k not in checkpoint_params]
        if missing:
            raise KeyError(f"Checkpoint missing {len(missing)} params, e.g. {missing[:3]}")
    return intersect_restore(current, checkpoint_params)


def phase_checkpoint_path(logdir: str, phase: int, step: Optional[int] = None) -> str:
    name = f"model_{phase}" if step is None else f"model_{phase}_ckpt_{step}"
    return os.path.join(logdir, name)


def _cpu(params: Params) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def save_full_state(path: str, state, counters: Dict[str, object]) -> str:
    """Write `state` (a ``train.step.TrainState``; its optimizer states as the count and
    one dict per slot) and the trainer's counters to `path`.pkl, atomically."""
    def opt(o):
        return {"count": int(o.count), **{s: _cpu(d) for s, d in o.slots.items()}}

    blob = {"state": {"g_params": _cpu(state.g_params), "d_params": _cpu(state.d_params),
                      "g_opt": opt(state.g_opt), "d_opt": opt(state.d_opt),
                      "ema": _cpu(state.ema)},
            "counters": dict(counters)}
    if not path.endswith(".pkl"):
        path = path + ".pkl"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_full_state(path: str, device=None):
    """(TrainState on `device`, counters) from a file of ``save_full_state``."""
    from saragan_tpu_torch.optim.factory import OptState
    from saragan_tpu_torch.train.step import TrainState

    dev = resolve_device(device)
    if not path.endswith(".pkl"):
        path = path + ".pkl"
    blob = torch.load(path, map_location="cpu", weights_only=True)
    st = blob["state"]

    def to(params):
        return {k: v.to(dev) for k, v in params.items()}

    def opt(o):
        return OptState(int(o["count"]), {s: to(d) for s, d in o.items() if s != "count"})

    state = TrainState(to(st["g_params"]), to(st["d_params"]), opt(st["g_opt"]),
                       opt(st["d_opt"]), to(st["ema"]))
    return state, blob["counters"]


_CKPT_NAME = re.compile(r"^model_(\d+)(?:_ckpt_(\d+))?(_interrupt|_full)?\.(npz|pkl)$")


def prune_cadence_checkpoints(logdir: str, phase: int, keep: int,
                              protect: Optional[set] = None) -> list:
    """Delete this phase's oldest cadence checkpoints beyond the newest `keep` steps
    (0 keeps everything).  A step's ``.npz`` and ``_full.pkl`` go together.  Never
    touched: the phase-final ``model_<p>.npz``, a step that holds an ``_interrupt.pkl``
    (a preemption's resume point), and any path in `protect`.  Returns the deleted
    paths."""
    if keep <= 0 or not os.path.isdir(logdir):
        return []
    protect = {os.path.abspath(p) for p in (protect or set()) if p}
    steps: Dict[int, list] = {}
    interrupted = set()
    for f in os.listdir(logdir):
        m = _CKPT_NAME.match(f)
        if not m or int(m.group(1)) != phase or m.group(2) is None:
            continue
        step = int(m.group(2))
        if m.group(3) == "_interrupt":
            interrupted.add(step)
        else:
            steps.setdefault(step, []).append(os.path.join(logdir, f))
    deleted = []
    for step in sorted(steps)[:-keep] if len(steps) > keep else []:
        if step in interrupted:
            continue
        for path in steps[step]:
            if os.path.abspath(path) in protect:
                continue
            try:
                os.remove(path)
                deleted.append(path)
            except OSError:
                pass
    return deleted


class AutoResume:
    """Where a requeued run picks up (``find_auto_resume``)."""

    __slots__ = ("continue_path", "starting_phase", "complete")

    def __init__(self, continue_path: Optional[str], starting_phase: int,
                 complete: bool = False):
        self.continue_path = continue_path
        self.starting_phase = starting_phase
        self.complete = complete


def find_auto_resume(logdir: str, ending_phase: int) -> Optional[AutoResume]:
    """The newest resume point in `logdir`, newest training progress first:

    1. a full-state ``.pkl`` (``_full`` or ``_interrupt``) of a phase no completed phase
       supersedes: an exact mid-phase resume;
    2. else the last completed phase's ``model_<P>.npz``: resume into phase P + 1, as
       an uninterrupted run chains phases;
    3. ``model_<ending_phase>.npz`` present: training is complete;
    4. nothing: None (a fresh run).
    """
    if not logdir or not os.path.isdir(logdir):
        return None
    best_pkl = None  # ((phase, step, is_interrupt), filename)
    done = 0
    for f in sorted(os.listdir(logdir)):
        m = _CKPT_NAME.match(f)
        if not m:
            continue
        phase, step = int(m.group(1)), int(m.group(2) or 0)
        kind, ext = m.group(3), m.group(4)
        if ext == "pkl" and kind in ("_interrupt", "_full"):
            key = (phase, step, kind == "_interrupt")
            if best_pkl is None or key > best_pkl[0]:
                best_pkl = (key, f)
        elif ext == "npz" and kind is None and m.group(2) is None:
            done = max(done, phase)
    if done >= ending_phase:
        return AutoResume(None, ending_phase, complete=True)
    if best_pkl is not None and best_pkl[0][0] > done:
        return AutoResume(os.path.join(logdir, best_pkl[1]), best_pkl[0][0])
    if done > 0:
        return AutoResume(os.path.join(logdir, f"model_{done}.npz"), done + 1)
    return None
