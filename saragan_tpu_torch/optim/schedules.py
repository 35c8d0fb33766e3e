"""Learning-rate schedules (own copy of ``saragan_tpu/optim/schedules.py``).

A pure function of the image counter within the phase, evaluated on the host each step
and handed to the train step as a number:

* the default value is ``lr_max``;
* a ``linear`` rise goes 0 -> lr_max over the first ``rise_niter`` images;
* an ``exponential`` rise starts at 1 % of lr_max: ``a * exp(b * step)`` with
  ``a = lr_max / 100`` and ``b = ln(100) / rise_niter``;
* decay mirrors this on ``remaining = steps_per_phase - step``;
* where rise and decay overlap, decay wins.
"""

from __future__ import annotations

import math
from typing import Optional


def lr_schedule(intra_phase_step: int, steps_per_phase: int, lr_max: float,
                lr_increase: Optional[str], lr_decrease: Optional[str],
                lr_rise_niter: Optional[int], lr_decay_niter: Optional[int]) -> float:
    lr = lr_max
    if not (lr_increase or lr_decrease):
        return lr

    if lr_increase == "linear":
        if intra_phase_step < lr_rise_niter:
            lr = (intra_phase_step / lr_rise_niter) * lr_max
    elif lr_increase == "exponential":
        if intra_phase_step < lr_rise_niter:
            a = lr_max / 100.0
            b = math.log(100.0) / lr_rise_niter
            lr = a * math.exp(b * intra_phase_step)
    elif lr_increase is not None:
        raise ValueError(f"Unknown lr_increase {lr_increase!r}")

    remaining = steps_per_phase - intra_phase_step
    step_decay_start = steps_per_phase - (lr_decay_niter or 0)
    if lr_decrease == "linear":
        if intra_phase_step > step_decay_start:
            lr = (remaining / lr_decay_niter) * lr_max
    elif lr_decrease == "exponential":
        if intra_phase_step > step_decay_start:
            a = lr_max / 100.0
            b = math.log(100.0) / lr_decay_niter
            lr = a * math.exp(b * remaining)
    elif lr_decrease is not None:
        raise ValueError(f"Unknown lr_decrease {lr_decrease!r}")

    return float(lr)


def scale_lr(g_lr, d_lr, g_scaling: str, d_scaling: str, global_size: int):
    """Data-parallel LR scaling: none, sqrt or linear in the number of workers."""

    def scale(lr, how):
        if how == "sqrt":
            return lr * math.sqrt(global_size)
        if how == "linear":
            return lr * global_size
        if how == "none":
            return lr
        raise ValueError(how)

    if global_size > 1:
        return scale(g_lr, g_scaling), scale(d_lr, d_scaling)
    return g_lr, d_lr
