"""Exponential moving average of the parameters (counterpart of
``saragan_tpu/optim/ema.py``): ``ema = decay * ema + (1 - decay) * params`` once per step,
over G and D, and ``fold_ema`` before the phase-final checkpoint.  The averages are a
second parameter dict keyed like the parameters.  ``ExtendedEMA`` is the class-style API
over a held (params, shadow) pair.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def ema_init(params: Params) -> Params:
    """Copies of the parameters (never aliases of the live tensors)."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float) -> Params:
    return {k: decay * e + (1.0 - decay) * params[k] for k, e in ema.items()}


def fold_ema(params: Params, ema: Params) -> Params:
    """The live weights overwritten by their averages (the phase-final checkpoint's
    weights); copies, so the result aliases neither dict."""
    return {k: ema[k].detach().clone() for k in params}


class ExtendedEMA:
    """Class-style API of the reference's ExtendedEMA over a held (params, shadow) pair:
    ``apply`` steps the shadow, ``assign_ema_weights`` backs up the live weights and
    returns the averages, ``restore_original_weights`` hands the live ones back."""

    def __init__(self, params: Params, decay: float):
        self.decay = decay
        self.shadow = ema_init(params)
        self._backup: Optional[Params] = None

    def apply(self, params: Params) -> Params:
        """One EMA step; returns the params unchanged (chainable)."""
        self.shadow = ema_update(self.shadow, params, self.decay)
        return params

    def assign_ema_weights(self, params: Params) -> Params:
        """Back up the live weights, return the averaged ones."""
        self._backup = params
        return fold_ema(params, self.shadow)

    def restore_original_weights(self) -> Params:
        if self._backup is None:
            raise RuntimeError("assign_ema_weights was not called")
        params, self._backup = self._backup, None
        return params

    def average(self, name: str) -> Optional[torch.Tensor]:
        return self.shadow.get(name)
