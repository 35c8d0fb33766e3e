"""Exponential moving average of the parameters (counterpart of
``saragan_tpu/optim/ema.py:25-43``): ``ema = decay * ema + (1 - decay) * params`` once
per step, over G and D.  The averages are a second parameter dict keyed like the
parameters.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def ema_init(params: Params) -> Params:
    """Copies of the parameters (never aliases of the live tensors)."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float) -> Params:
    return {k: decay * e + (1.0 - decay) * params[k] for k, e in ema.items()}
