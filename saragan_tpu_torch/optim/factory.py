"""Optimizers with optax's semantics (counterpart of ``saragan_tpu/optim/factory.py``).

The reference builds each network's optimizer as an lr-free transform and applies
``-lr * u`` at update time, so the learning rate is a per-step argument and a schedule
never rebuilds anything.  The port keeps that split.  Only Adam is ported
(``optax.scale_by_adam``): moments ``mu = (1-b1) g + b1 mu`` and
``nu = (1-b2) g^2 + b2 nu``, bias correction by the step count, and epsilon outside the
square root, ``u = mu_hat / (sqrt(nu_hat) + eps)``.  The other optimizers of the
reference raise (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

_NOT_PORTED = ("SGD", "Momentum", "Adadelta", "RAdam", "LAMB", "LARS", "AdamW")


class AdamState(NamedTuple):
    count: int    # steps taken (optax's int32 count)
    mu: Params    # first moments, f32, keyed like the parameters
    nu: Params    # second moments


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Optimizer(NamedTuple):
    """Adam without a learning rate; ``update`` applies ``-lr * u``."""

    name: str
    b1: float
    b2: float
    eps: float = 1e-8

    def init(self, params: Params) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params, lr: float):
        """(new_params, new_state); nothing is modified in place."""
        count = state.count + 1
        c1, c2 = _bias_correction(self.b1, count), _bias_correction(self.b2, count)
        mu, nu, new = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state.nu[k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            new[k] = p + (-lr) * u
        return new, AdamState(count, mu, nu)


def make_optimizer(name: str, *, beta1: float = 0.0, beta2: float = 0.9) -> Optimizer:
    if name == "Adam":
        return Optimizer(name, float(beta1), float(beta2))
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ROADMAP queue 1 "
                                  f"item 4); the port has Adam")
    raise NotImplementedError(f"optimizer argument {name!r} not recognized or implemented")


def make_optimizers_from_config(cfg) -> tuple:
    """(G, D) optimizers from a finalized Config."""
    return (make_optimizer(cfg.optimizer, beta1=cfg.adam_beta1, beta2=cfg.adam_beta2),
            make_optimizer(cfg.d_optimizer, beta1=cfg.d_adam_beta1, beta2=cfg.d_adam_beta2))
