"""Optimizers with optax's semantics (counterpart of ``saragan_tpu/optim/factory.py``).

The reference builds each network's optimizer as an lr-free optax transform and applies
``-lr * u`` at update time, so the learning rate is a per-step argument and a schedule
never rebuilds anything.  The port keeps that split and reproduces the eight transforms
the reference chains (optax 0.2.6), per tensor and in optax's op order:

* ``Adam``: ``scale_by_adam(b1, b2, eps=1e-8)``: ``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g^2 + b2 nu``, bias correction by the step count, epsilon outside the
  square root, ``u = mu_hat / (sqrt(nu_hat) + eps)``;
* ``SGD``: ``identity``, ``u = g``;
* ``Momentum``: ``trace(momentum, nesterov=True)``: ``t = g + m t``, ``u = g + m t``
  with the new ``t``;
* ``Adadelta``: ``scale_by_adadelta(rho, eps=1e-7)``: ``e_g = (1-rho) g^2 + rho e_g``,
  ``u = sqrt(e_x + eps) / sqrt(e_g + eps) * g`` (eps inside both roots), then
  ``e_x = (1-rho) u^2 + rho e_x``;
* ``RAdam``: ``scale_by_radam(b1, b2, eps=1e-8)``: Adam's moments; where
  ``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)`` reaches 5 (``rho_inf = 2 / (1-b2) - 1``) the
  rectified ``r mu_hat / (sqrt(nu_hat) + eps)``, below it ``mu_hat``;
* ``LAMB``: Adam with eps 1e-6, then ``+ wd p`` on the decayed names, then the trust
  ratio;
* ``LARS``: ``+ wd p`` on the decayed names, the trust ratio with coefficient 0.001,
  then ``trace(momentum)`` when momentum is not 0;
* ``AdamW``: Adam with eps 1e-6, then ``+ wd p`` on the decayed names.

The trust ratio (``scale_by_trust_ratio``) is per parameter name, as optax's leaves are
the entries of the flat dicts: ``c ||p|| / ||u||``, and 1 where either norm is 0.  The
decay mask is the reference's ``_decay_mask``: ``bias``, ``noise_strength`` and the
spectral ``*_u`` vectors are never decayed.

Every optimizer's state has one shape, ``OptState``: the step count and named slot dicts
keyed like the parameters (Adam's ``mu``/``nu``, Momentum's and LARS's ``trace``,
Adadelta's ``e_g``/``e_x``, none for SGD), so freezing, checkpoints and conversion
handle any of them through one code path.  ``Optimizer.optax_paths`` says where optax
keeps each slot in its state tree (``convert.py`` maps between the two).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

OPTIMIZERS = ("Adam", "SGD", "Momentum", "Adadelta", "RAdam", "LAMB", "LARS", "AdamW")
_RADAM_THRESHOLD = 5.0


class OptState(NamedTuple):
    """An optimizer's state: the steps taken (optax's int32 count) and its slot dicts
    ({slot name: {parameter name: tensor}}); ``state.mu`` reads the slot ``mu``."""

    count: int
    slots: Dict[str, Params]

    def __getattr__(self, name):
        try:
            return tuple.__getitem__(self, 1)[name]
        except KeyError:
            raise AttributeError(name) from None


def AdamState(count: int, mu: Params, nu: Params) -> OptState:
    """Adam's (and RAdam's, LAMB's, AdamW's) state: the count and the two moments."""
    return OptState(count, {"mu": mu, "nu": nu})


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _radam_rho_inf(b2: float) -> float:
    """rho_inf = 2 / (1 - b2) - 1 in Python floats, as optax builds it (b2 = 1 raises
    ZeroDivisionError, as optax's constructor does)."""
    return 2.0 / (1.0 - b2) - 1.0


def _radam_rect(b2: float, count: int):
    """(rho_t >= 5, r) of optax's scale_by_radam at step `count`, in its f32 arithmetic
    (the Python-float terms folded in double first, as JAX does with weak types)."""
    rho_inf = _radam_rho_inf(b2)
    b2t = np.float32(b2) ** np.float32(count)
    rho = np.float32(rho_inf) - np.float32(2 * count) * b2t / (np.float32(1) - b2t)
    if not rho >= np.float32(_RADAM_THRESHOLD):
        return False, None
    num = (rho - np.float32(4.0)) * (rho - np.float32(2.0)) * np.float32(rho_inf)
    den = np.float32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho
    return True, float(np.sqrt(num / den))


def decays(name: str) -> bool:
    """The reference's ``_decay_mask`` for one parameter name."""
    leaf = name.rsplit("/", 1)[-1]
    return not (leaf == "bias" or leaf == "noise_strength" or leaf.endswith("_u"))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` of the whole tensor: sqrt(sum(x * x))."""
    return torch.sqrt(torch.sum(x * x))


def _trust_ratio(u: torch.Tensor, p: torch.Tensor, coefficient: float) -> torch.Tensor:
    """optax's scale_by_trust_ratio for one leaf: u * c ||p|| / ||u||, u where a norm
    is 0."""
    pn, un = _norm(p), _norm(u)
    ratio = coefficient * pn / un
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)
    return u * ratio


class Optimizer(NamedTuple):
    """One of the eight optimizers without a learning rate; ``update`` applies
    ``-lr * u``."""

    name: str
    b1: float = 0.0
    b2: float = 0.9
    rho: float = 0.95
    momentum: float = 0.9
    weight_decay: float = 0.01

    @property
    def slot_names(self) -> Tuple[str, ...]:
        if self.name in ("Adam", "RAdam", "LAMB", "AdamW"):
            return ("mu", "nu")
        if self.name == "Momentum" or (self.name == "LARS" and self.momentum):
            return ("trace",)
        if self.name == "Adadelta":
            return ("e_g", "e_x")
        return ()

    @property
    def optax_paths(self) -> Dict[str, tuple]:
        """{"count" or slot name: its path in optax's state tree} (a str is a field of
        a NamedTuple state, an int an entry of a chain's tuple).  "count" is absent where
        optax keeps no count (SGD, Momentum, Adadelta, LARS)."""
        if self.name in ("Adam", "RAdam"):
            return {"count": ("count",), "mu": ("mu",), "nu": ("nu",)}
        if self.name in ("LAMB", "AdamW"):  # chain(scale_by_adam, masked(decay), ...)
            return {"count": (0, "count"), "mu": (0, "mu"), "nu": (0, "nu")}
        if self.name == "LARS":  # chain(masked(decay), trust ratio, trace or identity)
            return {"trace": (2, "trace")} if self.momentum else {}
        return {s: (s,) for s in self.slot_names}

    def init(self, params: Params) -> OptState:
        return OptState(0, {s: {k: torch.zeros_like(v) for k, v in params.items()}
                            for s in self.slot_names})

    def _moments(self, g, mu, nu):
        """Adam's (and RAdam's) new first and second moments."""
        return (1 - self.b1) * g + self.b1 * mu, (1 - self.b2) * (g * g) + self.b2 * nu

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params, lr: float):
        """(new_params, new_state); nothing is modified in place."""
        count = state.count + 1
        name, old = self.name, state.slots
        slots = {s: {} for s in self.slot_names}
        if "mu" in slots:
            c1, c2 = _bias_correction(self.b1, count), _bias_correction(self.b2, count)
        if name == "RAdam":
            rectified, r = _radam_rect(self.b2, count)
        new = {}
        for k, p in params.items():
            g = grads[k]
            if name == "SGD":
                u = g
            elif name == "Momentum":
                t = g + self.momentum * old["trace"][k]
                slots["trace"][k] = t
                u = g + self.momentum * t
            elif name == "Adadelta":
                e_g = (1 - self.rho) * (g * g) + self.rho * old["e_g"][k]
                e_x = old["e_x"][k]
                u = (torch.sqrt(e_x + 1e-7) / torch.sqrt(e_g + 1e-7)) * g
                slots["e_g"][k] = e_g
                slots["e_x"][k] = (1 - self.rho) * (u * u) + self.rho * e_x
            elif name == "RAdam":
                mu, nu = slots["mu"][k], slots["nu"][k] = self._moments(g, old["mu"][k],
                                                                        old["nu"][k])
                mu_hat = mu / c1
                u = r * mu_hat / (torch.sqrt(nu / c2) + 1e-8) if rectified else mu_hat
            elif name == "LARS":
                u = g + self.weight_decay * p if decays(k) else g
                u = _trust_ratio(u, p, 0.001)
                if self.momentum:
                    u = u + self.momentum * old["trace"][k]
                    slots["trace"][k] = u
            else:  # Adam, LAMB, AdamW
                mu, nu = slots["mu"][k], slots["nu"][k] = self._moments(g, old["mu"][k],
                                                                        old["nu"][k])
                u = (mu / c1) / (torch.sqrt(nu / c2) + (1e-8 if name == "Adam" else 1e-6))
                if name != "Adam" and decays(k):
                    u = u + self.weight_decay * p
                if name == "LAMB":
                    u = _trust_ratio(u, p, 1.0)
            new[k] = p + (-lr) * u
        return new, OptState(count, slots)


def make_optimizer(name: str, *, beta1: float = 0.0, beta2: float = 0.9, rho: float = 0.95,
                   momentum: float = 0.9, weight_decay: float = 0.01) -> Optimizer:
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer argument {name!r} not recognized or implemented")
    if name == "RAdam":
        _radam_rho_inf(beta2)  # optax's constructor raises here for b2 = 1
    # a hyperparameter the optimizer does not read may be None, as in the reference
    return Optimizer(name, *(None if v is None else float(v)
                             for v in (beta1, beta2, rho, momentum, weight_decay)))


def make_optimizers_from_config(cfg) -> tuple:
    """(G, D) optimizers from a finalized Config."""
    return (make_optimizer(cfg.optimizer, beta1=cfg.adam_beta1, beta2=cfg.adam_beta2,
                           rho=cfg.rho, momentum=cfg.momentum, weight_decay=cfg.weight_decay),
            make_optimizer(cfg.d_optimizer, beta1=cfg.d_adam_beta1, beta2=cfg.d_adam_beta2,
                           rho=cfg.d_rho, momentum=cfg.d_momentum,
                           weight_decay=cfg.d_weight_decay))
