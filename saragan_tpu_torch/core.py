"""Parameter scopes: flat parameter dicts keyed by TF-style scope names.

The port keeps the reference's parameter format (``saragan_tpu/core.py``): a flat dict
``{"generator/generator_in/dense/weight": tensor, ...}`` with the reference's shapes, so
npz checkpoints load in either package and progressive growing restores by name
intersection.

``Scope`` walks the name hierarchy.  In apply mode ``get`` reads a parameter.  In init
mode it creates a missing parameter from a per-name ``torch.Generator`` seeded from the
root generator's seed and a stable hash of the full name, so a layer's init does not
depend on creation order or on the phase it first appears in.  The init forward runs on
the ``meta`` device (``get`` hands back a meta view), which computes only shapes: no
activation is materialized, as the reference's ``jax.eval_shape`` init does.  The
values follow the reference's distributions, not JAX's threefry bits.

``spectral`` > 0 spectrally normalizes every weight ``ops.core.get_weight`` reads under
the scope, with that many power iterations (the discriminator's scope under
``use_spectral_norm``; reference ``saragan_tpu/core.py:49-65``).  ``hook``, where set,
maps every parameter read in apply mode (a spatially sharded model's replicated layers
read theirs through ``parallel.halo.lead_only``).
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]


def _stable_hash(name: str) -> int:
    """Deterministic 32-bit hash of a parameter name (process-independent)."""
    return zlib.crc32(name.encode("utf-8"))


def _name_seed(root_seed: int, name: str) -> int:
    return (root_seed * 0x9E3779B97F4A7C15 + _stable_hash(name)) % (1 << 63)


class Scope:
    """Named access to a flat parameter dict, mirroring TF variable scopes."""

    def __init__(self, params: Params, prefix: str = "", *, init: bool = False,
                 rng: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32, spectral: int = 0,
                 hook: Optional[Callable] = None):
        self.params = params
        self.prefix = prefix
        self.init = init
        self.rng = rng
        self.device = device
        self.dtype = dtype
        self.spectral = spectral
        self.hook = hook

    def sub(self, name: str) -> "Scope":
        return Scope(self.params, self.path(name), init=self.init, rng=self.rng,
                     device=self.device, dtype=self.dtype, spectral=self.spectral,
                     hook=self.hook)

    def hooked(self, hook: Optional[Callable]) -> "Scope":
        """This scope with every parameter read through `hook` (None: unchanged)."""
        if hook is None:
            return self
        return Scope(self.params, self.prefix, init=self.init, rng=self.rng,
                     device=self.device, dtype=self.dtype, spectral=self.spectral, hook=hook)

    def path(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def get(self, name: str, shape: Sequence[int], initializer: Callable) -> torch.Tensor:
        """Create (init mode) or read (apply mode) a named parameter."""
        full = self.path(name)
        if self.init:
            if full not in self.params:
                if self.rng is None:
                    raise ValueError(f"Scope in init mode needs an rng (param {full!r})")
                gen = torch.Generator().manual_seed(_name_seed(self.rng.initial_seed(), full))
                value = initializer(gen, tuple(shape), self.dtype)
                self.params[full] = value.to(self.device)
            return self.params[full].to("meta")
        try:
            value = self.params[full]
        except KeyError:
            raise KeyError(f"Parameter {full!r} not found; params has {len(self.params)} "
                           f"entries (e.g. {list(self.params)[:4]})") from None
        return value if self.hook is None else self.hook(value)


def normal_initializer(stddev: float) -> Callable:
    def init(gen, shape, dtype):
        return stddev * torch.randn(shape, generator=gen, dtype=dtype)

    return init


def zeros_initializer() -> Callable:
    def init(gen, shape, dtype):
        return torch.zeros(shape, dtype=dtype)

    return init


def filter_params(params: Params, prefix: str) -> Params:
    """All parameters whose name starts with `prefix` (a scope path)."""
    pre = prefix if prefix.endswith("/") else prefix + "/"
    return {k: v for k, v in params.items() if k.startswith(pre) or k == prefix}


def param_count(params: Params, prefix: str = "") -> int:
    sub = filter_params(params, prefix) if prefix else params
    return sum(int(v.numel()) for v in sub.values())


def intersect_restore(current: Params, checkpoint) -> Params:
    """Name-intersection partial restore: every name in both takes the checkpoint value
    (shapes must match, dtype and device follow `current`); the rest keep theirs."""
    out = dict(current)
    for k, v in checkpoint.items():
        if k in out:
            if tuple(out[k].shape) != tuple(v.shape):
                raise ValueError(f"Shape mismatch restoring {k}: have {tuple(out[k].shape)}, "
                                 f"checkpoint {tuple(v.shape)}")
            out[k] = torch.as_tensor(v, dtype=out[k].dtype, device=out[k].device)
    return out
