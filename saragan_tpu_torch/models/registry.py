"""Architecture registry: families by name, one calling convention.

    init(rng, *, phase, cfg, device)                            -> flat G+D Params dict
    generator(params, z, alpha, *, phase, cfg, conv_engine)     -> images
    discriminator(params, x, alpha, *, phase, cfg, conv_engine) -> (N, 1) scores

pgan is ported (generator and discriminator); the other families come with later
slices.  ``disc_cross_sample`` says whether the discriminator mixes samples (a
minibatch-stddev layer): the train step's stacked critic pass is one call on the
concatenated fake and real batches only when it does not.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple


class Architecture(NamedTuple):
    name: str
    init: Callable
    generator: Callable
    discriminator: Callable
    disc_cross_sample: bool = False


_REGISTRY: Dict[str, Architecture] = {}


def register(arch: Architecture) -> Architecture:
    _REGISTRY[arch.name] = arch
    return arch


def get_architecture(name: str) -> Architecture:
    import saragan_tpu_torch.models.pgan  # noqa: F401  (registers itself)

    if name not in _REGISTRY:
        raise ValueError(f"Unknown or not yet ported architecture {name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
