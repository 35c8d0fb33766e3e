"""Architecture registry: families by name, one calling convention.

    init(rng, *, phase, cfg, device)                            -> flat G+D Params dict
    generator(params, z, alpha, *, phase, cfg, conv_engine, noise=None, mix=None,
              train=True, space=None)                           -> images
    discriminator(params, x, alpha, *, phase, cfg, conv_engine, passes=1, mesh=None,
                  space=None)                                   -> (N, 1) scores
    space_plan(cfg, phase, mesh)                                -> per-resolution sharded
    refresh_state(g_params, z, *, phase, cfg)                   -> g_params

All six families of the reference are registered (``saragan_tpu/models/registry.py``).
``noise`` (a noise source, ``ops.core.LayerNoise`` / ``NoiseByName``) and ``mix`` (a
``models.style_ops.StyleMix``, the draws of style mixing) feed the style families'
per-layer noise and style mixing, as the reference's ``rng`` does; None leaves them out,
as the reference does without an rng.  The other families take them and draw nothing.
``train=False`` is the samplers' mode (no style mixing; truncation where the family
applies it).  ``passes`` says how many batches x stacks along axis 0 (the stacked critic
pass): a discriminator that mixes samples (surfgan's minibatch-stddev head) keeps them
apart, the others ignore it.  ``mesh`` (a data-parallel ``parallel.Mesh``) says that x holds
this rank's rows of a global batch: surfgan's head forms its groups over the global
batch, the others ignore it.  ``refresh_state`` is the
style families' per-step w-average update (``d_z_avg``) from a batch of latents `z`;
None for the families without that state.  Every family runs spatially sharded: its
generator and discriminator take ``space=``, a mesh with a space axis, and run on this
rank's slab of each volume as its ``space_plan`` lays the resolutions out
(``models/common.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional


class Architecture(NamedTuple):
    name: str
    init: Callable
    generator: Callable
    discriminator: Callable
    space_plan: Callable
    refresh_state: Optional[Callable] = None


_REGISTRY: Dict[str, Architecture] = {}


def register(arch: Architecture) -> Architecture:
    _REGISTRY[arch.name] = arch
    return arch


def get_architecture(name: str) -> Architecture:
    # imported for their registration
    import saragan_tpu_torch.models.pgan  # noqa: F401
    import saragan_tpu_torch.models.pgan2  # noqa: F401
    import saragan_tpu_torch.models.pgandeep  # noqa: F401
    import saragan_tpu_torch.models.stylegan  # noqa: F401
    import saragan_tpu_torch.models.stylegan2  # noqa: F401
    import saragan_tpu_torch.models.surfgan  # noqa: F401

    if name not in _REGISTRY:
        raise ValueError(f"Unknown architecture {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
