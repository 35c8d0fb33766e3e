"""Previous-phase freezing (counterpart of ``saragan_tpu/optim/freeze.py``).

In the mixing half of a phase the reference trains only the layers the phase added: the
parameters carried over from the previous phase get neither updates nor optimizer-slot
changes.  As in the reference, the full update is computed and then the old value is
selected again for every frozen name, in the parameter dict and in every slot dict of
the optimizer state, which are keyed by the same names.
"""

from __future__ import annotations

from typing import FrozenSet

from saragan_tpu_torch.optim.factory import OptState


def freeze_select(old, new, frozen_names: FrozenSet[str]):
    """`old` for every entry keyed by a frozen parameter name, else `new`.

    Takes a flat parameter dict or an ``OptState`` of any optimizer (each slot dict is
    selected per name; the step count takes the new value)."""
    if not frozen_names:
        return new
    if isinstance(new, OptState):
        return OptState(new.count, {s: freeze_select(old.slots[s], d, frozen_names)
                                    for s, d in new.slots.items()})
    return {k: (old[k] if k in frozen_names else v) for k, v in new.items()}


def apply_freeze_names(params: dict, prev_params: dict) -> FrozenSet[str]:
    """Names to freeze: those already present in the previous phase."""
    return frozenset(k for k in params if k in prev_params)
