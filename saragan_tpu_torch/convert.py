"""Parameters and train states between the JAX package's numpy form and the port's
tensors.

Both packages key parameters by the same scope names with the same shapes (conv
weights stay ``(*kernel, in, out)``), so conversion is a per-entry copy.  A train state
is G and D parameters, each network's optimizer state and the EMA over G+D.  An
optimizer state's numpy form is ``{"count": int, <slot>: {name: array}, ...}`` with the
slots of ``optim.factory.OptState`` (Adam's ``mu``/``nu``, a ``trace``, Adadelta's
``e_g``/``e_x``).  ``opt_state_from_optax`` and ``opt_state_into_optax`` map between it
and the state tree optax keeps for the same optimizer (read and rebuilt by field name and
chain index, without importing optax), so both packages can start a trajectory from the
same state.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from saragan_tpu_torch.core import Params


def params_from_numpy(np_params: Mapping[str, np.ndarray], device) -> Params:
    """{name: array} -> {name: tensor on `device`}, keys, shapes and dtypes unchanged."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device) for k, v in np_params.items()}


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of params_from_numpy."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def opt_state_from_numpy(tree: Mapping, device):
    """An ``OptState`` from its numpy form: "count" and one dict per slot."""
    from saragan_tpu_torch.optim.factory import OptState

    return OptState(int(tree["count"]), {s: params_from_numpy(d, device)
                                         for s, d in tree.items() if s != "count"})


def opt_state_to_numpy(state) -> Dict[str, object]:
    """The inverse of opt_state_from_numpy."""
    return {"count": np.int32(state.count),
            **{s: params_to_numpy(d) for s, d in state.slots.items()}}


def _at(tree, path):
    for step in path:
        tree = tree[step] if isinstance(step, int) else getattr(tree, step)
    return tree


def _with(tree, path, value):
    """`tree` with the entry at `path` replaced (tuples rebuilt, NamedTuples through
    ``_replace``)."""
    if not path:
        return value
    step, rest = path[0], path[1:]
    if isinstance(step, int):
        return tuple(_with(t, rest, value) if i == step else t for i, t in enumerate(tree))
    return tree._replace(**{step: _with(getattr(tree, step), rest, value)})


def opt_state_from_optax(optimizer, optax_state) -> Dict[str, object]:
    """The numpy form of `optimizer`'s state from the same optimizer's optax state tree
    (count 0 where optax keeps none)."""
    paths = optimizer.optax_paths
    tree = {"count": np.int32(np.asarray(_at(optax_state, paths["count"])))
            if "count" in paths else np.int32(0)}
    for s in optimizer.slot_names:
        tree[s] = {k: np.asarray(v) for k, v in _at(optax_state, paths[s]).items()}
    return tree


def opt_state_into_optax(optimizer, tree: Mapping, template):
    """`template` (an optax state tree of the same optimizer, e.g. its ``init``) holding
    the numpy form `tree`'s count and slots."""
    for key, path in optimizer.optax_paths.items():
        value = (np.asarray(tree["count"], np.int32) if key == "count"
                 else {k: np.asarray(v) for k, v in tree[key].items()})
        template = _with(template, path, value)
    return template


def train_state_from_numpy(tree: Mapping, device):
    """A ``train.step.TrainState`` from numpy: ``tree`` has "g_params", "d_params",
    "ema" ({name: array}) and "g_opt", "d_opt" (optimizer states in numpy form)."""
    from saragan_tpu_torch.train.step import TrainState

    return TrainState(params_from_numpy(tree["g_params"], device),
                      params_from_numpy(tree["d_params"], device),
                      opt_state_from_numpy(tree["g_opt"], device),
                      opt_state_from_numpy(tree["d_opt"], device),
                      params_from_numpy(tree["ema"], device))


def train_state_to_numpy(state) -> Dict[str, object]:
    """The inverse of train_state_from_numpy."""
    return {"g_params": params_to_numpy(state.g_params),
            "d_params": params_to_numpy(state.d_params),
            "g_opt": opt_state_to_numpy(state.g_opt), "d_opt": opt_state_to_numpy(state.d_opt),
            "ema": params_to_numpy(state.ema)}
