"""Parameters and train states between the JAX package's numpy form and the port's
tensors.

Both packages key parameters by the same scope names with the same shapes (conv
weights stay ``(*kernel, in, out)``), so conversion is a per-entry copy.  A train state
is G and D parameters, each network's Adam state (count, mu, nu, keyed like the
parameters, as optax's ``ScaleByAdamState`` over the flat dicts is) and the EMA over
G+D, so both packages can start a trajectory from the same state.
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


def train_state_from_numpy(tree: Mapping, device):
    """A ``train.step.TrainState`` from numpy: ``tree`` has "g_params", "d_params",
    "ema" ({name: array}) and "g_opt", "d_opt" ({"count": int, "mu": {...},
    "nu": {...}})."""
    from saragan_tpu_torch.optim.factory import AdamState
    from saragan_tpu_torch.train.step import TrainState

    def opt(o):
        return AdamState(int(o["count"]), params_from_numpy(o["mu"], device),
                         params_from_numpy(o["nu"], device))

    return TrainState(params_from_numpy(tree["g_params"], device),
                      params_from_numpy(tree["d_params"], device), opt(tree["g_opt"]),
                      opt(tree["d_opt"]), params_from_numpy(tree["ema"], device))


def train_state_to_numpy(state) -> Dict[str, object]:
    """The inverse of train_state_from_numpy."""
    def opt(o):
        return {"count": np.int32(o.count), "mu": params_to_numpy(o.mu),
                "nu": params_to_numpy(o.nu)}

    return {"g_params": params_to_numpy(state.g_params),
            "d_params": params_to_numpy(state.d_params), "g_opt": opt(state.g_opt),
            "d_opt": opt(state.d_opt), "ema": params_to_numpy(state.ema)}
