"""Small helpers of the reference's ``utils.py`` (counterpart of ``saragan_tpu/utils.py``),
with the same signatures and results.

``parse_tuple`` lives in ``config`` and the parameter count in ``core``, as in the JAX
package; both are re-exported here.  ``enable_compile_cache`` has no counterpart: it
configures XLA's persistent compilation cache, and the port compiles nothing at run time
but its CUDA sources, whose nvcc builds are already cached by the digest of source and
flags (``ops/_build.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from saragan_tpu_torch.config import parse_tuple  # noqa: F401
from saragan_tpu_torch.core import param_count


def count_parameters(params: dict, scope: str = "") -> int:
    """The number of parameter entries under the scope path `scope` (all with "")."""
    return param_count(params, scope)


def get_num_metric_samples(num_metric_samples: Optional[int], batch_size: int,
                           global_size: int) -> int:
    """The samples a metric pass draws: `num_metric_samples`, or one global batch (two
    per worker at batch 1)."""
    if not num_metric_samples:
        return batch_size * global_size if batch_size > 1 else 2 * global_size
    return num_metric_samples


def get_verbosity(horovod: bool, optuna_distributed: bool) -> bool:
    """Whether this process prints: under a parallel run only worker 0
    (``SARAGAN_WORKER_ID``, else the process-group rank)."""
    if horovod or optuna_distributed:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        return int(os.environ.get("SARAGAN_WORKER_ID", rank)) == 0
    return True


def print_study_summary(study):
    """The finished trials' count and the best trial's value and parameters."""
    print("Number of finished trials: ", len(study.trials))
    print("Best trial:")
    trial = study.best_trial
    print(" Value: ", trial.value)
    print(" Params: ")
    for key, value in trial.params.items():
        print(f"    {key}: {value}")


def dump_weight_for_debugging(params: dict, name: str = "generator/generator_in/dense/weight"):
    """Print the first element of the parameter `name`."""
    if name not in params:
        print(f"{name} is not in params")
        return
    v = params[name]
    v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    label = name
    while v.ndim > 0:
        v = v[0]
        label = f"{label}[0]"
    print(f"{label}: {v}")


def uniform_box_sampler(arr, min_width, max_width, rng: Optional[np.random.Generator] = None):
    """A random box of `arr`: per axis a start uniform in [0, dim) and a width uniform in
    [min_width, max_width] (an int for every axis or one per axis), drawn from `rng` in
    the reference's order; returns (slices, arr[slices])."""
    if rng is None:
        rng = np.random.default_rng()
    widths = []
    for width in (min_width, max_width):
        if isinstance(width, (tuple, list)):
            if len(width) != arr.ndim:
                raise ValueError(f"width {width} does not match an array of rank {arr.ndim}")
            widths.append(tuple(width))
        else:
            widths.append((width,) * arr.ndim)
    slices = []
    for dim, mn, mx in zip(arr.shape, *widths):
        start = int(rng.uniform(0, dim))
        stop = start + int(rng.uniform(mn, mx + 1))
        slices.append(slice(start, stop))
    return tuple(slices), arr[tuple(slices)]
