"""Gradient accumulation (counterpart of ``saragan_tpu/optim/accumulate.py``): the
gradients and the reported scalars of K micro-batches, each summed in f32 in micro-batch
order and divided by K, for one optimizer apply.  The reference scans the micro-batches
in one XLA program; here a Python loop runs them one after the other, so one
micro-batch's activations are alive at a time."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def split_microbatches(batch: torch.Tensor, num_micro: int) -> torch.Tensor:
    """(N, ...) -> (num_micro, N / num_micro, ...), a view."""
    n = batch.shape[0]
    if n % num_micro != 0:
        raise ValueError(
            f"gradient_accumulation={num_micro} must divide the per-process "
            f"batch size (got batch {n}); pick a batch size that is a "
            f"multiple of the accumulation factor")
    return batch.reshape((num_micro, n // num_micro) + tuple(batch.shape[1:]))


def _tree_map(fn, *trees):
    """`fn` over the leaves of equally shaped trees of tuples, lists, dicts and tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        out = [_tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else type(first)(out)
    return fn(*trees)


def grad_accumulate(grad_fn: Callable, batch: torch.Tensor, draws: Sequence,
                    num_micro: int):
    """``grad_fn(micro_batch, micro_draws) -> (grads, aux)``, trees of tensors, averaged
    over `num_micro` slices of `batch` with ``draws[k]`` for slice k: each leaf summed in
    f32 in slice order, then divided by `num_micro`.  With ``num_micro <= 1`` it is
    ``grad_fn(batch, draws[0])``."""
    if num_micro <= 1:
        return grad_fn(batch, draws[0])
    micro = split_microbatches(batch, num_micro)
    if len(draws) != num_micro:
        raise ValueError(f"{num_micro} micro-batches need as many draws; got {len(draws)}")
    total = None
    for mb, d in zip(micro, draws):
        out = _tree_map(lambda x: x.float(), grad_fn(mb, d))
        total = out if total is None else _tree_map(torch.add, total, out)
    return _tree_map(lambda x: x / num_micro, total)
