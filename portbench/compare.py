"""The numbers that decide ``correct``, and their limits.

The program's first three steps (stabilizing, mixing, mixing) against the reference's,
from the same weights, batches and draws.  Each side hands over a ``Trail``: the three
steps' losses, the gradient of step 1 and of step 2 (the first mixing step) as the
optimizer got them, and the parameters and the EMA after steps 1 and 3.

Which leaves and entries count: a leaf whose reference gradient at step 1 is under a
thousandth of the median leaf's (no gradient reaches it but round-off), or whose gradient in
the reference rounded as the configuration computes (values and cotangents in its compute
dtype) is under a thousandth of its float32 gradient, is left out of every leaf number.
Within a counted leaf, the entries whose step-1 gradient that rounded reference gives as
under a thousandth of the float32 one are left out of the leaf's change and EMA norms.
Such a gradient is nought to the configuration's rounding (the drift term's 2e-3 D(x)
under the critic's +-1/N cotangents, which bf16 rounds to +-1/N): Adam turns the float32
reference's residue into a full step of ``lr`` that a program computing as configured
cannot take.  The leaves frozen in the mixing step are left out of its numbers.

Numbers (per leaf, then the median leaf or the worst, as named, unless whole):

* ``grad_diff``, ``mix_grad_diff``: the whole gradient's ``||g_prog - g_ref|| / ||g_ref||``
  over the counted leaves, of step 1 and of step 2 (over the leaves the mixing step
  moves); ``grad_diff_leaf``, ``mix_grad_diff_leaf``: the same per leaf, the median leaf;
  ``diff_worst``, ``mix_diff_worst``: the worst leaf;
* ``change_gap``: the gap of the norms of the parameters' change over the three steps,
  ``| ||d_prog|| - ||d_ref|| |`` over the larger of the reference's norm and the median
  leaf's; the median leaf.  ``change_worst``: the worst leaf;
* ``mix_change_gap``, ``mix_change_worst``: the same for the change of steps 2 and 3
  alone, over the leaves the mixing step moves;
* ``ema_gap``, ``ema_worst``, ``mix_ema_gap``, ``mix_ema_worst``: the same for the EMA;
* ``loss_gap``: over the three steps and over gen_loss and disc_loss the largest
  ``|program - reference| / max(|reference|, 1)``; ``grad_gap``: step 1's gradient's gap
  of norms at the worst leaf.

Which of them are judged, and their limits, is the cell's limits file
(``portbench/limits/<cell>.json``), with the readings each limit was set from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import torch

LEAF_FLOOR = 1e-3  # of the median leaf's gradient norm
ROUNDING_FLOOR = 1e-3  # of the leaf's own float32 gradient norm


class Trail(NamedTuple):
    losses: list  # three (gen_loss, disc_loss, ...) rows
    grad1: Dict[str, torch.Tensor]
    grad2: Dict[str, torch.Tensor]
    theta1: Dict[str, torch.Tensor]
    theta3: Dict[str, torch.Tensor]
    ema1: Dict[str, torch.Tensor]
    ema3: Dict[str, torch.Tensor]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double().reshape(-1)))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: Iterable[str]):
    """Per leaf ``|prog - ref| / max(ref, the median leaf's ref)``."""
    names = list(names)
    if not names:
        return [0.0]
    median = statistics.median(ref[k] for k in names)
    return [abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names]


def counted_leaves(ref_grad_norms: Dict[str, float],
                   rounded_grad_norms: Optional[Dict[str, float]] = None) -> set:
    """The leaves that count (module docstring)."""
    median = statistics.median(ref_grad_norms.values())
    keep = {k for k, v in ref_grad_norms.items() if v >= LEAF_FLOOR * median}
    if rounded_grad_norms is not None:
        keep = {k for k in keep if rounded_grad_norms[k] >= ROUNDING_FLOOR * ref_grad_norms[k]}
    return keep


def _minus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() - b.float().to(a.device)


def _change(a, b, names, masks=None):
    out = {}
    for k in names:
        d = _minus(a[k], b[k])
        out[k] = _norm(d if masks is None else d * masks[k].to(d.device))
    return out


def _direction(prog, ref, names):
    """Per leaf (||g_prog - g_ref||, ||g_ref||)."""
    return {k: (_norm(_minus(prog[k], ref[k])), _norm(ref[k])) for k in names}


def leaf_readings(prog: Trail, ref: Trail, theta0, frozen: Iterable[str],
                  ref_grad1_rounded: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Per leaf, every norm the numbers are made of: {"leaves": {name: {...}}, ...}."""
    ref_g = {k: _norm(v) for k, v in ref.grad1.items()}
    rounded = (None if ref_grad1_rounded is None
               else {k: _norm(v) for k, v in ref_grad1_rounded.items()})
    keep = counted_leaves(ref_g, rounded)
    masks = None
    if ref_grad1_rounded is not None:
        masks = {k: ref_grad1_rounded[k].abs() >= ROUNDING_FLOOR * ref.grad1[k].abs()
                 for k in ref.grad1}
    frozen = set(frozen)
    names = sorted(ref.grad1)
    mix = [k for k in names if k not in frozen]
    out = {k: dict(ref_g1=ref_g[k], prog_g1=_norm(prog.grad1[k]), counted=k in keep,
                   mix=k in set(mix)) for k in names}
    if rounded is not None:
        for k in names:
            out[k]["rounded_g1"] = rounded[k]
            out[k]["entries_left_out"] = int((~masks[k]).sum())
    for key, vals in (("diff1", _direction(prog.grad1, ref.grad1, names)),
                      ("diff2", _direction(prog.grad2, ref.grad2, mix))):
        for k, (d, r) in vals.items():
            out[k][key] = d / max(r, 1e-30)
            out[k][key + "_abs"], out[k][key + "_ref"] = d, r
    for key, vals in (("prog_d3", _change(prog.theta3, theta0, names, masks)),
                      ("ref_d3", _change(ref.theta3, theta0, names, masks)),
                      ("prog_e3", _change(prog.ema3, theta0, names, masks)),
                      ("ref_e3", _change(ref.ema3, theta0, names, masks)),
                      ("prog_d23", _change(prog.theta3, prog.theta1, mix, masks)),
                      ("ref_d23", _change(ref.theta3, ref.theta1, mix, masks)),
                      ("prog_e23", _change(prog.ema3, prog.ema1, mix, masks)),
                      ("ref_e23", _change(ref.ema3, ref.ema1, mix, masks))):
        for k, v in vals.items():
            out[k][key] = v
    loss_gap = 0.0
    for p, r in zip(prog.losses, ref.losses):
        for i in (0, 1):  # gen_loss, disc_loss
            loss_gap = max(loss_gap, abs(float(p[i]) - float(r[i])) / max(abs(float(r[i])), 1.0))
    return dict(leaves=out, loss_gap=loss_gap)


def numbers_of(readings: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(numbers, notes): every number of the module docstring from ``leaf_readings``, and
    the name of the leaf behind each worst one and of the leaves left out."""
    leaves = readings["leaves"]
    counted = sorted(k for k, v in leaves.items() if v["counted"])
    mix = [k for k in counted if leaves[k]["mix"]]
    numbers, notes = dict(loss_gap=readings["loss_gap"]), {}

    def put(median_name, worst_name, names, values):
        if not names:
            return
        worst = max(range(len(names)), key=lambda i: values[i])
        numbers[median_name] = statistics.median(values)
        numbers[worst_name] = values[worst]
        notes[worst_name] = names[worst]

    for whole, median_name, worst_name, names, key in (
            ("grad_diff", "grad_diff_leaf", "diff_worst", counted, "diff1"),
            ("mix_grad_diff", "mix_grad_diff_leaf", "mix_diff_worst", mix, "diff2")):
        if names:
            numbers[whole] = (math.sqrt(sum(leaves[k][key + "_abs"] ** 2 for k in names))
                              / max(math.sqrt(sum(leaves[k][key + "_ref"] ** 2
                                                  for k in names)), 1e-30))
            put(median_name, worst_name, names, [leaves[k][key] for k in names])
    for median_name, worst_name, names, p, r in (
            ("change_gap", "change_worst", counted, "prog_d3", "ref_d3"),
            ("ema_gap", "ema_worst", counted, "prog_e3", "ref_e3"),
            ("mix_change_gap", "mix_change_worst", mix, "prog_d23", "ref_d23"),
            ("mix_ema_gap", "mix_ema_worst", mix, "prog_e23", "ref_e23")):
        if names:
            put(median_name, worst_name, names,
                leaf_gaps({k: leaves[k][p] for k in names}, {k: leaves[k][r] for k in names},
                          names))
    if counted:
        grads = leaf_gaps({k: leaves[k]["prog_g1"] for k in counted},
                          {k: leaves[k]["ref_g1"] for k in counted}, counted)
        numbers["grad_gap"] = max(grads)
    numbers = {k: (v if math.isfinite(v) else float("inf")) for k, v in numbers.items()}
    notes["left_out"] = ",".join(sorted(k for k, v in leaves.items() if not v["counted"]))
    return numbers, notes


def judge(numbers: Dict[str, float], limits: Optional[Dict[str, float]]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits name: every one
    present, finite and at most its limit; without limits nothing is correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in numbers.items()}
    shown = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
             for k, lim in limits.items()}
    ok = all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
             for k, lim in limits.items())
    return ok, shown
