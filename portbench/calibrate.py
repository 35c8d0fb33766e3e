"""The readings that the limits of ``correct`` are set from, for one cell, in one process.

    python3 -m portbench.calibrate --workload <name> --seeds <n> ... \
        --control_seeds <n> ... [--seconds 2]

Lower readings: for each of ``--seeds``, one run of the cell as the benchmark runs it
(``run.run_cell``: set-up, a window of ``--seconds``, the check), its numbers.  Upper
readings, for each of ``--control_seeds``, at the cell's own size and inputs, each against
the float32 reference and judged by the cell's limits (where it has them):

* ``float8_control``: the reference in fp8 (the step below the configuration's bf16: e4m3
  values and e5m2 gradients, one scale a tensor) put in the program's place;
* ``half_batch``: the reference with half of the batch left out (the mean over the rest);
* ``mix_alpha``: the reference with 1 - alpha in its mixing steps (a wrong fade-in);
* ``rounded_witness``: the reference with values and cotangents rounded to the
  configuration's compute dtype: not a control but a second witness that rounds as the
  program does (its per-leaf gradients show which leaves that rounding leaves unmoved).

Each reading is one line on standard output; every reading with its per-leaf norms goes to
``chiprun_out/calibrate_<workload>.json``, rewritten after each seed.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import compare, spec
from portbench.reference import train as rt
from portbench.reference.ops import FP8, Rounding

CONTROLS = ("float8_control", "half_batch", "mix_alpha", "rounded_witness")


def train_controls(cell, seed: int, device="cuda") -> dict:
    """{control: {"numbers", "notes", "correct", "readings", "seconds"}} at the cell's size."""
    from portbench.drivers import train_step as ts

    t = cell.traffic
    phase, batch = int(t["phase"]), int(t["batch"])
    cfg = ts.port_config(cell.config["config"], phase)
    ref_cfg = rt.model_cfg(cell.config["config"])
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    weights = ts.make_weights(rt.param_shapes(ref_cfg, phase), seed, device)
    inputs = ts.make_inputs(ref_cfg, cfg, phase, batch, 3, dtype, seed, device,
                            **ts.volume_spread(t))
    halves = ts.first_halves(cfg, t)
    ref, rounded = ts.reference_steps(ref_cfg, phase, weights, inputs, halves, device,
                                      rule_dtype=None if dtype == torch.float32 else dtype)
    frozen = rt.frozen_names(ref_cfg, phase)
    kinds = dict(float8_control=dict(q=Rounding(**FP8)),
                 half_batch=dict(rows=slice(0, batch // 2)),
                 mix_alpha=dict(swap_alpha=True),
                 rounded_witness=dict(q=Rounding(dtype, dtype)))
    out = {}
    for name in CONTROLS:
        t0 = time.time()
        low, _ = ts.reference_steps(ref_cfg, phase, weights, inputs, halves, device,
                                    **kinds[name])
        readings = compare.leaf_readings(low, ref, weights, frozen, rounded)
        numbers, notes = compare.numbers_of(readings)
        correct, _ = compare.judge(numbers, cell.limits)
        out[name] = dict(numbers=numbers, notes=notes,
                         correct=correct if cell.limits else None, readings=readings,
                         seconds=time.time() - t0)
        del low
    return out


def _brief(row: dict) -> dict:
    """`row` without its per-leaf readings, for standard output."""
    if "readings" in row:
        return {k: v for k, v in row.items() if k != "readings"}
    return {k: (_brief(v) if isinstance(v, dict) else v) for k, v in row.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from portbench.run import run_cell

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    out = Path(spec.ROOT) / "chiprun_out"
    out.mkdir(exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(_brief(row)), flush=True)
        (out / f"calibrate_{args.workload}.json").write_text(json.dumps(rows))

    for seed in args.seeds:
        t0 = time.time()
        res = run_cell(cell, seed, args.seconds, False)
        emit(dict(kind="program", seed=seed, seconds=time.time() - t0,
                  correct=res["correct"], numbers=res["out"]["numbers"],
                  note=res["out"].get("note", ""), readings=res["out"]["readings"]))
        del res
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.time()
        controls = train_controls(cell, seed)
        emit(dict(kind="control", seed=seed, seconds=time.time() - t0, controls=controls))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
