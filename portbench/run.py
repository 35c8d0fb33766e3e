"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/`` and
``saragan_tpu_torch/``.  The cell's traffic kind picks its driver
(``portbench/drivers/<kind>.py``), which sets up from the seed, warms every shape the cell
uses, measures for ``--seconds``, and then checks the timed path's output against the
plain reference (``portbench/reference/``).  ``setup_s`` runs from the process's start to
the window's.  With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the run measures the same window, then profiles a fixed number of steps
or dispatches, and its metrics are the per-layer ones (``portbench/metrics/<name>.py``).

The last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (with ``busy_s`` and ``window_s`` when traced),
``breakdown`` when traced, and last ``checks``: each number compared with its value and
limit (also the last lines of standard error).  No result is printed, and the exit code is
not 0, without a CUDA device, with fewer devices than the cell asks for, or when JAX or the
JAX package is loaded in this process once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

from portbench import PROCESS_START

FORBIDDEN = ("jax", "jaxlib", "flax", "saragan_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the JAX
    package's (compared whole: ``saragan_tpu_torch`` is not ``saragan_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _finite(obj):
    """`obj` with every float that is not finite (a number compared that overflowed) as
    None, so that the line is strict JSON."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def run_cell(cell, seed: int, seconds: float, trace: bool, device=None) -> dict:
    """The driver's run plus the per-layer readings; the result object, without the
    device fields the caller adds."""
    from portbench import compare, spec

    out = spec.driver(cell.kind).run(cell, seed, seconds, trace, device=device)
    if trace:
        record = out.get("record", {})
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=out["window_start"] - PROCESS_START)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, checks = compare.judge(out["numbers"], cell.limits)
    return dict(correct=bool(correct and out["failed"] == 0), attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, out=out, checks=checks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import spec

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"the cell needs {cell.chips} devices, {torch.cuda.device_count()} present")
    # the port's nvcc builds stay in the checkout (saragan_tpu_torch/build/); nothing of
    # the run is cached elsewhere but under HOME, XDG_CACHE_HOME or TMPDIR
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        _fail(f"loaded in the benchmark's process: {', '.join(found)}", 3)
    out = res["out"]
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell.chips,
                  memory_peak_bytes=int(out["memory_peak_bytes"]))
    line = dict(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
                metrics=res["metrics"], device=device)
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["trace_window_s"])
        line["breakdown"] = out["breakdown"]
    line["checks"] = res["checks"]
    card = _card()
    print(f"portbench: {cell.name} seed {args.seed}: {out.get('note', '')}; card {card}",
          file=sys.stderr)
    beside = {k: v for k, v in out["numbers"].items() if k not in res["checks"]}
    print("beside (not judged): " + ", ".join(f"{k} {v:.6g}" for k, v in beside.items()),
          file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
