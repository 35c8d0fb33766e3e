"""Time the fused bias + leaky ReLU + pixel norm kernels (#4) shape by shape, three ways.

    python -m saragan_tpu_torch.tools.profile_fused [--out FILE]

At each shape the phase-6 batch-8 flagship generator runs the op with (eleven calls per
serving forward and per train step): the forward in f32 (serving), the forward in bf16
and the backward in bf16 (the train step), each timed

- ``ms``: the median of per-call CUDA events (``profile_serving.time_ms``); the host's
  part of the call lies inside that window;
- ``device_ms``: ``CALLS`` calls queued behind ``torch.cuda._sleep`` long enough that the
  host has enqueued them all before the card starts (checked: the event before them has
  not completed when the host is done), CUDA events around the batch, divided by
  ``CALLS``; the median of three;
- ``host_us``: the wall clock of ``CALLS`` enqueues without a synchronize, divided by
  ``CALLS``; the median of three;

with the sums over the eleven calls, and the kernels' registers, spills and barriers:
ptxas's report and the SASS's ``BAR.SYNC`` count for the CUDA kernels, or ``n_regs``,
``n_spills`` and the PTX's ``bar.sync`` and ``cp.async`` counts for Triton kernels.  It
times whichever ``saragan_tpu_torch`` comes first on the import path, so an earlier
checkout is timed by the same code:
``PYTHONPATH=<checkout> python saragan_tpu_torch/tools/profile_fused.py``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

from saragan_tpu_torch.config import Config
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.tools.profile_serving import BENCH_CFG, time_ms

CALLS = 50
SLEEP_HZ = 2.0e9  # cycles per second that torch.cuda._sleep spins at, at most


def fused_shapes(phase: int = 6, batch: int = 8):
    """The fused op's activation shapes in one generator forward (fused transitions on),
    in the order pgan's generator runs them."""
    cfg = Config(**BENCH_CFG, starting_phase=phase, ending_phase=phase).finalize()
    fs = cfg.resolved_filter_spec()

    def sp(p):
        return tuple(d * 2 ** (p - 1) for d in cfg.base_shape[1:])

    shapes = [(batch, fs[0][1], *sp(1))]
    for i in range(2, phase + 1):
        shapes += [(batch, fs[i - 1][0], *sp(i)), (batch, fs[i - 1][1], *sp(i))]
    return shapes


def time_three_ways(fn, calls: int = CALLS) -> dict:
    """{ms, device_ms, host_us, queued_ahead} of one call of `fn` (see the module note)."""
    ms = time_ms(fn)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    host_us = statistics.median(host)
    cycles = int(4 * host_us * 1e-6 * calls * SLEEP_HZ) + 100_000
    device, ahead = [], True
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        ahead = ahead and not start.query()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / calls)
    return dict(ms=ms, device_ms=statistics.median(device), host_us=host_us, queued_ahead=ahead)


def _triton_compiled(jit):
    """The compiled kernels of one Triton JITFunction, across Triton versions."""
    caches = getattr(jit, "device_caches", None)
    if caches:
        return [k for entry in caches.values() for k in entry[0].values()]
    return [k for cache in getattr(jit, "cache", {}).values() for k in cache.values()]


def kernel_resources(module=fba) -> dict:
    """{kernel: [{registers, spills, barriers}, ...]} of the module's compiled kernels:
    Triton's, where the module has them, else its CUDA library's (ptxas and SASS)."""
    out = {}
    triton_kernels = getattr(module, "_triton_kernels", None)
    if triton_kernels is not None:
        for jit in triton_kernels():
            rows = []
            for k in _triton_compiled(jit):
                if hasattr(k, "_init_handles"):
                    k._init_handles()
                rows.append(dict(registers=getattr(k, "n_regs", None),
                                 spills=getattr(k, "n_spills", None),
                                 barriers=k.asm["ptx"].count("bar.sync"),
                                 async_copies=k.asm["ptx"].count("cp.async"),
                                 num_warps=getattr(getattr(k, "metadata", None), "num_warps",
                                                   None)))
            out[getattr(jit, "__name__", None) or jit.fn.__name__] = rows
        return out
    from saragan_tpu_torch.ops import _build
    module._library()  # built if needed
    for row in _build.ptxas_report(_build.build_log("fused_bias_act")):
        out.setdefault(kernel_label(row["function"]), []).append(dict(
            registers=row["registers"], spill_stores=row["spill_stores"],
            spill_loads=row["spill_loads"]))
    for fn, count in sass_barriers("fused_bias_act").items():
        for row in out.get(kernel_label(fn), []):
            row["barriers"] = count
    return out


def kernel_label(mangled: str) -> str:
    """A mangled entry of csrc/fused_bias_act.cu as name<type, async, pixelnorm, vpt>."""
    for name in ("fused_fwd_kernel", "fused_bwd_kernel"):
        if name in mangled:
            args = mangled.split(name, 1)[1]
            dtype = "bf16" if "bfloat16" in args.split("E", 1)[0] else "f32"
            return f"{name}<{dtype},{','.join(re.findall(r'L[bi](\d+)E', args))}>"
    return mangled


def sass_barriers(name: str) -> dict:
    """{mangled function: BAR.SYNC instructions} in the SASS of ``csrc/<name>.cu``'s
    library (cuobjdump from nvcc's toolkit)."""
    from saragan_tpu_torch.ops import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "BAR.SYNC" in line:
            counts[fn] += 1
    return counts


def profile(shapes=None) -> dict:
    """Per shape and direction the three times (bound alongside), and their sums over the
    shapes' calls."""
    shapes = shapes or fused_shapes()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, sums = [], {}
    for shape, count in Counter(shapes).items():
        n, c = shape[:2]
        s = math.prod(shape[2:])
        x32 = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(c, generator=g, device="cuda")
        x, gy = x32.bfloat16(), torch.randn(shape, generator=g, device="cuda").bfloat16()
        for what, fn, nbytes in (
                ("forward f32", lambda: fba.fused_bias_act_pixelnorm(x32, b, 0.2, True),
                 2 * n * c * s * 4 + c * 4),
                ("forward bf16", lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True),
                 2 * n * c * s * 2 + c * 4),
                ("backward bf16", lambda: fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True),
                 3 * n * c * s * 2 + 2 * c * 4)):
            t = time_three_ways(fn)
            t["bound_ms"] = nbytes / 3.35e12 * 1e3
            rows.append(dict(shape=list(shape), calls=count, direction=what, **t))
            total = sums.setdefault(what, dict(ms=0.0, device_ms=0.0, host_us=0.0, bound_ms=0.0))
            for k in total:
                total[k] += count * t[k]
            print(f"{what} {shape} x{count}: ms {t['ms']:.4f}, device_ms {t['device_ms']:.4f}, "
                  f"host_us {t['host_us']:.1f}, bound {t['bound_ms']:.4f}"
                  f"{'' if t['queued_ahead'] else ' (NOT queued ahead)'}", flush=True)
        del x32, x, gy
    return dict(shapes=rows, sums=sums)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--out", help="write the report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fused: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    report = profile()
    report.update(card=card, module=fba.__file__, resources=kernel_resources())
    print("sums over the eleven calls: " + json.dumps(report["sums"]), flush=True)
    print("kernels: " + json.dumps(report["resources"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
