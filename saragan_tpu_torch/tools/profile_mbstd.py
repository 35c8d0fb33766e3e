"""Time the minibatch standard-deviation kernel (#5) input by input, three ways.

    python -m saragan_tpu_torch.tools.profile_mbstd [--out FILE]

The inputs (``mbstd_inputs``) are those ``chip_smoke.py`` checks: group 4 at N 8 and 16,
at the per-sample feature counts of the largest and the smallest activation of the
phase-6 pgan discriminator, f32 and bf16, and one group size that is not a template size
of the kernel (3, N 12, the largest activation, f32).  Each is timed as
``profile_fused.time_three_ways`` does: ``ms`` (median of per-call CUDA events, the
host's part inside), ``device_ms`` (calls queued behind ``torch.cuda._sleep``, per call)
and ``host_us`` (the host's enqueue time per call); with the bound, bytes / 3.35 TB/s, and
the kernels' registers and spills.  It times whichever ``saragan_tpu_torch`` comes first on
the import path, the CUDA kernel of this tree or the Triton kernels of an earlier one:
``PYTHONPATH=<checkout> python saragan_tpu_torch/tools/profile_mbstd.py``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from saragan_tpu_torch.config import Config
from saragan_tpu_torch.ops import minibatch_stddev as mb
from saragan_tpu_torch.tools.profile_fused import time_three_ways
from saragan_tpu_torch.tools.profile_serving import BENCH_CFG

HBM_BYTES_PER_S = 3.35e12


def mbstd_inputs(phase: int = 6):
    """[(label, shape, dtype, group_size)]: the eight inputs of group 4 and one of group 3."""
    cfg = Config(**BENCH_CFG, starting_phase=phase, ending_phase=phase).finalize()
    fs = cfg.resolved_filter_spec()

    def sp(p):
        return [d * 2 ** (p - 1) for d in cfg.base_shape[1:]]

    feats = {"largest": (fs[phase - 1][1], *sp(phase)), "smallest": (fs[0][0], *sp(1))}
    out = [(which, (n, *feat), dtype, 4) for which, feat in feats.items() for n in (8, 16)
           for dtype in (torch.float32, torch.bfloat16)]
    out.append(("largest, G 3", (12, *feats["largest"]), torch.float32, 3))
    return out


def kernel(x, group_size):
    """The kernel wrapper of the package on the path: this tree's CUDA kernel, or an
    earlier tree's Triton kernels."""
    fn = getattr(mb, "minibatch_stddev_stat_cuda", None) or mb.minibatch_stddev_stat_triton
    return fn(x, group_size)


def bound_ms(x: torch.Tensor, groups: int) -> float:
    """Bytes the statistic must move (x read once, the result written once) over the
    card's memory rate; its 5 operations per element take far less at 67 TFLOP/s."""
    return (x.numel() * x.element_size() + groups * 4) / HBM_BYTES_PER_S * 1e3


def resources() -> dict:
    """Registers and spills of the kernels that ran: ptxas's report for the CUDA library,
    or Triton's ``n_regs`` / ``n_spills``."""
    if hasattr(mb, "_triton_kernels"):
        from saragan_tpu_torch.tools.profile_fused import kernel_resources
        return kernel_resources(mb)
    from saragan_tpu_torch.ops import _build
    mb._library()
    return {row["function"]: dict(registers=row["registers"], spill_stores=row["spill_stores"],
                                  spill_loads=row["spill_loads"])
            for row in _build.ptxas_report(_build.build_log("minibatch_stddev"))}


def profile() -> dict:
    g = torch.Generator(device="cuda").manual_seed(6)
    rows, sums = [], dict(ms=0.0, device_ms=0.0, host_us=0.0, bound_ms=0.0)
    for which, shape, dtype, group in mbstd_inputs():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        groups = shape[0] // min(group, shape[0])
        t = time_three_ways(lambda: kernel(x, group))
        t["bound_ms"] = bound_ms(x, groups)
        rows.append(dict(which=which, shape=list(shape), dtype=str(dtype), group_size=group, **t))
        if group == 4:  # the sums keep the eight inputs of earlier runs
            for k in sums:
                sums[k] += t[k]
        print(f"mbstd {str(dtype)[6:]} {shape} G {group} ({which}): ms {t['ms']:.4f}, "
              f"device_ms {t['device_ms']:.4f}, host_us {t['host_us']:.1f}, bound "
              f"{t['bound_ms']:.4f}{'' if t['queued_ahead'] else ' (NOT queued ahead)'}",
              flush=True)
        del x
    return dict(inputs=rows, sums=sums)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--out", help="write the report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mbstd: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    report = profile()
    report.update(card=card, module=mb.__file__, resources=resources())
    print("sums over the eight group-4 inputs: " + json.dumps(report["sums"]), flush=True)
    print("kernels: " + json.dumps(report["resources"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
