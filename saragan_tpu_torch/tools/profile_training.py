"""Where the time of one flagship train step goes, on the card; and what the memory
levers buy at the big-volume phases.

    python -m saragan_tpu_torch.tools.profile_training [--phase 6] [--batch 8] [--steps 5]
        [--compute_dtype bfloat16|float32] [--architecture pgan|surfgan|...]
        [--conv_engine flat direct ...]
    python -m saragan_tpu_torch.tools.profile_training --probe --phase 8 --batch 2
        [--single_chip_big_volume] [--remat] [--remat_offload] [--gradient_accumulation K]
        [--preset_model]
    python -m saragan_tpu_torch.tools.profile_training --sweep [--phases 7 8]
        [--max_batch 32]

The configuration is the reference bench's (``bench.py:99-119``, ``make_cfg``): 3-D
pgan 'xs', start (1,1,4,4), final (1,128,512,512), latent 256, WGAN-GP with weight 10,
Adam (beta1 0, beta2 0.9, lr 1e-3), bf16 activations with f32 parameters, Adam state and
EMA, fused transitions, shared-fake-pass gradients and the stacked critic pass, and the
fused bias+act+pixel-norm on, so that under ``flat`` every kernel of the port runs.
``--architecture`` runs another family at the same settings (surfgan: the bench's flags
with ``architecture="surfgan"``; the fused op is pgan's and does not run there).
Parameters come from the port's seeded init and the batch from numpy, both on the card.
The step is driven as ``bench.py:122-164`` (``measure_step``) drives it:
``init_train_state``, then
``make_train_step`` for the stabilizing half (``static_alpha=0.0``) and the mixing half
(alpha 0.5 as a tensor), one warm-up step, then steps chained on the returned state.

For each engine (``--conv_engine``, any of ``ops.core.CONV_ENGINES``; ``flat`` and
``direct`` by default) and half: the time of each step (CUDA events
around it; median), the peak device memory of a step, and a torch.profiler breakdown of
one more step's device time by kernel group, with its kernel count and the host's launch
calls.  The idle share is 1 - that device time /
the median step time (the profiled step itself runs slower: the profiler adds host work
to every launch).  What holds the card idle is read from the host side: the host time
to enqueue one step that starts on an idle card (``host_ms``; near the step time, the
step is bound by the host) and the profiled step's operators by self CPU time.  Prints
JSON lines and writes ``chiprun_out/profile_training.json``; needs a CUDA device.

``--probe`` runs one configuration of the same step under ``flat`` with the memory
levers asked for (the mixing half, alpha 0.5 as a tensor; a batch drawn on the card):
one warm-up step, then the median of `--steps` steps (CUDA events), volumes per second,
``torch.cuda.max_memory_allocated`` over the timed steps and the bytes the step parked in
host memory (``remat_offload``), as one JSON line ``{"probe": {...}}``; an out-of-memory
error is reported there (``"oom": true``), not raised.  ``--preset_model`` gives the
probe the preset's model flags (the critic's passes unstacked, the transitions unfused)
without its lever.  ``--sweep`` runs a probe per process (so an out-of-memory ends only
that probe) for each phase and each entry of ``SWEEP_LEVERS`` at batch 1, 2, 4, ... up
to the first that does not fit or `--max_batch`, and writes
``chiprun_out/memory_sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import CONV_ENGINES
from saragan_tpu_torch.tools.profile_serving import BENCH_CFG
from saragan_tpu_torch.train.step import init_train_state, make_train_step

# the final shape that reaches phase 8 (128x512x512) from the bench's start (bench.py:218)
PHASE8_FINAL_SHAPE = "(1, 256, 1024, 1024)"

# the model flags the single_chip_big_volume preset sets besides remat_offload
PRESET_MODEL = dict(batched_passes=False, fused_transitions=False)

# bench.py's step names (bench.py:283-291): alpha 0.5 traced, and static alpha 0
HALVES = (("mixing", None, 0.5), ("stabilizing", 0.0, 0.0))


def bench_train_config(phase: int, batch: int, *, compute_dtype: str = "bfloat16",
                       **levers) -> Config:
    """The port's counterpart of ``bench.py::make_cfg(phase, batch)``, plus the fused
    bias+act+pixel-norm; `levers` sets Config fields such as ``remat``,
    ``remat_offload``, ``gradient_accumulation``, ``single_chip_big_volume`` or the
    model flags of ``PRESET_MODEL``.  Phase 8 (128x512x512) lies past the bench's final
    shape, so there the final shape is doubled once more, as ``bench.py:205-231`` builds
    its phase-8 step; the model at a phase does not depend on the final shape."""
    shapes = dict(BENCH_CFG, final_shape=PHASE8_FINAL_SHAPE) if phase > 7 else BENCH_CFG
    fields = dict(shapes, base_batch_size=batch * 2 ** (phase - 1), loss_fn="wgan",
                  gp_weight=10.0, noise_stddev=0.0, adam_beta1=0.0, adam_beta2=0.9,
                  g_lr=1e-3, d_lr=1e-3, compute_dtype=compute_dtype, fused_transitions=True,
                  fused_grads=True, use_pallas_fusion=True, starting_phase=phase,
                  ending_phase=phase)
    return Config(**{**fields, **levers}).finalize()


def real_batch(cfg: Config, phase: int, batch: int, device) -> torch.Tensor:
    """A random 'real' batch from numpy (N(0, 1) from seed 0, as bench.py stages it), on
    `device`."""
    shape = cfg.current_shape(phase, batch)
    volumes = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return torch.from_numpy(volumes).to(device)


def run_steps(step, state, real, rng, alpha, n):
    """`n` chained steps; returns (state, [ms per step by CUDA events], [metrics])."""
    events, metrics = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, real, rng, alpha, 1e-3, 1e-3)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    return state, [s.elapsed_time(e) for s, e in events], metrics


HOST_STEPS = 10  # steps whose host enqueue time is taken, per half (median)


def kernel_group(name: str) -> str:
    if "conv3d_fwd_tc_kernel" in name:
        return "conv3d_flat forward+dgrad (tensor cores)"
    if "wgrad_tc_partial_kernel" in name or "wgrad_tc_reduce_kernel" in name:
        return "conv3d_wgrad (tensor cores)"
    if "conv3d_fwd_kernel" in name:
        return "conv3d_flat forward+dgrad (CUDA)"
    if "wgrad_partial_kernel" in name or "wgrad_reduce_kernel" in name:
        return "conv3d_wgrad (CUDA)"
    if "fused_fwd_kernel" in name:
        return "fused_bias_act_pixelnorm (CUDA)"
    if "fused_bwd_kernel" in name:
        return "fused_bias_act_pixelnorm backward (CUDA)"
    if any(t in name for t in ("xmma", "cudnn", "implicit_gemm", "conv", "dgrad", "fprop",
                               "wgrad")):
        return "cuDNN convolutions"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "GEMM (cuBLAS)"
    if "reduce" in name.lower():
        return "reductions"
    return "elementwise and other"


def launch_counts(prof) -> tuple:
    """(kernels, launch_calls) of a torch.profiler trace: the kernels it saw run on the
    card (PyTorch's, the library's and Triton's alike; copies and fills excluded), and
    the host's launch calls (the runtime's cudaLaunchKernel, Triton's cuLaunchKernel*)."""
    kernels = sum(1 for evt in prof.events() if evt.device_type == torch.autograd.DeviceType.CUDA
                  and not evt.name.startswith(("Memcpy", "Memset")))
    launch_calls = sum(1 for evt in prof.events()
                       if evt.device_type == torch.autograd.DeviceType.CPU
                       and "LaunchKernel" in evt.name)
    return kernels, launch_calls


def profile_one_step(step, state, real, rng, alpha):
    """Device time of one step by kernel group and by the operator (with its input
    shapes) that launched it, from torch.profiler; the step's own time under the
    profiler is `profiled_step_ms`."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        start.record()
        state, _ = step(state, real, rng, alpha, 1e-3, 1e-3)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.device_time_total / 1e3
    groups = {}
    for name, ms in by_kernel.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    device_ms = sum(by_kernel.values())
    kernels, launch_calls = launch_counts(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    ops = sorted(prof.key_averages(group_by_input_shape=True),
                 key=lambda a: -a.self_device_time_total)[:10]
    cpu = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]
    return state, dict(profiled_step_ms=step_ms, device_ms=device_ms, kernels=kernels,
                       launch_calls=launch_calls,
                       groups=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                       top_kernels=[[n[:90], ms] for n, ms in top],
                       top_ops=[[a.key, str(a.input_shapes)[:160], a.count,
                                 a.self_device_time_total / 1e3] for a in ops],
                       top_cpu_ops=[[a.key[:90], a.count, a.self_cpu_time_total / 1e3]
                                    for a in cpu])


def host_enqueue_ms(step, state, real, rng, alpha, n):
    """Host milliseconds to enqueue each of `n` steps, each started on an idle card (a
    synchronize before, none inside the timed call)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, real, rng, alpha, 1e-3, 1e-3)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return state, times


def measure(cfg, phase, batch, engine, steps, device):
    """Both halves under `engine`: {half: {step_ms, step_ms_all, peak_mib, losses,
    profile, idle_share, host_ms, host_ms_all}}."""
    arch = get_architecture(cfg.architecture)
    state, (g_opt, d_opt) = init_train_state(arch, torch.Generator().manual_seed(0),
                                             phase=phase, cfg=cfg, device=device)
    real = real_batch(cfg, phase, batch, device)
    rng = torch.Generator(device=device).manual_seed(1)
    out = {}
    for half, static_alpha, alpha in HALVES:
        step = make_train_step(arch, cfg, phase, g_opt, d_opt, static_alpha=static_alpha,
                               conv_engine=engine)
        state, _, _ = run_steps(step, state, real, rng, alpha, 1)  # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        state, ms, metrics = run_steps(step, state, real, rng, alpha, steps)
        row = dict(step_ms=statistics.median(ms), step_ms_all=ms,
                   peak_mib=torch.cuda.max_memory_allocated(device) / 2 ** 20,
                   losses=[[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)]
                           for m in metrics])
        state, row["profile"] = profile_one_step(step, state, real, rng, alpha)
        row["idle_share"] = max(0.0, 1.0 - row["profile"]["device_ms"] / row["step_ms"])
        state, row["host_ms_all"] = host_enqueue_ms(step, state, real, rng, alpha, HOST_STEPS)
        row["host_ms"] = statistics.median(row["host_ms_all"])
        out[half] = row
    return out


def probe(cfg: Config, phase: int, batch: int, steps: int, device) -> dict:
    """One configuration's step under ``flat`` (the mixing half): ms per step (median of
    `steps` after a warm-up), volumes per second, peak device MiB over the timed steps,
    MiB parked in host memory per step, the losses; ``oom`` where it does not fit."""
    row = dict(phase=phase, batch=batch, compute_dtype=cfg.compute_dtype, remat=cfg.remat,
               remat_offload=cfg.remat_offload,
               gradient_accumulation=cfg.gradient_accumulation,
               batched_passes=cfg.batched_passes, fused_transitions=cfg.fused_transitions)
    try:
        arch = get_architecture(cfg.architecture)
        state, (g_opt, d_opt) = init_train_state(arch, torch.Generator().manual_seed(0),
                                                 phase=phase, cfg=cfg, device=device)
        real = torch.randn(cfg.current_shape(phase, batch),
                           generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
        rng = torch.Generator(device=device).manual_seed(1)
        step = make_train_step(arch, cfg, phase, g_opt, d_opt, static_alpha=None,
                               conv_engine="flat")
        state, _, _ = run_steps(step, state, real, rng, 0.5, 1)  # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        state, ms, metrics = run_steps(step, state, real, rng, 0.5, steps)
    except (torch.cuda.OutOfMemoryError, RuntimeError) as e:  # device or pinned host memory
        if "out of memory" not in str(e).lower():
            raise
        return dict(row, oom=True, error=str(e).splitlines()[0][:200])
    losses = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
    return dict(row, oom=False, step_ms=statistics.median(ms), step_ms_all=ms,
                vol_s=batch / statistics.median(ms) * 1e3,
                peak_mib=torch.cuda.max_memory_allocated(device) / 2 ** 20,
                host_mib=step.parked_bytes / 2 ** 20,
                finite=all(math.isfinite(v) for row_ in losses for v in row_), losses=losses)


# the sweep's rows, as flags of a probe: each lever on the preset's model (the preset is
# remat_offload on it), and the bench's model (stacked critic passes, fused transitions)
# with no lever, for what the model flags cost apart from the levers
SWEEP_LEVERS = {"none": ["--preset_model"], "remat": ["--preset_model", "--remat"],
                "preset": ["--single_chip_big_volume"],
                "preset+ga2": ["--single_chip_big_volume", "--gradient_accumulation", "2"],
                "bench model": []}
PROBE_TIMEOUT_S = 600.0


def sweep(phases, max_batch: int, steps: int) -> list:
    """A probe per process for each phase and entry of ``SWEEP_LEVERS`` at batch 1 (2
    under accumulation), doubling to the first that does not fit or `max_batch`."""
    rows = []
    root = Path(__file__).resolve().parents[2]
    for phase in phases:
        for lever in SWEEP_LEVERS:
            batch = 2 if "ga2" in lever else 1
            while batch <= max_batch:
                cmd = [sys.executable, "-m", "saragan_tpu_torch.tools.profile_training",
                       "--probe", "--phase", str(phase), "--batch", str(batch),
                       "--steps", str(steps), *SWEEP_LEVERS[lever]]
                try:
                    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                                       timeout=PROBE_TIMEOUT_S)
                    lines = [l for l in r.stdout.splitlines() if l.startswith('{"probe"')]
                    row = (json.loads(lines[-1])["probe"] if lines else
                           dict(phase=phase, batch=batch, oom=None, rc=r.returncode,
                                error=r.stderr[-400:]))
                except subprocess.TimeoutExpired:
                    row = dict(phase=phase, batch=batch, oom=None,
                               error=f"timeout {PROBE_TIMEOUT_S} s")
                row["lever"] = lever
                rows.append(row)
                print(json.dumps({k: v for k, v in row.items()
                                  if k not in ("losses", "step_ms_all")}), flush=True)
                if row.get("oom") is not False:
                    break
                batch *= 2
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", type=int, default=6)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--architecture", default="pgan",
                   help="the family (the bench's settings otherwise)")
    p.add_argument("--probe", action="store_true", help="one configuration, one JSON line")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_offload", action="store_true")
    p.add_argument("--gradient_accumulation", type=int, default=1)
    p.add_argument("--single_chip_big_volume", action="store_true")
    p.add_argument("--preset_model", action="store_true",
                   help="the preset's batched_passes and fused_transitions (off), no lever")
    p.add_argument("--sweep", action="store_true",
                   help="probes per process over phases, levers and doubling batches")
    p.add_argument("--phases", type=int, nargs="+", default=[7, 8])
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--conv_engine", nargs="+", default=["flat", "direct"],
                   choices=CONV_ENGINES,
                   help="the engines to trace, in turn (the JAX package's SARAGAN_CONV3D)")
    args = p.parse_args(argv)
    dev = resolve_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = Path(__file__).resolve().parents[2] / "chiprun_out"
    if args.probe:
        cfg = bench_train_config(args.phase, args.batch, compute_dtype=args.compute_dtype,
                                 architecture=args.architecture, remat=args.remat,
                                 remat_offload=args.remat_offload,
                                 gradient_accumulation=args.gradient_accumulation,
                                 single_chip_big_volume=args.single_chip_big_volume,
                                 **(PRESET_MODEL if args.preset_model else {}))
        print(json.dumps({"probe": dict(probe(cfg, args.phase, args.batch, args.steps, dev),
                                        card=card)}), flush=True)
        return
    print(card, flush=True)
    if args.sweep:
        rows = sweep(args.phases, args.max_batch, args.steps)
        out.mkdir(exist_ok=True)
        (out / "memory_sweep.json").write_text(json.dumps(dict(card=card, rows=rows), indent=1))
        return
    cfg = bench_train_config(args.phase, args.batch, compute_dtype=args.compute_dtype,
                             architecture=args.architecture)
    report = dict(card=card, architecture=args.architecture, phase=args.phase,
                  batch=args.batch, compute_dtype=args.compute_dtype, engines={})
    for engine in args.conv_engine:
        report["engines"][engine] = measure(cfg, args.phase, args.batch, engine, args.steps, dev)
        print(json.dumps({engine: report["engines"][engine]}), flush=True)
    out.mkdir(exist_ok=True)
    (out / "profile_training.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
