"""Where the time of one flagship train step goes, on the card.

    python -m saragan_tpu_torch.tools.profile_training [--phase 6] [--batch 8] [--steps 5]

The configuration is the reference bench's (``bench.py:99-119``, ``make_cfg``): 3-D
pgan 'xs', start (1,1,4,4), final (1,128,512,512), latent 256, WGAN-GP with weight 10,
Adam (beta1 0, beta2 0.9, lr 1e-3), bf16 activations with f32 parameters, Adam state and
EMA, fused transitions, shared-fake-pass gradients and the stacked critic pass, and the
fused bias+act+pixel-norm on, so that under ``flat`` every kernel of the port runs.
Parameters come from the port's seeded init and the batch from numpy, both on the card.
The step is driven as ``bench.py:122-164`` (``measure_step``) drives it:
``init_train_state``, then
``make_train_step`` for the stabilizing half (``static_alpha=0.0``) and the mixing half
(alpha 0.5 as a tensor), one warm-up step, then steps chained on the returned state.

For each engine (``flat``, ``direct``) and half: the time of each step (CUDA events
around it; median), the peak device memory of a step, and a torch.profiler breakdown of
one more step's device time by kernel group.  The idle share is 1 - that device time /
the median step time (the profiled step itself runs slower: the profiler adds host work
to every launch).  What holds the card idle is read from the host side: the host time
to enqueue one step that starts on an idle card (``host_ms``; near the step time, the
step is bound by the host) and the profiled step's operators by self CPU time.  Prints
JSON lines and writes ``chiprun_out/profile_training.json``; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.tools.profile_serving import BENCH_CFG
from saragan_tpu_torch.train.step import init_train_state, make_train_step

# bench.py's step names (bench.py:283-291): alpha 0.5 traced, and static alpha 0
HALVES = (("mixing", None, 0.5), ("stabilizing", 0.0, 0.0))


def bench_train_config(phase: int, batch: int, *, compute_dtype: str = "bfloat16") -> Config:
    """The port's counterpart of ``bench.py::make_cfg(phase, batch)``, plus the fused
    bias+act+pixel-norm."""
    return Config(**BENCH_CFG, base_batch_size=batch * 2 ** (phase - 1), loss_fn="wgan",
                  gp_weight=10.0, noise_stddev=0.0, adam_beta1=0.0, adam_beta2=0.9,
                  g_lr=1e-3, d_lr=1e-3, compute_dtype=compute_dtype, fused_transitions=True,
                  fused_grads=True, use_pallas_fusion=True, starting_phase=phase,
                  ending_phase=phase).finalize()


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
    if name == "fused_kernel":
        return "fused_bias_act_pixelnorm (Triton)"
    if any(t in name for t in ("xmma", "cudnn", "implicit_gemm", "conv", "dgrad", "fprop",
                               "wgrad")):
        return "cuDNN convolutions"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "GEMM (cuBLAS)"
    if "reduce" in name.lower():
        return "reductions"
    return "elementwise and other"


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
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    ops = sorted(prof.key_averages(group_by_input_shape=True),
                 key=lambda a: -a.self_device_time_total)[:10]
    cpu = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]
    return state, dict(profiled_step_ms=step_ms, device_ms=device_ms,
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
    arch = get_architecture("pgan")
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", type=int, default=6)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    dev = resolve_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = bench_train_config(args.phase, args.batch)
    report = dict(card=card, phase=args.phase, batch=args.batch, engines={})
    print(card, flush=True)
    for engine in ("flat", "direct"):
        report["engines"][engine] = measure(cfg, args.phase, args.batch, engine, args.steps, dev)
        print(json.dumps({engine: report["engines"][engine]}), flush=True)
    out = Path(__file__).resolve().parents[2] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_training.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
