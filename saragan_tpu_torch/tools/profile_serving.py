"""Where the time of one serving forward goes, on the card.

    python -m saragan_tpu_torch.tools.profile_serving [--phase 6] [--batch 8]
        [--conv_engine direct flat ...]

For the pgan 'xs' generator with random weights (the bench configuration), under each
conv engine of ``--conv_engine`` (``direct`` and ``flat`` by default): the device time
of one keyed-sampler forward (CUDA events, median of 20) and a torch.profiler breakdown
of its device time by kernel, grouped into the port's two kernels, cuDNN convolutions
and everything else.  Then the fused upscale+conv of
every generator block in its polyphase form (what ``ops.core.upscale_conv`` runs)
against the same product as one stride-2 transposed conv, both through cuDNN with
deterministic algorithms and TF32 off.  Prints JSON lines and writes
``chiprun_out/profile_serving.json``; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import core as ops
from saragan_tpu_torch.tools.generate import make_keyed_sampler

BENCH_CFG = dict(architecture="pgan", start_shape="(1, 1, 4, 4)",
                 final_shape="(1, 128, 512, 512)", latent_dim=256, network_size="xs")


def time_ms(fn, reps=20, warmup=3):
    """Median device time of one call: CUDA events around each of `reps` calls."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _group(name: str) -> str:
    if "conv3d_fwd_kernel" in name:
        return "conv3d_flat (CUDA kernel)"
    if "fused_fwd_kernel" in name:
        return "fused_bias_act_pixelnorm (CUDA kernel)"
    if any(t in name for t in ("xmma", "cudnn", "implicit_gemm", "conv", "dgrad", "fprop")):
        return "cuDNN convolutions"
    return "other"


def profile_forward(sampler, params, batch):
    seeds = np.arange(batch, dtype=np.int32)
    forward_ms = time_ms(lambda: sampler(params, seeds, seeds))
    reps = 5
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            sampler(params, seeds, seeds)
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.device_time_total / 1e3 / reps
    groups = {}
    for name, ms in by_kernel.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    device_ms = sum(by_kernel.values())
    return dict(forward_ms=forward_ms, device_ms_per_forward=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / forward_ms), groups=groups,
                top_kernels=[[n[:90], ms] for n, ms in top])


def transposed_upscale_conv(x, w):
    """conv(repeat(x), w) as one stride-2 transposed conv with the box-summed kernel."""
    r = x.ndim - 2
    wp = w
    for axis in range(r):
        z = torch.zeros_like(wp.narrow(axis, 0, 1))
        wp = torch.cat([z, wp], dim=axis) + torch.cat([wp, z], dim=axis)
    wt = wp.permute(r, r + 1, *range(r)).flip(dims=tuple(range(2, r + 2)))
    return F.conv_transpose3d(x, wt, stride=2, padding=tuple((k - 1) // 2 for k in w.shape[:r]))


def upscale_conv_ab(cfg, phase, batch, dev):
    ks, fs = cfg.resolved_kernel_spec(), cfg.resolved_filter_spec()
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for i in range(2, phase + 1):
        spatial = [d * 2 ** (i - 2) for d in cfg.base_shape[1:]]
        x = torch.randn((batch, fs[i - 2][1], *spatial), generator=g, device=dev)
        w = torch.randn((*ks[i - 1][0], fs[i - 2][1], fs[i - 1][0]), generator=g, device=dev)
        w = w * (2.0 / w[..., 0].numel()) ** 0.5
        ref = ops.conv_apply(ops.upscale(x), w, "direct")
        err_poly = (ops.upscale_conv(x, w) - ref).abs().max().item()
        err_t = (transposed_upscale_conv(x, w) - ref).abs().max().item()
        rows.append(dict(block=i, x=list(x.shape), w=list(w.shape),
                         polyphase_ms=time_ms(lambda: ops.upscale_conv(x, w)),
                         transposed_ms=time_ms(lambda: transposed_upscale_conv(x, w), reps=5),
                         polyphase_max_abs_err=err_poly, transposed_max_abs_err=err_t))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", type=int, default=6)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conv_engine", nargs="+", default=["direct", "flat"],
                   choices=ops.CONV_ENGINES,
                   help="the engines to trace, in turn (the JAX package's SARAGAN_CONV3D)")
    args = p.parse_args(argv)
    dev = resolve_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = Config(**BENCH_CFG, starting_phase=args.phase, ending_phase=args.phase).finalize()
    params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=args.phase,
                                           cfg=cfg, device=dev)
    report = dict(card=card, phase=args.phase, batch=args.batch, engines={})
    for engine in args.conv_engine:
        sampler = make_keyed_sampler(cfg, args.phase, args.batch, device=dev, conv_engine=engine)
        report["engines"][engine] = profile_forward(sampler, params, args.batch)
        print(json.dumps({engine: report["engines"][engine]}), flush=True)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        report["upscale_conv"] = upscale_conv_ab(cfg, args.phase, args.batch, dev)
    for row in report["upscale_conv"]:
        print(json.dumps(row), flush=True)
    out = Path(__file__).resolve().parents[2] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_serving.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
