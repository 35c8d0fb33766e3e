#!/usr/bin/env python3
"""Drive the PyTorch port (saragan_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA device -> exit 1 before anything else;
2. build: nvcc compiles every CUDA source of the port (one process per source, all
   started together) and the build time is printed;
3. kernels against their plain PyTorch versions, on the card, at every shape the
   phase-6 batch-8 serving forward gives them (TF32 off):
   - fused bias+lrelu+pixel-norm (Triton): rtol 1e-5, atol 1e-6, pixel norm on and off;
   - conv3d forward (CUDA C++): max|kernel - plain| <= 1e-4 * max|plain|;
   with each kernel's time, its plain version's time, F.conv3d's time (the library
   yardstick; the port's flat engine never calls it) and the least time the card could
   take for the same work;
4. serving: a phase-6 pgan 'xs' generator with random weights from the port's own init,
   served over HTTP under the `direct` and then the `flat` conv engine; four concurrent
   requests (1, 3, 8, 8 volumes of 32x128x128) must come back finite and of the right
   shape, be coalesced, equal the same requests served alone bit for bit, launch 11
   fused kernels and 6 (flat) or 0 (direct) conv kernels per dispatch and no plain
   version; the two engines must agree;
5. training: the reference bench's flagship step (``bench.py:99-119``: pgan 'xs',
   WGAN-GP, Adam, bf16 activations with f32 state, fused transitions, shared-fake-pass
   gradients, the stacked critic pass) at phase 6, batch 8, with the fused op on, from the
   port's seeded init on the card and random 'real' volumes from numpy.  Under `flat`
   and then `direct`: per half (mixing at alpha 0.5, stabilizing at static alpha 0) one
   warm-up step and 5 timed steps (CUDA events, median) with the peak device memory;
   every loss finite, parameters and EMA moved; under `flat` each step launches the
   forward, dgrad, wgrad and fused kernels as often as its warm-up step did and no plain
   version runs; under `direct` no conv kernel runs;
6. training kernels against their plain versions, on the card, at every shape that
   step launched them with, in f32 and bf16 (TF32 off): max|kernel - plain| <= 1e-4
   (f32) or 1e-2 (bf16) * max|plain|; the wgrad bit-identical across two runs; the fused
   op's backward equal to autograd of its plain version (rtol 1e-5, f32); each with its
   time, its plain version's, the library call's (``F.conv3d`` for forward and dgrad,
   ``aten.convolution_backward`` with only the weight mask for wgrad) and its bound;
7. one f32 step's gradients under `flat` and `direct` from the same state and the same
   pre-drawn z and gamma: losses within 1e-3 relative, every gradient within
   1e-3 * max|g|;
8. one JSON line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch import losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import _build
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.tools.generate import _load_generator_params, make_keyed_sampler
from saragan_tpu_torch.tools.profile_serving import BENCH_CFG, time_ms
from saragan_tpu_torch.tools.profile_training import (HALVES, bench_train_config, real_batch,
                                                       run_steps)
from saragan_tpu_torch.tools.serve import GeneratorService, make_server
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.step import init_train_state, make_grads_fn, make_train_step

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory, f32 outside
# the tensor cores (TF32 is off on both paths) and bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TRAIN_STEPS = 5

PHASE, BATCH = 6, 8
REQUESTS = [(1, 101), (3, 102), (8, 103), (8, 104)]  # (num_samples, seed)
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def serving_shapes(cfg, phase, batch):
    """The fused-op activations and the flat-engine conv (x, w) shapes of one forward,
    in the order pgan's generator runs them (fused transitions on)."""
    ks, fs = cfg.resolved_kernel_spec(), cfg.resolved_filter_spec()

    def sp(p):
        return tuple(d * 2 ** (p - 1) for d in cfg.base_shape[1:])

    fused = [(batch, fs[0][1], *sp(1))]
    convs = [((batch, fs[0][0], *sp(1)), (*ks[0][1], fs[0][0], fs[0][1]))]
    for i in range(2, phase + 1):
        fused += [(batch, fs[i - 1][0], *sp(i)), (batch, fs[i - 1][1], *sp(i))]
        convs.append(((batch, fs[i - 1][0], *sp(i)), (*ks[i - 1][1], fs[i - 1][0], fs[i - 1][1])))
    return fused, convs


def bound(nbytes, nops, peak_flops=F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / peak_flops * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def check_fused(fused_shapes, detail):
    g = torch.Generator(device="cuda").manual_seed(0)
    entry = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for shape, count in Counter(fused_shapes).items():
        x = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(shape[1], generator=g, device="cuda")
        for pixelnorm in (True, False):
            y = fba.fused_bias_act_pixelnorm(x, b, 0.2, pixelnorm)
            ref = fba.bias_act_pixelnorm_plain(x, b, 0.2, pixelnorm)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            excess = (err - (1e-6 + 1e-5 * ref.abs())).max().item()
            check(excess <= 0 and torch.isfinite(y).all().item(),
                  f"fused kernel {shape} pixelnorm={pixelnorm}: tolerance exceeded by {excess}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err.max().item())
        ms = time_ms(lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True))
        plain_ms = time_ms(lambda: fba.bias_act_pixelnorm_plain(x, b, 0.2, True))
        n, c = shape[:2]
        s = x[0, 0].numel()
        # per element: bias add, select, slope multiply, square, sum, scale; per voxel
        # the mean and rsqrt.  One read of x and b, one write of y.
        b_ms, t_bytes, t_ops = bound((2 * n * c * s + c) * 4, 6 * n * c * s + 2 * n * s)
        detail.append(dict(kernel="fused_bias_act_pixelnorm", shape=list(shape), calls=count,
                           ms=ms, plain_ms=plain_ms, bound_ms=b_ms))
        print(f"fused {shape} x{count}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms", flush=True)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("t_bytes", t_bytes), ("t_ops", t_ops)):
            entry[k] += count * v
    return entry


def check_conv(conv_shapes, detail):
    g = torch.Generator(device="cuda").manual_seed(1)
    entry = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0, library_ms=0.0,
                 max_abs_err=0.0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for xs, ws in conv_shapes:
            x = torch.randn(xs, generator=g, device="cuda")
            w = torch.randn(ws, generator=g, device="cuda") * (2.0 / (ws[3] * ws[0] * ws[1] * ws[2])) ** 0.5
            y = cf.conv3d_flat_cuda(x, w)
            ref = cf.conv3d_flat_plain(x, w)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            check(err <= 1e-4 * scale and torch.isfinite(y).all().item(),
                  f"conv kernel x{xs} w{ws}: max|err| {err} > 1e-4 * {scale}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            lib_err = (F.conv3d(x, wt, padding="same") - ref).abs().max().item()
            ms = time_ms(lambda: cf.conv3d_flat_cuda(x, w))
            plain_ms = time_ms(lambda: cf.conv3d_flat_plain(x, w))
            library_ms = time_ms(lambda: F.conv3d(x, wt, padding="same"))
            n, c = xs[:2]
            f = ws[-1]
            vox = x[0, 0].numel()
            taps = ws[0] * ws[1] * ws[2]
            b_ms, t_bytes, t_ops = bound((n * c * vox + taps * c * f + n * f * vox) * 4,
                                         2 * n * f * c * taps * vox)
            detail.append(dict(kernel="conv3d_flat", x=list(xs), w=list(ws), ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                               max_abs_err=err, library_max_abs_err=lib_err))
            print(f"conv x{xs} w{ws}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.conv3d {library_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({'ops' if t_ops > t_bytes else 'bytes'}), err {err:.3g} of {scale:.3g}",
                  flush=True)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bound_ms", b_ms), ("t_bytes", t_bytes), ("t_ops", t_ops)):
                entry[k] += v
    return entry


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"POST {body} -> {r.status}")
        return r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def serve_engine(model_path, cfg, engine):
    """Serve the checkpoint under `engine`; returns ({seed: volumes}, timings, launches)."""
    service = GeneratorService.from_checkpoint("pgan", model_path, cfg=cfg, phase=PHASE,
                                               batch_size=BATCH, device="cuda",
                                               conv_engine=engine)
    srv = make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        t0 = time.perf_counter()
        service.warmup()  # compiles the Triton kernel on first use
        warm_s = time.perf_counter() - t0
        check(_get(url + "/healthz")["status"] == "ok", "healthz")
        info = _get(url + "/info")
        check(info["conv_engine"] == engine and info["volume_shape"] == [1, 32, 128, 128],
              f"info {info}")
        batches0 = service.stats["batches"]

        # the main path: counts set to 0 just before, read just after
        zero_counts()
        results, errors = {}, []

        def client(num, seed):
            try:
                results[seed] = _post(url + "/generate", {"num_samples": num, "seed": seed})
            except Exception as e:  # noqa: BLE001 (reported by the check below)
                errors.append(f"seed {seed}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=r) for r in REQUESTS]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads), f"requests: {errors}")
        launches = {"fused": fba.fused_bias_act_pixelnorm.launches,
                    "conv": cf.conv3d_flat_cuda.launches,
                    "plain": fba.bias_act_pixelnorm_plain.calls + cf.conv3d_flat_plain.calls}
        stats = _get(url + "/stats")
        dispatches = stats["batches"] - batches0

        vols = {}
        for num, seed in REQUESTS:
            v = np.load(io.BytesIO(results[seed]))
            check(v.shape == (num, 1, 32, 128, 128) and v.dtype == np.float32,
                  f"seed {seed}: shape {v.shape} dtype {v.dtype}")
            check(np.isfinite(v).all(), f"seed {seed}: non-finite volumes")
            vols[seed] = v
        check(stats["max_requests_coalesced"] >= 2, f"no coalescing: {stats}")
        check(dispatches >= 3, f"{dispatches} dispatches for {sum(n for n, _ in REQUESTS)} samples")
        check(launches["fused"] == 11 * dispatches,
              f"{launches['fused']} fused launches for {dispatches} dispatches")
        check(launches["conv"] == (6 if engine == "flat" else 0) * dispatches,
              f"{launches['conv']} conv launches for {dispatches} dispatches ({engine})")
        check(launches["plain"] == 0, f"{launches['plain']} plain-version calls on the card")

        # the same requests served alone are bit-equal to their coalesced responses
        for num, seed in REQUESTS:
            alone = np.load(io.BytesIO(_post(url + "/generate", {"num_samples": num, "seed": seed})))
            check(np.array_equal(alone, vols[seed]),
                  f"{engine}: seed {seed} served alone differs from its coalesced response "
                  f"by {np.abs(alone - vols[seed]).max()}")

        # steady state: device time of one batch-8 forward, and of a served dispatch
        g_params, _ = _load_generator_params(model_path, True, "cuda")
        sampler = make_keyed_sampler(cfg, PHASE, BATCH, device="cuda", conv_engine=engine)
        seeds = np.arange(BATCH, dtype=np.int32)
        forward_ms = time_ms(lambda: sampler(g_params, seeds, seeds))
        dispatch_ms = _get(url + "/stats")["bucket_ms"][str(BATCH)]
        timing = dict(forward_ms=forward_ms, dispatch_ms=dispatch_ms, warmup_s=warm_s,
                      burst_s=burst_s, dispatches=dispatches,
                      max_requests_coalesced=stats["max_requests_coalesced"],
                      padded_slots=stats["padded_slots"])
        print(f"serve[{engine}]: {dispatches} dispatches for {len(REQUESTS)} concurrent requests, "
              f"launches {launches}, forward {forward_ms:.3f} ms/batch-8 (CUDA events), "
              f"served dispatch {dispatch_ms} ms (host clock, incl. fetch), "
              f"burst {burst_s:.3f} s", flush=True)
        return vols, timing, launches
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()
        thread.join(timeout=30)


def zero_counts():
    """Every launch and plain-call count to 0."""
    cf.conv3d_flat_cuda.launches = 0
    cf.conv3d_flat_cuda.by_shape.clear()
    cf.conv3d_flat_wgrad_cuda.launches = 0
    cf.conv3d_flat_wgrad_cuda.by_shape.clear()
    fba.fused_bias_act_pixelnorm.launches = 0
    cf.conv3d_flat_plain.calls = 0
    cf.conv3d_flat_wgrad_plain.calls = 0
    fba.bias_act_pixelnorm_plain.calls = 0


def read_counts():
    by_role = Counter()
    for (role, *_), n in cf.conv3d_flat_cuda.by_shape.items():
        by_role[role] += n
    return dict(forward=by_role["forward"], dgrad=by_role["dgrad"],
                wgrad=cf.conv3d_flat_wgrad_cuda.launches,
                fused=fba.fused_bias_act_pixelnorm.launches,
                plain=(cf.conv3d_flat_plain.calls + cf.conv3d_flat_wgrad_plain.calls
                       + fba.bias_act_pixelnorm_plain.calls))


def _moved(a, b):
    return any(not torch.equal(a[k], b[k]) for k in a)


def train_engine(cfg, engine, state0, opts, real):
    """The flagship step under `engine` from `state0`, both halves.  Returns (timing
    rows, per-step launches, per-shape launch counts of the timed steps)."""
    arch = get_architecture("pgan")
    rng = torch.Generator(device="cuda").manual_seed(1)
    state, rows, launches = state0, {}, {}
    conv_shapes, wgrad_shapes = Counter(), Counter()
    for half, static_alpha, alpha in HALVES:
        step = make_train_step(arch, cfg, PHASE, *opts, static_alpha=static_alpha,
                               conv_engine=engine)
        zero_counts()
        state, _, _ = run_steps(step, state, real, rng, alpha, 1)  # warm-up
        warm = read_counts()
        # the main path: counts set to 0 just before, read just after
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        state, ms, metrics = run_steps(step, state, real, rng, alpha, TRAIN_STEPS)
        counts = read_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        conv_shapes.update(cf.conv3d_flat_cuda.by_shape)
        wgrad_shapes.update(cf.conv3d_flat_wgrad_cuda.by_shape)
        losses = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
        check(all(math.isfinite(v) for row in losses for v in row),
              f"train[{engine}] {half}: non-finite losses {losses}")
        check(counts["plain"] == 0, f"train[{engine}] {half}: {counts['plain']} plain-version "
                                    f"calls on the card")
        for k in ("forward", "dgrad", "wgrad", "fused"):
            check(counts[k] == TRAIN_STEPS * warm[k],
                  f"train[{engine}] {half}: {counts[k]} {k} launches in {TRAIN_STEPS} steps, "
                  f"{warm[k]} in the warm-up step")
        if engine == "flat":
            check(min(warm[k] for k in ("forward", "dgrad", "wgrad", "fused")) > 0,
                  f"train[flat] {half}: a kernel was not launched: {warm}")
        else:
            check(warm["forward"] == warm["dgrad"] == warm["wgrad"] == 0 and warm["fused"] > 0,
                  f"train[direct] {half}: launches {warm}")
        rows[half] = dict(step_ms=statistics.median(ms), step_ms_all=ms, peak_mib=peak_mib,
                          losses=losses)
        launches[half] = dict(per_step={k: warm[k] for k in ("forward", "dgrad", "wgrad", "fused")},
                              total=counts)
        print(f"train[{engine}] {half}: {statistics.median(ms):.2f} ms/step (median of "
              f"{TRAIN_STEPS}, CUDA events; all {[round(v, 2) for v in ms]}), peak "
              f"{peak_mib:.0f} MiB, launches per step {launches[half]['per_step']}, "
              f"losses {losses[-1]}", flush=True)
    for part in ("g_params", "d_params", "ema"):
        check(_moved(getattr(state, part), getattr(state0, part)),
              f"train[{engine}]: {part} did not move")
    return rows, launches, (conv_shapes, wgrad_shapes)


def _conv_bound(n, c, f, taps, vox, dtype):
    esize = 2 if dtype == torch.bfloat16 else 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    # x and w (or dy) read once, y (or dw) written once
    return bound((n * c * vox + taps * c * f + n * f * vox) * esize, 2 * n * f * c * taps * vox,
                 peak)


def _add(entry, weight, t):
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops"):
        entry[k] += weight * t[k]
    entry["launches_per_step"] += weight
    entry["max_abs_err"] = max(entry["max_abs_err"], t["err"])
    entry["max_rel_err"] = max(entry["max_rel_err"], t["err"] / max(t["scale"], 1e-30))


def check_train_convs(conv_shapes, wgrad_shapes, steps, detail):
    """Forward/dgrad and wgrad kernels at every (shape, role) the train step launched, in
    f32 and bf16.  Returns {(kind, dtype name): summed per-step entry}; each shape's
    numbers count as often as one step launches it."""
    g = torch.Generator(device="cuda").manual_seed(2)
    dtypes = (torch.float32, torch.bfloat16)
    limits = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    entries, timed = {}, {}

    def entry(kind, dtype):
        return entries.setdefault((kind, str(dtype).split(".")[-1]), dict(
            ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0,
            max_abs_err=0.0, max_rel_err=0.0, launches_per_step=0.0))

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for (role, xs, ws, _), count in sorted(conv_shapes.items(), key=str):
            for dtype in dtypes:
                key = (xs, ws, dtype)
                if key not in timed:
                    x = torch.randn(xs, generator=g, device="cuda").to(dtype)
                    fan_in = ws[0] * ws[1] * ws[2] * ws[3]
                    w = torch.randn(ws, generator=g, device="cuda") * (2.0 / fan_in) ** 0.5
                    w = w.to(dtype)
                    y = cf.conv3d_flat_cuda(x, w, role)
                    ref = cf.conv3d_flat_plain(x, w)
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    check(err <= limits[dtype] * scale and torch.isfinite(y).all().item(),
                          f"conv {dtype} x{xs} w{ws}: max|err| {err} > {limits[dtype]} * {scale}")
                    wt = w.permute(4, 3, 0, 1, 2).contiguous()
                    n, c = xs[:2]
                    b_ms, t_bytes, t_ops = _conv_bound(n, c, ws[-1], ws[0] * ws[1] * ws[2],
                                                       math.prod(xs[2:]), dtype)
                    t = dict(ms=time_ms(lambda: cf.conv3d_flat_cuda(x, w, role), reps=5, warmup=1),
                             plain_ms=time_ms(lambda: cf.conv3d_flat_plain(x, w), reps=3, warmup=1),
                             library_ms=time_ms(lambda: F.conv3d(x, wt, padding="same"), reps=5,
                                                warmup=1),
                             bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops, err=err, scale=scale)
                    timed[key] = t
                    detail.append(dict(kernel="conv3d_flat", dtype=str(dtype), x=list(xs),
                                       w=list(ws), **t))
                    print(f"conv {str(dtype)[6:]} x{xs} w{ws}: kernel {t['ms']:.4f} ms, plain "
                          f"{t['plain_ms']:.4f}, F.conv3d {t['library_ms']:.4f}, bound "
                          f"{b_ms:.4f} ({'ops' if t_ops > t_bytes else 'bytes'}), err "
                          f"{err:.3g} of {scale:.3g}", flush=True)
                _add(entry(role, dtype), count / steps, timed[key])

        for (xs, dys, k, _), count in sorted(wgrad_shapes.items(), key=str):
            for dtype in dtypes:
                x = torch.randn(xs, generator=g, device="cuda").to(dtype)
                dy = torch.randn(dys, generator=g, device="cuda").to(dtype)
                dw = cf.conv3d_flat_wgrad_cuda(x, dy, k)
                again = cf.conv3d_flat_wgrad_cuda(x, dy, k)
                ref = cf.conv3d_flat_wgrad_plain(x, dy, k)
                w0 = torch.zeros((dys[1], xs[1], *k), dtype=dtype, device="cuda")
                pad = [kk // 2 for kk in k]

                def library():
                    return torch.ops.aten.convolution_backward(
                        dy, x, w0, None, [1, 1, 1], pad, [1, 1, 1], False, [0, 0, 0], 1,
                        [False, True, False])[1]

                lib_dw = library().permute(2, 3, 4, 1, 0).float()
                lib_err = (lib_dw - ref.float()).abs().max().item()
                torch.cuda.synchronize()
                check(torch.equal(dw, again), f"wgrad {dtype} x{xs} dy{dys}: two runs differ")
                err = (dw.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                check(err <= limits[dtype] * scale and torch.isfinite(dw).all().item(),
                      f"wgrad {dtype} x{xs} dy{dys}: max|err| {err} > {limits[dtype]} * {scale}")
                n, c = xs[:2]
                b_ms, t_bytes, t_ops = _conv_bound(n, c, dys[1], math.prod(k), math.prod(xs[2:]),
                                                   dtype)
                t = dict(ms=time_ms(lambda: cf.conv3d_flat_wgrad_cuda(x, dy, k), reps=5, warmup=1),
                         plain_ms=time_ms(lambda: cf.conv3d_flat_wgrad_plain(x, dy, k), reps=3,
                                          warmup=1),
                         library_ms=time_ms(library, reps=5, warmup=1),
                         bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops, err=err, scale=scale)
                detail.append(dict(kernel="conv3d_wgrad", dtype=str(dtype), x=list(xs),
                                   dy=list(dys), kernel_size=list(k),
                                   library_max_abs_err=lib_err, **t))
                print(f"wgrad {str(dtype)[6:]} x{xs} dy{dys} k{k}: kernel {t['ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f}, convolution_backward {t['library_ms']:.4f}, bound "
                      f"{b_ms:.4f} ({'ops' if t_ops > t_bytes else 'bytes'}), err {err:.3g} of "
                      f"{scale:.3g} (library {lib_err:.3g}), bit-identical rerun", flush=True)
                _add(entry("wgrad", dtype), count / steps, t)
    return entries


def check_train_fused(fused_shapes, detail):
    """The fused op in bf16 (the train step's dtype) against its plain version, and its
    autograd.Function's backward against autograd of the plain version in f32."""
    g = torch.Generator(device="cuda").manual_seed(3)
    entry = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0, backward_ms=0.0,
                 plain_backward_ms=0.0, max_abs_err=0.0, backward_max_abs_err=0.0)
    for shape, count in Counter(fused_shapes).items():
        x32 = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(shape[1], generator=g, device="cuda")
        gy = torch.randn(shape, generator=g, device="cuda")
        x = x32.bfloat16()
        y = fba.fused_bias_act_pixelnorm(x, b, 0.2, True)
        ref = fba.bias_act_pixelnorm_plain(x, b, 0.2, True)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        check(err <= 1e-2 * ref.float().abs().max().item() and torch.isfinite(y).all().item(),
              f"fused bf16 {shape}: max|err| {err}")
        xg, bg = x32.clone().requires_grad_(True), b.clone().requires_grad_(True)
        yk = fba.bias_act_pixelnorm(xg, bg)
        yp = fba.bias_act_pixelnorm_plain(xg, bg, 0.2, True)
        ours = torch.autograd.grad(yk, (xg, bg), gy, retain_graph=True)
        theirs = torch.autograd.grad(yp, (xg, bg), gy, retain_graph=True)
        bwd_err = 0.0
        for a, r in zip(ours, theirs):
            excess = ((a - r).abs() - (1e-6 + 1e-5 * r.abs())).max().item()
            check(excess <= 0, f"fused backward {shape}: tolerance exceeded by {excess}")
            bwd_err = max(bwd_err, (a - r).abs().max().item())
        xb = x.clone().requires_grad_(True)
        yb = fba.bias_act_pixelnorm(xb, b)
        gyb = gy.bfloat16()
        t = dict(ms=time_ms(lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True)),
                 plain_ms=time_ms(lambda: fba.bias_act_pixelnorm_plain(x, b, 0.2, True)),
                 backward_ms=time_ms(lambda: torch.autograd.grad(yb, xb, gyb, retain_graph=True)),
                 plain_backward_ms=time_ms(lambda: torch.autograd.grad(yp, (xg, bg), gy,
                                                                       retain_graph=True)))
        n, c = shape[:2]
        s = math.prod(shape[2:])
        b_ms, t_bytes, t_ops = bound((2 * n * c * s) * 2 + c * 4, 6 * n * c * s + 2 * n * s,
                                     BF16_FLOPS)
        t.update(bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops)
        detail.append(dict(kernel="fused_bias_act_pixelnorm", dtype="bfloat16", shape=list(shape),
                           calls=count, max_abs_err=err, backward_max_abs_err=bwd_err, **t))
        print(f"fused bf16 {shape} x{count}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
              f"backward {t['backward_ms']:.4f} (plain autograd f32 {t['plain_backward_ms']:.4f}), "
              f"bound {b_ms:.4f}, err {err:.3g}, backward err {bwd_err:.3g}", flush=True)
        for k, v in t.items():
            entry[k] += count * v
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["backward_max_abs_err"] = max(entry["backward_max_abs_err"], bwd_err)
    return entry


def compare_engines_f32(state0, real):
    """One f32 gradient computation of the step under each engine, from one state and
    one set of pre-drawn z and gamma."""
    cfg = bench_train_config(PHASE, BATCH, compute_dtype="float32")
    arch = get_architecture("pgan")
    draws = losses.draw_inputs(torch.Generator(device="cuda").manual_seed(4), BATCH,
                               cfg.latent_dim, real.shape[1:], torch.float32, "cuda")
    res = {}
    for engine in ("flat", "direct"):
        zero_counts()
        grads_fn = make_grads_fn(arch, cfg, PHASE, static_alpha=None, conv_engine=engine)
        (gg, dg), out = grads_fn(state0.g_params, state0.d_params, real, draws, 0.5)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts["plain"] == 0, f"f32 step [{engine}]: plain versions ran")
        convs = counts["forward"] + counts["dgrad"] + counts["wgrad"]
        check(convs > 0 if engine == "flat" else convs == 0, f"f32 step [{engine}]: {counts}")
        res[engine] = ({**gg, **dg}, out)
    (ga, oa), (gb, ob) = res["flat"], res["direct"]
    loss_rel = {}
    for name in ("gen_loss", "disc_loss", "gp_loss"):
        a, b = getattr(oa, name).item(), getattr(ob, name).item()
        loss_rel[name] = abs(a - b) / max(abs(b), 1e-30)
        check(abs(a - b) <= 1e-3 * abs(b) + 1e-6, f"f32 {name}: flat {a} vs direct {b}")
    worst = (0.0, None)
    for k, b in gb.items():
        scale = b.abs().max().item()
        err = (ga[k] - b).abs().max().item()
        check(err <= 1e-3 * scale, f"f32 gradient {k}: max|flat - direct| {err} > 1e-3 * {scale}")
        if scale > 0:
            worst = max(worst, (err / scale, k))
    print(f"f32 step flat vs direct: loss rel diffs {loss_rel}, worst gradient "
          f"max|diff|/max|g| {worst[0]:.3g} ({worst[1]}) over {len(gb)} tensors", flush=True)
    return dict(loss_rel=loss_rel, worst_grad_rel=worst[0], worst_grad=worst[1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1


    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report) or 'cached libraries'}",
          flush=True)
    for name, r in report.items():
        print(f"  {name}: {r['seconds']:.1f} s\n{r['log']}", flush=True)

    cfg = Config(**BENCH_CFG, starting_phase=PHASE, ending_phase=PHASE).finalize()
    fused_shapes, conv_shapes = serving_shapes(cfg, PHASE, BATCH)
    check(len(fused_shapes) == 11 and len(conv_shapes) == 6, "phase-6 serving shapes")
    detail = []
    fused = check_fused(fused_shapes, detail)
    conv = check_conv(conv_shapes, detail)

    params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=PHASE,
                                           cfg=cfg, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        model = ckpt.save_params(str(Path(tmp) / f"model_{PHASE}"), params, ema=params)
        served = {engine: serve_engine(model, cfg, engine) for engine in ("direct", "flat")}
    for num, seed in REQUESTS:
        a, b = served["direct"][0][seed], served["flat"][0][seed]
        diff = np.abs(a - b).max()
        check(diff <= 1e-4 * np.abs(a).max(), f"engines disagree on seed {seed}: {diff}")
    print(f"direct vs flat: max|diff| {max(np.abs(served['direct'][0][s] - served['flat'][0][s]).max() for _, s in REQUESTS):.3g}",
          flush=True)

    # training: the flagship step under both engines from one initial state

    tcfg = bench_train_config(PHASE, BATCH)
    state0, opts = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                    phase=PHASE, cfg=tcfg, device="cuda")
    real = real_batch(tcfg, PHASE, BATCH, "cuda")
    trained = {engine: train_engine(tcfg, engine, state0, opts, real)
               for engine in ("flat", "direct")}
    conv_shapes, wgrad_shapes = trained["flat"][2]
    train_steps = TRAIN_STEPS * 2  # both halves
    train_convs = check_train_convs(conv_shapes, wgrad_shapes, train_steps, detail)
    train_fused = check_train_fused(fused_shapes, detail)
    engines_f32 = compare_engines_f32(state0, real)

    main_launches = served["flat"][2]
    dispatches = served["flat"][1]["dispatches"]
    flat_runs = trained["flat"][1]
    train_launches = {k: sum(flat_runs[h]["total"][k] for h in flat_runs)
                      for k in ("forward", "dgrad", "wgrad", "fused")}
    per = (f"one phase-6 batch-8 f32 serving forward (sum over its launches); launches "
           f"counted over {dispatches} dispatches")
    per_step = (f"one phase-6 batch-8 bf16 train step under flat (sum over its launches); "
                f"launches counted over {train_steps} steps")
    kernels = []
    for name, route, source, replaces, e, launches, library, per_what in (
            ("fused_bias_act_pixelnorm", "triton", "saragan_tpu_torch/ops/fused_bias_act.py",
             "saragan_tpu/ops/pallas_kernels.py:112", fused, main_launches["fused"], None, per),
            ("conv3d_flat", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/pallas_conv.py:124", conv, main_launches["conv"], "library_ms", per),
            ("fused_bias_act_pixelnorm[train,bf16,with backward]", "triton",
             "saragan_tpu_torch/ops/fused_bias_act.py", "saragan_tpu/ops/pallas_kernels.py:112",
             train_fused, train_launches["fused"], None, per_step),
            ("conv3d_flat[forward,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/pallas_conv.py:124", train_convs[("forward", "bfloat16")],
             train_launches["forward"], "library_ms", per_step),
            ("conv3d_flat[dgrad,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/core.py:386", train_convs[("dgrad", "bfloat16")],
             train_launches["dgrad"], "library_ms", per_step),
            ("conv3d_wgrad[bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad.cu",
             "saragan_tpu/ops/pallas_conv.py:183", train_convs[("wgrad", "bfloat16")],
             train_launches["wgrad"], "library_ms", per_step)):
        check(launches > 0, f"{name}: not launched on its main path")
        unit = dispatches if per_what == per else train_steps
        k = dict(name=name, route=route, source=source, replaces=replaces, launches=launches,
                 launches_per_unit=launches / unit,
                 max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
                 bound_ms=e["bound_ms"],
                 bound_by="operations" if e["t_ops"] > e["t_bytes"] else "bytes",
                 library_ms=e[library] if library else None, per=per_what)
        if "backward_ms" in e:
            k["backward_ms"] = e["backward_ms"]
        kernels.append(k)
    f32_train = {f"{kind}[f32]": {x: e[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "max_abs_err", "launches_per_step")}
                 for (kind, dt), e in train_convs.items() if dt == "float32"}
    training = {e: dict(timing=trained[e][0], launches=trained[e][1]) for e in trained}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, shapes=detail, f32_train_kernels=f32_train,
        serving={e: served[e][1] for e in served}, training=training,
        engines_f32=engines_f32), indent=1))
    print(f"serving: " + json.dumps({e: served[e][1] for e in served}), flush=True)
    print("training: " + json.dumps({e: {h: dict(step_ms=r["step_ms"], peak_mib=r["peak_mib"])
                                         for h, r in trained[e][0].items()} for e in trained}),
          flush=True)
    print("f32 training-shape kernels: " + json.dumps(f32_train), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
