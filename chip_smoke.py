#!/usr/bin/env python3
"""Drive the PyTorch port (saragan_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA device -> exit 1 before anything else;
2. build: nvcc compiles every CUDA source of the port (one process per source, all
   started together) and the build time is printed, with the registers and spills ptxas
   reports for each conv kernel and each fused bias+lrelu+pixel-norm kernel, and the count
   of tensor-core (HMMA) instructions in each bf16 conv library's SASS (cuobjdump), which
   must not be 0;
3. kernels against their plain PyTorch versions, on the card, at every shape the
   phase-6 batch-8 serving forward gives them (TF32 off):
   - fused bias+lrelu+pixel-norm (CUDA C++, csrc/fused_bias_act.cu): rtol 1e-5, atol
     1e-6, pixel norm on and off; a sample computed alone bit-equal to its slot in the
     batch of 8; timed three ways (``tools/profile_fused.time_three_ways``: per-call
     events, device time of calls queued behind a sleep, host enqueue time);
   - conv3d forward (CUDA C++, CUDA cores): max|kernel - plain| <= 1e-4 * max|plain|,
     bit-identical on a rerun, with its plan, TFLOP/s and share of the bound;
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
   forward, dgrad, wgrad and fused kernels as often as its warm-up step did, every conv
   through the tensor-core route ("tc", bf16) and none through the CUDA-core one ("simt"),
   and no plain version runs; under `direct` no conv kernel runs; under both the fused
   op's backward kernel runs once per forward launch (11 per step); under `flat` one
   more step per half is profiled for its kernel count and the host's launch calls;
6. training kernels against their plain versions, on the card, at every shape that
   step launched them with, in f32 (CUDA cores) and bf16 (tensor cores): max|kernel -
   plain| <= 1e-4 (f32) or 1e-2 (bf16) * max|plain|; forward, dgrad and wgrad
   bit-identical across two runs; each with its time, its plain version's, the library
   call's (``F.conv3d`` for forward and dgrad, ``aten.convolution_backward`` with only the
   weight mask for wgrad) and its bound, with its TFLOP/s and share of the bound; the
   fused op's backward kernel in f32 and bf16 against its plain version and against
   autograd of the reference's oracle (the backward it replaces): f32 gx within 1e-6 +
   1e-5 * max(|gx|, |r g| + |a r^3 s / C|) (gx is the difference of those two terms, so
   its rounding error scales with them), gb within rtol 1e-5 plus 1e-5 * ||gx_c||_2 (a
   sum of N * S terms: a
   reordered f32 sum differs by a multiple of that, not of |gb_c|); bf16 within 1e-2 *
   max|reference|; gx and gb bit-identical on a rerun; y (bf16) and gx (f32 and bf16) of
   a sample computed alone bit-equal to its slot in the batch of 8; one launch per
   backward call (torch.profiler); the forward's and the backward's three times
   (``time_three_ways``), the plain version's, the oracle's autograd's, the
   autograd.Function's backward and the bound;
7. one f32 step's gradients under `flat` and `direct` from the same state and the same
   pre-drawn z and gamma: losses within 1e-3 relative, every gradient within
   1e-3 * max|g|; under `flat` every conv (forward, dgrad, wgrad) through the CUDA-core
   kernels; then the f32 gradient computation under `flat` timed (median of 5 after a
   warm-up, CUDA events) on a line of its own;
8. the trainer through its CLI (``cli.main`` in process): the flagship configuration
   from phase 5 (batch 16) into phase 6 (batch 8), 32 + 32 images per phase, no
   --conv_engine (so `flat`, the card's default: events.jsonl must say so), bf16, the
   fused op on, on a seeded npy dataset written to a temp dir (16 volumes of 16x64x64 and
   16 of 32x128x128), with the metric passes (--calc_metrics, FID over random features,
   SWD, SSIM, PSNR; once per phase and at each phase's end).  It must exit normally and
   write model_5.npz and model_6.npz; phase 6 must hold every phase-5 name of model_5.npz
   bit for bit through its frozen mixing half (its cadence checkpoint after that half);
   events.jsonl must hold finite Loss/d_loss, Loss/g_loss and Loss/gp in both phases, a
   histogram event, and finite fid, fid_EMA, PSNR, ssim, swd_mean and their end-of-phase
   _validation / _test tags in both phases; kernels #1 (forward and dgrad), #2 and #4 (and
   its backward) must have run, the convs through the tensor-core route only, and no plain
   version.  Prints ms/step per phase and half (CUDA events, median after the first),
   img/s, the phase's peak memory, and the ms per step without the metric passes and
   with their host time spread over the steps;
9. bitwise resume: the same command in a subprocess with --full_state_checkpoints gets
   a SIGTERM once phase 6 printed its second step line and must exit 75; rerun with
   --auto_resume it must exit 0 with a model_6.npz equal to the uninterrupted run's,
   every array bit for bit;
9b. metrics (the slice's own path, counts set to 0 before it): ``generate()``'s report
   at phase 6 for 8 volumes of 32x128x128 from the serving generator, every metric on,
   FID over random features (the --allow_uncalibrated_fid route), then FID over the
   Inception network with random parameters from an npz: values finite, FID(real, real)
   at most 1e-2 of FID(real, fake), the fused kernel and no plain version run; Inception
   features of 8 slices on the card within 1e-3 * max|CPU| of the CPU's; seconds of
   extraction (card) against the numpy/scipy arithmetic (host);
10. kernel #3 (conv3d_flat_v2, CUDA C++, standalone as in the reference) at every
   serving-forward shape in f32 (CUDA cores) and every forward and dgrad shape of the bf16
   train step (tensor cores): max|kernel - plain| <= 1e-4 (f32) or 1e-2 (bf16) *
   max|plain|, within the same limit of kernel #1, bit-identical on a rerun, through the
   route of its dtype; with its plan, its time, kernel #1's, F.conv3d's, the bound, its
   TFLOP/s and share of the bound;
11. kernel #5 (minibatch_stddev_stat, CUDA C++, csrc/minibatch_stddev.cu, standalone)
   with group 4 at N 8 and 16, at the per-sample feature counts of the largest and
   smallest phase-6 D activation, f32 and bf16 input, and group 3 (not a template size)
   at N 12: within 1e-5 of max|plain|, bit-identical on a rerun, one launch per call
   (counted, and one launch call in a torch.profiler trace); timed three ways
   (``time_three_ways``) with its bound (bytes / 3.35 TB/s);
12. one JSON line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Each phase prints its seconds.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import re
import signal
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

from saragan_tpu_torch import cli, losses
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import _build
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.ops import minibatch_stddev as mb
from saragan_tpu_torch.data import get_numpy_dataset, stdnormal_to_8bit_numpy
from saragan_tpu_torch.metrics import fid as mfid
from saragan_tpu_torch.metrics import inception as minc
from saragan_tpu_torch.metrics import skim, swd
from saragan_tpu_torch.tools.generate import (_load_generator_params, generate,
                                              make_keyed_sampler)
from saragan_tpu_torch.tools.profile_fused import kernel_label as fused_label
from saragan_tpu_torch.tools.profile_fused import time_three_ways
from saragan_tpu_torch.tools.profile_mbstd import mbstd_inputs
from saragan_tpu_torch.tools.profile_serving import BENCH_CFG, time_ms
from saragan_tpu_torch.tools.profile_training import (HALVES, bench_train_config,
                                                       launch_counts, profile_one_step,
                                                       real_batch, run_steps)
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
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# the trainer through its CLI: the flagship configuration (bench.py:99-119) from phase 5
# (batch 16) into phase 6 (batch 8), 32 + 32 images per phase
TRAINER_ARGS = [
    "pgan", "<data>", "--start_shape", "(1, 1, 4, 4)", "--final_shape", "(1, 128, 512, 512)",
    "--starting_phase", "5", "--ending_phase", "6", "--latent_dim", "256",
    "--network_size", "xs", "--base_batch_size", "256", "--mixing_nimg", "32",
    "--stabilizing_nimg", "32", "--loss_fn", "wgan", "--gp_weight", "10",
    "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "1e-3", "--adam_beta1", "0",
    "--adam_beta2", "0.9", "--compute_dtype", "bfloat16", "--use_pallas_fusion",
    "--summary_small_every_nsteps", "16",
    "--summary_large_every_nsteps", "32", "--checkpoint_every_nsteps", "32"]
PHASE6_START = 64  # global image count at which phase 6 begins (32 + 32 at phase 5)
# the in-process trainer run (not the resume pair) also runs the metric passes: FID over
# random features, SWD, SSIM and PSNR, once per phase (every 64 images) and at each
# phase's end on the validation and test splits
METRIC_ARGS = ["--calc_metrics", "--compute_FID", "--allow_uncalibrated_fid", "--compute_swds",
               "--compute_ssims", "--compute_psnrs", "--metrics_every_nsteps", "64"]
METRIC_TAGS = ("fid", "fid_EMA", "PSNR", "ssim", "swd_mean", "fid_validation",
               "PSNR_validation", "ssim_validation", "swd_mean_validation", "fid_test")
FUSED_SOURCE = "saragan_tpu_torch/csrc/fused_bias_act.cu"
MBSTD_SOURCE = "saragan_tpu_torch/csrc/minibatch_stddev.cu"
STANDALONE_3 = "standalone: no path of the JAX package runs it (saragan_tpu/ops/core.py:553)"
STANDALONE_5 = ("standalone: no path of the JAX package runs it (the D's minibatch_stddev_layer "
                "is plain jnp, saragan_tpu/ops/pallas_kernels.py:163-168)")


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


def _alone_equals_slot(fn, *batch, slot=5):
    """`fn` of sample `slot` computed alone is bit-equal to its slot of `fn` on the batch,
    for every tensor output that has a batch dimension."""
    full = fn(*batch)
    alone = fn(*(t[slot:slot + 1].contiguous() if t.ndim > 1 else t for t in batch))
    full, alone = (full, alone) if isinstance(full, tuple) else ((full,), (alone,))
    return all(torch.equal(a, f[slot:slot + 1]) for a, f in zip(alone, full) if f.ndim > 1)


def check_fused(fused_shapes, detail):
    g = torch.Generator(device="cuda").manual_seed(0)
    entry = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                 t_ops=0.0, max_abs_err=0.0)
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
            check(_alone_equals_slot(lambda xx, bb: fba.fused_bias_act_pixelnorm(
                xx, bb, 0.2, pixelnorm), x, b),
                f"fused kernel {shape} pixelnorm={pixelnorm}: a sample alone differs from its "
                f"slot in the batch")
        t = time_three_ways(lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True))
        plain_ms = time_ms(lambda: fba.bias_act_pixelnorm_plain(x, b, 0.2, True))
        n, c = shape[:2]
        s = x[0, 0].numel()
        # per element: bias add, select, slope multiply, square, sum, scale; per voxel
        # the mean and rsqrt.  One read of x and b, one write of y.
        b_ms, t_bytes, t_ops = bound((2 * n * c * s + c) * 4, 6 * n * c * s + 2 * n * s)
        detail.append(dict(kernel="fused_bias_act_pixelnorm", shape=list(shape), calls=count,
                           ms=t["ms"], device_ms=t["device_ms"], host_us=t["host_us"],
                           queued_ahead=t["queued_ahead"], plain_ms=plain_ms, bound_ms=b_ms))
        print(f"fused {shape} x{count}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, "
              f"host {t['host_us']:.1f} us), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms, "
              f"alone = its slot", flush=True)
        for k, v in (("ms", t["ms"]), ("device_ms", t["device_ms"]), ("host_us", t["host_us"]),
                     ("plain_ms", plain_ms), ("bound_ms", b_ms), ("t_bytes", t_bytes),
                     ("t_ops", t_ops)):
            entry[k] += count * v
    return entry


def check_conv(conv_shapes, detail):
    g = torch.Generator(device="cuda").manual_seed(1)
    entry = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0, library_ms=0.0,
                 t_flop=0.0, max_abs_err=0.0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for xs, ws in conv_shapes:
            x = torch.randn(xs, generator=g, device="cuda")
            w = torch.randn(ws, generator=g, device="cuda") * (2.0 / (ws[3] * ws[0] * ws[1] * ws[2])) ** 0.5
            y = cf.conv3d_flat_cuda(x, w)
            again = cf.conv3d_flat_cuda(x, w)
            ref = cf.conv3d_flat_plain(x, w)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"conv kernel x{xs} w{ws}: two runs differ")
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            check(err <= 1e-4 * scale and torch.isfinite(y).all().item(),
                  f"conv kernel x{xs} w{ws}: max|err| {err} > 1e-4 * {scale}")
            plan = cf.conv_simt_plan(xs, ws)
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
            flop = 2 * n * f * c * taps * vox
            b_ms, t_bytes, t_ops = bound((n * c * vox + taps * c * f + n * f * vox) * 4, flop)
            plan_s = (f"box {plan.box}, cc {plan.cc}, ft {plan.ft}, tile {plan.vpt}x{plan.fpt}, "
                      f"{plan.threads} threads")
            detail.append(dict(kernel="conv3d_flat", route="simt", x=list(xs), w=list(ws), ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                               max_abs_err=err, library_max_abs_err=lib_err, plan=plan_s,
                               tflops=flop / ms / 1e9, share_of_bound=b_ms / ms))
            print(f"conv x{xs} w{ws}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.conv3d {library_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({'ops' if t_ops > t_bytes else 'bytes'}), {flop / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * b_ms / ms:.1f} % of bound, err {err:.3g} of {scale:.3g}, "
                  f"bit-identical rerun; plan {plan_s}", flush=True)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bound_ms", b_ms), ("t_bytes", t_bytes), ("t_ops", t_ops),
                         ("t_flop", flop)):
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
        service.warmup()  # loads the kernels' libraries on first use
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
                    "conv_tc": cf.launches_by_route(cf.conv3d_flat_cuda)["tc"],
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
        check(launches["conv_tc"] == 0, f"f32 serving: {launches['conv_tc']} tensor-core launches")

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


def _kernel_label(mangled):
    """A ptxas entry name shortened to the kernel and its template arguments."""
    if "fused_" in mangled:
        return fused_label(mangled)
    for name in ("conv3d_fwd_v2_tc_kernel", "conv3d_fwd_v2_kernel", "channels_last_kernel",
                 "conv3d_fwd_tc_kernel", "wgrad_tc_partial_kernel", "wgrad_tc_reduce_kernel",
                 "wgrad_partial_kernel", "wgrad_reduce_kernel", "conv3d_fwd_kernel"):
        if name in mangled:
            return f"{name}<{','.join(re.findall(r'Li(\d+)E', mangled.split(name, 1)[1]))}>"
    return mangled


def tensor_core_instructions():
    """{library: HMMA instructions in its SASS} for the bf16 conv libraries (cuobjdump,
    from nvcc's toolkit)."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for name in ("conv3d_fwd_tc", "conv3d_wgrad_tc", "conv3d_fwd_v2_tc"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = sum(1 for line in sass.splitlines() if "HMMA" in line)
    return counts


def zero_counts():
    """Every launch and plain-call count to 0."""
    for fn in (cf.conv3d_flat_cuda, cf.conv3d_flat_wgrad_cuda, cf.conv3d_flat_v2_cuda):
        fn.launches = 0
        fn.by_shape.clear()
    fba.fused_bias_act_pixelnorm.launches = 0
    fba.fused_bias_act_pixelnorm_grad.launches = 0
    mb.minibatch_stddev_stat_cuda.launches = 0
    for fn in (cf.conv3d_flat_plain, cf.conv3d_flat_wgrad_plain, cf.conv3d_flat_v2_plain,
               fba.bias_act_pixelnorm_plain, fba.bias_act_pixelnorm_grad_plain,
               mb.minibatch_stddev_stat_plain):
        fn.calls = 0


def read_counts():
    by_role = Counter()
    for (role, *_), n in cf.conv3d_flat_cuda.by_shape.items():
        by_role[role] += n
    conv_routes = cf.launches_by_route(cf.conv3d_flat_cuda)
    wgrad_routes = cf.launches_by_route(cf.conv3d_flat_wgrad_cuda)
    return dict(forward=by_role["forward"], dgrad=by_role["dgrad"],
                wgrad=cf.conv3d_flat_wgrad_cuda.launches,
                conv_tc=conv_routes["tc"], conv_simt=conv_routes["simt"],
                wgrad_tc=wgrad_routes["tc"], wgrad_simt=wgrad_routes["simt"],
                fused=fba.fused_bias_act_pixelnorm.launches,
                fused_grad=fba.fused_bias_act_pixelnorm_grad.launches,
                v2=cf.conv3d_flat_v2_cuda.launches,
                mbstd=mb.minibatch_stddev_stat_cuda.launches,
                plain=(cf.conv3d_flat_plain.calls + cf.conv3d_flat_wgrad_plain.calls
                       + fba.bias_act_pixelnorm_plain.calls
                       + fba.bias_act_pixelnorm_grad_plain.calls + cf.conv3d_flat_v2_plain.calls
                       + mb.minibatch_stddev_stat_plain.calls))


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
        profiled = None
        if engine == "flat":  # the kernels one more step runs and the host's launch calls
            state, prof = profile_one_step(step, state, real, rng, alpha)
            profiled = {k: prof[k] for k in ("kernels", "launch_calls", "device_ms",
                                             "profiled_step_ms")}
        losses = [[float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)] for m in metrics]
        check(all(math.isfinite(v) for row in losses for v in row),
              f"train[{engine}] {half}: non-finite losses {losses}")
        check(counts["plain"] == 0, f"train[{engine}] {half}: {counts['plain']} plain-version "
                                    f"calls on the card")
        for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad"):
            check(counts[k] == TRAIN_STEPS * warm[k],
                  f"train[{engine}] {half}: {counts[k]} {k} launches in {TRAIN_STEPS} steps, "
                  f"{warm[k]} in the warm-up step")
        # the fused op's backward: one kernel call for each forward launch, 11 per step
        check(warm["fused_grad"] == warm["fused"] == 11,
              f"train[{engine}] {half}: fused launches {warm['fused']}, backward "
              f"{warm['fused_grad']} per step")
        if engine == "flat":
            check(min(warm[k] for k in ("forward", "dgrad", "wgrad", "fused")) > 0,
                  f"train[flat] {half}: a kernel was not launched: {warm}")
            # bf16: every conv through the tensor-core kernels, none through the CUDA cores
            check(counts["conv_tc"] == counts["forward"] + counts["dgrad"]
                  and counts["wgrad_tc"] == counts["wgrad"]
                  and counts["conv_simt"] == counts["wgrad_simt"] == 0,
                  f"train[flat] {half}: routes {counts}")
        else:
            check(warm["forward"] == warm["dgrad"] == warm["wgrad"] == 0 and warm["fused"] > 0,
                  f"train[direct] {half}: launches {warm}")
        rows[half] = dict(step_ms=statistics.median(ms), step_ms_all=ms, peak_mib=peak_mib,
                          losses=losses, profiled=profiled)
        launches[half] = dict(per_step={k: warm[k] for k in (
            "forward", "dgrad", "wgrad", "fused", "fused_grad", "conv_tc", "conv_simt",
            "wgrad_tc", "wgrad_simt")}, total=counts)
        print(f"train[{engine}] {half}: {statistics.median(ms):.2f} ms/step (median of "
              f"{TRAIN_STEPS}, CUDA events; all {[round(v, 2) for v in ms]}), peak "
              f"{peak_mib:.0f} MiB, launches per step {launches[half]['per_step']}, "
              f"losses {losses[-1]}; profiled step {profiled}", flush=True)
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
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops", "t_flop"):
        entry[k] += weight * t[k]
    entry["launches_per_step"] += weight
    entry["max_abs_err"] = max(entry["max_abs_err"], t["err"])
    entry["max_rel_err"] = max(entry["max_rel_err"], t["err"] / max(t["scale"], 1e-30))


def _rate_line(t):
    return (f", {t['t_flop'] / t['ms'] / 1e9:.1f} TFLOP/s, {100 * t['bound_ms'] / t['ms']:.1f} % "
            f"of bound")


def check_train_convs(conv_shapes, wgrad_shapes, steps, detail):
    """Forward/dgrad and wgrad kernels at every (shape, role) the train step launched, in
    f32 (CUDA cores) and bf16 (tensor cores).  Returns {(kind, dtype
    name): summed per-step entry}; each shape's numbers count as often as one step
    launches it."""
    g = torch.Generator(device="cuda").manual_seed(2)
    dtypes = (torch.float32, torch.bfloat16)
    limits = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    entries, timed = {}, {}

    def entry(kind, dtype):
        return entries.setdefault((kind, str(dtype).split(".")[-1]), dict(
            ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0,
            t_flop=0.0, max_abs_err=0.0, max_rel_err=0.0, launches_per_step=0.0))

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
                    again = cf.conv3d_flat_cuda(x, w, role)
                    ref = cf.conv3d_flat_plain(x, w)
                    torch.cuda.synchronize()
                    check(torch.equal(y, again), f"conv {dtype} x{xs} w{ws}: two runs differ")
                    err = (y.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    check(err <= limits[dtype] * scale and torch.isfinite(y).all().item(),
                          f"conv {dtype} x{xs} w{ws}: max|err| {err} > {limits[dtype]} * {scale}")
                    del y, again, ref
                    wt = w.permute(4, 3, 0, 1, 2).contiguous()
                    n, c = xs[:2]
                    b_ms, t_bytes, t_ops = _conv_bound(n, c, ws[-1], ws[0] * ws[1] * ws[2],
                                                       math.prod(xs[2:]), dtype)
                    t = dict(ms=time_ms(lambda: cf.conv3d_flat_cuda(x, w, role), reps=5, warmup=1),
                             plain_ms=time_ms(lambda: cf.conv3d_flat_plain(x, w), reps=3, warmup=1),
                             library_ms=time_ms(lambda: F.conv3d(x, wt, padding="same"), reps=5,
                                                warmup=1),
                             bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops,
                             t_flop=2 * n * ws[-1] * c * ws[0] * ws[1] * ws[2] * math.prod(xs[2:]),
                             err=err, scale=scale)
                    timed[key] = t
                    detail.append(dict(kernel="conv3d_flat", route=cf.conv_route(dtype),
                                       dtype=str(dtype), x=list(xs), w=list(ws),
                                       tflops=t["t_flop"] / t["ms"] / 1e9,
                                       share_of_bound=b_ms / t["ms"], **t))
                    print(f"conv {str(dtype)[6:]} x{xs} w{ws}: kernel {t['ms']:.4f} ms, plain "
                          f"{t['plain_ms']:.4f}, F.conv3d {t['library_ms']:.4f}, bound "
                          f"{b_ms:.4f} ({'ops' if t_ops > t_bytes else 'bytes'}), err "
                          f"{err:.3g} of {scale:.3g}, bit-identical rerun{_rate_line(t)}",
                          flush=True)
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
                         bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops,
                         t_flop=2 * n * dys[1] * c * math.prod(k) * math.prod(xs[2:]),
                         err=err, scale=scale)
                detail.append(dict(kernel="conv3d_wgrad", route=cf.conv_route(dtype),
                                   dtype=str(dtype), x=list(xs), dy=list(dys), kernel_size=list(k),
                                   library_max_abs_err=lib_err, tflops=t["t_flop"] / t["ms"] / 1e9,
                                   share_of_bound=b_ms / t["ms"], **t))
                print(f"wgrad {str(dtype)[6:]} x{xs} dy{dys} k{k}: kernel {t['ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f}, convolution_backward {t['library_ms']:.4f}, bound "
                      f"{b_ms:.4f} ({'ops' if t_ops > t_bytes else 'bytes'}), err {err:.3g} of "
                      f"{scale:.3g} (library {lib_err:.3g}), bit-identical rerun"
                      f"{_rate_line(t)}", flush=True)
                _add(entry("wgrad", dtype), count / steps, t)
    return entries


def _gb_tol(gx):
    """Per channel: gb sums N * S terms, so two f32 orders of that sum differ by a
    multiple of eps * ||gx_c||_2, not of |gb_c|: 1e-5 * ||gx_c||_2."""
    return 1e-5 * gx.double().square().sum([0, *range(2, gx.ndim)]).sqrt()


def _gx_terms(x, b, gy):
    """Per element, |r g| + |a r^3 s / C|, the two terms whose difference is gx (f32): its
    rounding error scales with them, not with |gx|, which can be near 0 between them."""
    a = x.float() + b.reshape((1, -1) + (1,) * (x.ndim - 2))
    a = torch.where(a >= 0, a, 0.2 * a)
    g = gy.float()
    r = torch.rsqrt(a.square().mean(dim=1, keepdim=True) + 1e-8)
    s = (g * a).sum(dim=1, keepdim=True)
    return (r * g).abs() + (a * r.pow(3) * s / x.shape[1]).abs()


def _check_grad(name, gx, gb, ref_gx, ref_gb, dtype, terms):
    """The backward kernel's (gx, gb) against a reference's; `terms` from ``_gx_terms``.
    Returns the largest errors (gx, gb)."""
    ex = (gx.float() - ref_gx.float()).abs()
    eb = (gb - ref_gb).abs()
    if dtype == torch.float32:
        over_x = (ex - (1e-6 + 1e-5 * torch.maximum(ref_gx.abs(), terms))).max().item()
        over_b = (eb.double() - (1e-5 * ref_gb.abs().double() + _gb_tol(gx))).max().item()
        check(over_x <= 0 and over_b <= 0,
              f"{name}: tolerance exceeded by {over_x} (gx) / {over_b} (gb)")
    else:
        check(ex.max().item() <= 1e-2 * ref_gx.float().abs().max().item()
              and eb.max().item() <= 1e-2 * ref_gb.abs().max().item(),
              f"{name}: max|err| {ex.max().item()} (gx), {eb.max().item()} (gb)")
    return ex.max().item(), eb.max().item()


def count_kernels(fn):
    """{kernels, launch_calls} of one call of `fn`, by torch.profiler (``launch_counts``).
    The host idles 20 ms before and after the call inside the trace, so that device events
    placed a little off the call on the host's clock stay in the trace's window: a bare
    trace of the backward kernel's sub-millisecond call, late in this script, once showed
    none of its kernels (its launch calls are host events and cannot fall outside)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    kernels, launch_calls = launch_counts(prof)
    return dict(kernels=kernels, launch_calls=launch_calls)


def check_train_fused(fused_shapes, detail):
    """The fused op at every shape the train step runs it with: the forward kernel in bf16
    (the step's dtype) against its plain version; the backward kernel in f32 and bf16
    against its plain version and against autograd of the reference's oracle (what the
    backward computed before it had a kernel), gx and gb bit-identical on a rerun.  Times
    (bf16): both kernels, their plain versions, the oracle's autograd and the
    autograd.Function's backward.  Returns (forward entry, backward entry), each summed
    over the step's launches."""
    g = torch.Generator(device="cuda").manual_seed(3)
    fwd = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
               t_ops=0.0, max_abs_err=0.0)
    bwd = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, oracle_autograd_ms=0.0,
               function_backward_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0, max_abs_err=0.0,
               gb_max_abs_err=0.0, kernels_per_call={})
    for shape, count in Counter(fused_shapes).items():
        x32 = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(shape[1], generator=g, device="cuda")
        gy32 = torch.randn(shape, generator=g, device="cuda")
        x, gy = x32.bfloat16(), gy32.bfloat16()
        y = fba.fused_bias_act_pixelnorm(x, b, 0.2, True)
        ref = fba.bias_act_pixelnorm_plain(x, b, 0.2, True)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        check(err <= 1e-2 * ref.float().abs().max().item() and torch.isfinite(y).all().item(),
              f"fused bf16 {shape}: max|err| {err}")
        fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        check(_alone_equals_slot(lambda xx, bb: fba.fused_bias_act_pixelnorm(xx, bb, 0.2, True),
                                 x, b), f"fused bf16 {shape}: a sample alone differs from its slot")
        errs = {}
        for dtype, xd, gyd in ((torch.float32, x32, gy32), (torch.bfloat16, x, gy)):
            gx, gb = fba.fused_bias_act_pixelnorm_grad(xd, b, gyd, 0.2, True)
            gx2, gb2 = fba.fused_bias_act_pixelnorm_grad(xd, b, gyd, 0.2, True)
            plain = fba.bias_act_pixelnorm_grad_plain(xd, b, gyd, 0.2, True)
            xa, ba = xd.clone().requires_grad_(True), b.clone().requires_grad_(True)
            oracle = torch.autograd.grad(fba._oracle(xa, ba, 0.2, True), (xa, ba), gyd)
            torch.cuda.synchronize()
            check(torch.equal(gx, gx2) and torch.equal(gb, gb2),
                  f"fused backward {dtype} {shape}: two runs differ")
            check(torch.isfinite(gx).all().item() and torch.isfinite(gb).all().item(),
                  f"fused backward {dtype} {shape}: not finite")
            check(_alone_equals_slot(lambda xx, bb, gg: fba.fused_bias_act_pixelnorm_grad(
                xx, bb, gg, 0.2, True), xd, b, gyd),
                f"fused backward {dtype} {shape}: gx of a sample alone differs from its slot")
            terms = _gx_terms(xd, b, gyd)
            for name, (rgx, rgb) in (("plain", plain), ("oracle autograd", oracle)):
                errs[(str(dtype)[6:], name)] = _check_grad(
                    f"fused backward {dtype} {shape} vs {name}", gx, gb, rgx, rgb, dtype, terms)
            del terms
            if dtype == torch.bfloat16:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], errs[("bfloat16", "plain")][0])
                bwd["gb_max_abs_err"] = max(bwd["gb_max_abs_err"], errs[("bfloat16", "plain")][1])
        xb = x.clone().requires_grad_(True)
        yb = fba.bias_act_pixelnorm(xb, b)
        xo, bo = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        yo = fba._oracle(xo, bo, 0.2, True)
        if not bwd["kernels_per_call"]:
            # the backward before this kernel (the oracle recomputed, then its autograd)
            # against this one (one launch: gx, and gb finished by the last block)
            bwd["kernels_per_call"] = dict(
                oracle_backward=count_kernels(lambda: torch.autograd.grad(
                    fba._oracle(xo, bo, 0.2, True), (xo, bo), gy)),
                kernel=count_kernels(
                    lambda: fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)))
            print(f"fused backward kernels per call: {bwd['kernels_per_call']}", flush=True)
            check(bwd["kernels_per_call"]["kernel"]["launch_calls"] == 1,
                  f"fused backward: {bwd['kernels_per_call']['kernel']} per call, not 1 launch")
        t = dict(**time_three_ways(lambda: fba.fused_bias_act_pixelnorm(x, b, 0.2, True)),
                 plain_ms=time_ms(lambda: fba.bias_act_pixelnorm_plain(x, b, 0.2, True)))
        tb = dict(**time_three_ways(lambda: fba.fused_bias_act_pixelnorm_grad(x, b, gy, 0.2, True)),
                  plain_ms=time_ms(lambda: fba.bias_act_pixelnorm_grad_plain(x, b, gy, 0.2, True)),
                  oracle_autograd_ms=time_ms(lambda: torch.autograd.grad(
                      yo, (xo, bo), gy, retain_graph=True)),
                  function_backward_ms=time_ms(lambda: torch.autograd.grad(
                      yb, xb, gy, retain_graph=True)))
        n, c = shape[:2]
        s = math.prod(shape[2:])
        t["bound_ms"], t["t_bytes"], t["t_ops"] = bound(
            (2 * n * c * s) * 2 + c * 4, 6 * n * c * s + 2 * n * s, BF16_FLOPS)
        # x and gy read, gx written (bf16), b read and gb written (f32); per element about
        # 14 operations (bias, slope, the two channel sums, ga, gx, the gb sum)
        tb["bound_ms"], tb["t_bytes"], tb["t_ops"] = bound(
            (3 * n * c * s) * 2 + 2 * c * 4, 14 * n * c * s, BF16_FLOPS)
        detail.append(dict(kernel="fused_bias_act_pixelnorm", dtype="bfloat16", shape=list(shape),
                           calls=count, max_abs_err=err, **t))
        detail.append(dict(kernel="fused_bias_act_pixelnorm_grad", shape=list(shape),
                           calls=count, errors={f"{k[0]} vs {k[1]}": v for k, v in errs.items()},
                           **tb))
        print(f"fused bf16 {shape} x{count}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us), plain {t['plain_ms']:.4f}, "
              f"bound {t['bound_ms']:.4f}, err {err:.3g}; backward kernel {tb['ms']:.4f} ms "
              f"(device {tb['device_ms']:.4f} ms, host {tb['host_us']:.1f} us), "
              f"plain {tb['plain_ms']:.4f}, oracle autograd {tb['oracle_autograd_ms']:.4f}, "
              f"Function backward {tb['function_backward_ms']:.4f}, bound {tb['bound_ms']:.4f}, "
              f"max|err| (gx, gb) {errs}, bit-identical rerun, alone = its slot", flush=True)
        for entry, times in ((fwd, t), (bwd, tb)):
            for k, v in times.items():
                if k != "queued_ahead":
                    entry[k] += count * v
    return fwd, bwd


def compare_engines_f32(state0, real):
    """One f32 gradient computation of the step under each engine, from one state and
    one set of pre-drawn z and gamma; `flat` runs the CUDA-core convs.  Returns the
    agreement and the `flat` run's launches."""
    cfg = bench_train_config(PHASE, BATCH, compute_dtype="float32")
    arch = get_architecture("pgan")
    draws = losses.draw_inputs(torch.Generator(device="cuda").manual_seed(4), BATCH,
                               cfg.latent_dim, real.shape[1:], torch.float32, "cuda")
    res, launches = {}, {}
    for engine in ("flat", "direct"):
        # a main path of the f32 kernels: counts set to 0 just before, read just after
        zero_counts()
        grads_fn = make_grads_fn(arch, cfg, PHASE, static_alpha=None, conv_engine=engine)
        (gg, dg), out = grads_fn(state0.g_params, state0.d_params, real, draws, 0.5)
        torch.cuda.synchronize()
        counts = read_counts()
        launches[engine] = counts
        check(counts["plain"] == 0, f"f32 step [{engine}]: plain versions ran")
        convs = counts["forward"] + counts["dgrad"] + counts["wgrad"]
        check(convs > 0 if engine == "flat" else convs == 0, f"f32 step [{engine}]: {counts}")
        check(counts["conv_tc"] == counts["wgrad_tc"] == 0,
              f"f32 step [{engine}]: tensor-core launches {counts}")
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
    check(launches["flat"]["conv_simt"] == launches["flat"]["forward"] + launches["flat"]["dgrad"]
          and launches["flat"]["wgrad_simt"] == launches["flat"]["wgrad"] > 0
          and launches["flat"]["fused_grad"] == launches["flat"]["fused"] > 0,
          f"f32 step [flat]: launches {launches['flat']}")
    del ga, gb, res
    # the f32 gradient computation under flat, the CLI's default dtype and engine on the card
    grads_fn = make_grads_fn(arch, cfg, PHASE, static_alpha=None, conv_engine="flat")
    flat_ms = time_ms(lambda: grads_fn(state0.g_params, state0.d_params, real, draws, 0.5),
                      reps=5, warmup=1)
    print(f"f32 gradient computation under flat (phase 6, batch 8): {flat_ms:.2f} ms (median of "
          f"5 after a warm-up, CUDA events)", flush=True)
    return dict(loss_rel=loss_rel, worst_grad_rel=worst[0], worst_grad=worst[1],
                flat_launches=launches["flat"], flat_grads_ms=flat_ms)


def write_dataset(root: Path):
    """A seeded npy pyramid: 16 volumes of 16x64x64 (phase 5) and 16 of 32x128x128
    (phase 6), f32, about 36 MB."""
    rng = np.random.default_rng(0)
    for size, depth in ((64, 16), (128, 32)):
        d = root / f"{size}x{size}"
        d.mkdir(parents=True)
        for i in range(16):
            np.save(d / f"{i:03d}.npy",
                    rng.standard_normal((depth, size, size), dtype=np.float32))


def trainer_args(data: Path, logdir: Path, *extra):
    return [str(data) if a == "<data>" else a for a in TRAINER_ARGS] + [
        "--logdir", str(logdir), *extra]


def _events(logdir: Path):
    with open(logdir / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def run_trainer(data: Path, logdir: Path):
    """The trainer through ``cli.main``, in process, with the metric passes
    (``METRIC_ARGS``), counts set to 0 just before and read just after.  Returns (report,
    launches)."""
    zero_counts()
    t0 = time.perf_counter()
    cli.main(trainer_args(data, logdir, *METRIC_ARGS))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["plain"] == 0, f"trainer: {counts['plain']} plain-version calls on the card")
    for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad"):
        check(counts[k] > 0, f"trainer: kernel {k} not launched ({counts})")
    check(counts["conv_simt"] == counts["wgrad_simt"] == 0
          and counts["conv_tc"] == counts["forward"] + counts["dgrad"]
          and counts["wgrad_tc"] == counts["wgrad"], f"trainer (bf16): routes {counts}")
    for p in (5, 6):
        check((logdir / f"model_{p}.npz").is_file(), f"trainer: model_{p}.npz not written")
    # phase 6 restored every phase-5 name bit for bit, and its mixing half kept them frozen:
    # the cadence checkpoint after the mixing half still holds model_5's values
    # (phase 5's own fade-in layers from phase 4, *_rgb_4, are not part of phase 6)
    p5, _, _ = ckpt.load_params(str(logdir / "model_5.npz"), "cpu")
    c6, _, _ = ckpt.load_params(str(logdir / "model_6_ckpt_96.npz"), "cpu")
    shared = [k for k in p5 if k in c6]
    check(all("_rgb_4/" in k for k in p5 if k not in c6) and len(shared) > 0.9 * len(p5),
          f"trainer: phase 6 lacks names of model_5: {sorted(set(p5) - set(c6))}")
    check(all(torch.equal(c6[k], p5[k]) for k in shared),
          "trainer: phase 6 did not keep model_5's weights through the frozen mixing half")

    events = _events(logdir)
    engines = [e["text"] for e in events if e["tag"] == "config/conv_engine"]
    check(engines == ["flat"], f"trainer without --conv_engine on the card: engine {engines}")
    report = dict(wall_s=wall_s, launches=counts, conv_engine=engines[0], phases={})
    for phase, lo, hi in ((5, 0, PHASE6_START), (6, PHASE6_START, 10 ** 9)):
        ev = [e for e in events if lo <= e["step"] < hi]
        for tag in ("Loss/d_loss", "Loss/g_loss", "Loss/gp"):
            vals = [e["value"] for e in ev if e["tag"] == tag]
            check(vals and all(math.isfinite(v) for v in vals),
                  f"trainer phase {phase}: {tag} {vals}")
        check(any(e.get("hist") for e in ev), f"trainer phase {phase}: no histogram event")
        row = {}
        # a summary step (local step % 16 < batch) runs the histogram variant; at batch 16
        # every phase-5 step is one
        batch = 16 if phase == 5 else 8
        for half in ("mixing", "stabilizing"):
            timed = [e for e in ev if e["tag"] == f"Timing/step_ms_{half}"]
            check(len(timed) >= 2, f"trainer phase {phase} {half}: {len(timed)} timed steps")
            ms = [e["value"] for e in timed]
            row[f"{half}_ms_per_step"] = statistics.median(ms[1:])
            row[f"{half}_ms_all"] = ms
            # steps without a summary, to hold against the bare step's same half
            plain = [e["value"] for e in timed[1:] if (e["step"] - lo) % 16 >= batch]
            row[f"{half}_plain_ms"] = statistics.median(plain) if plain else None
        # img/s and the phase's peak are written after a step, at the advanced count
        after = [e for e in events if lo < e["step"] <= hi]
        img_s = [e["value"] for e in after if e["tag"] == "img_s" and e["value"] > 0]
        row["img_s"] = img_s[-1] if img_s else None
        peak = [e["value"] for e in after if e["tag"] == "memory/phase_peak_bytes"]
        check(len(peak) == 1, f"trainer phase {phase}: peak memory events {peak}")
        row["peak_mib"] = peak[0] / 2 ** 20
        # the metric passes: their tags, and the ms per step with their host time spread
        # over the phase's steps against the steps alone
        for tag in METRIC_TAGS:
            vals = [e["value"] for e in after if e["tag"] == tag]
            check(vals and all(math.isfinite(v) for v in vals),
                  f"trainer phase {phase}: metric {tag} {vals}")
        row["metrics"] = {tag: [e["value"] for e in after if e["tag"] == tag][-1]
                          for tag in METRIC_TAGS}
        metric_s = [e["value"] for e in after if e["tag"] == "Timing/metrics_s"]
        steps = [e["value"] for e in ev if e["tag"].startswith("Timing/step_ms_")]
        row["metric_passes_s"] = metric_s
        row["ms_per_step_without_metrics"] = statistics.median(steps)
        row["ms_per_step_with_metrics"] = (sum(steps) + 1e3 * sum(metric_s)) / len(steps)
        report["phases"][phase] = row
        print(f"trainer phase {phase}: mixing {row['mixing_ms_per_step']:.2f} ms/step, "
              f"stabilizing {row['stabilizing_ms_per_step']:.2f} ms/step (median after the "
              f"first, CUDA events; all {[round(v, 2) for v in row['mixing_ms_all']]} / "
              f"{[round(v, 2) for v in row['stabilizing_ms_all']]}; steps without summary "
              f"{row['mixing_plain_ms']} / {row['stabilizing_plain_ms']}), "
              f"img/s {row['img_s']}, "
              f"peak {row['peak_mib']:.0f} MiB; ms/step {row['ms_per_step_without_metrics']:.2f} "
              f"without the metric passes (median), {row['ms_per_step_with_metrics']:.2f} with "
              f"their host time ({[round(v, 2) for v in metric_s]} s) spread over the "
              f"{len(steps)} steps; metrics {row['metrics']}", flush=True)
    print(f"trainer: {wall_s:.1f} s wall for phases 5 and 6, launches {counts}", flush=True)
    return report


def check_bitwise_resume(data: Path, logdir: Path, uninterrupted: Path):
    """The same command in a subprocess with full-state checkpoints, SIGTERM once the
    last phase (6) printed its second step line (exit 75), then again with --auto_resume
    (exit 0): its model_6.npz must equal the uninterrupted run's bit for bit."""
    last = TRAINER_ARGS[TRAINER_ARGS.index("--ending_phase") + 1]
    cmd = [sys.executable, "-u", "-m", "saragan_tpu_torch",
           *trainer_args(data, logdir, "--full_state_checkpoints")]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    lines, phase6, seen = [], False, 0
    try:
        for line in p.stdout:
            lines.append(line)
            phase6 = phase6 or f"Begin mixing epochs in phase {last}" in line
            if phase6 and "\tStep " in line:
                seen += 1
                if seen == 2:
                    p.send_signal(signal.SIGTERM)
                    break
        lines.append(p.stdout.read())
        rc = p.wait(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    out = "".join(lines)
    check(rc == 75 and "INTERRUPTED" in out, f"SIGTERM run exited {rc}:\n{out[-3000:]}")
    pkls = [f for f in os.listdir(logdir) if f.endswith("_interrupt.pkl")]
    check(len(pkls) == 1, f"SIGTERM run left {pkls}")
    again = subprocess.run(cmd + ["--auto_resume"], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=900)
    check(again.returncode == 0 and "auto_resume: continuing from" in again.stdout,
          f"auto_resume run exited {again.returncode}:\n{again.stdout[-3000:]}"
          f"{again.stderr[-3000:]}")
    with (np.load(uninterrupted / f"model_{last}.npz") as a,
          np.load(logdir / f"model_{last}.npz") as b):
        check(sorted(a.files) == sorted(b.files), "the resumed checkpoint has other arrays")
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
    check(not differ, f"resumed model_{last}.npz differs from the uninterrupted run in {differ}")
    seconds = time.perf_counter() - t0
    print(f"bitwise resume: SIGTERM run exited 75 at {pkls[0]}, the auto_resume run exited 0, "
          f"model_{last}.npz bit-equal to the uninterrupted run ({len(a.files)} arrays), "
          f"{seconds:.1f} s", flush=True)
    return dict(interrupt=pkls[0], arrays=len(a.files), seconds=seconds)


def check_conv_v2(items, dtype, detail):
    """Kernel #3 at every (role, x shape, w shape, weight) of `items`: against its plain
    version, against kernel #1, and against itself on a rerun; times weighted by
    `weight` (launches per unit) and summed."""
    g = torch.Generator(device="cuda").manual_seed(5)
    limit = {torch.float32: 1e-4, torch.bfloat16: 1e-2}[dtype]
    route = cf.conv_route(dtype)
    e = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, v1_ms=0.0, bound_ms=0.0, t_bytes=0.0,
             t_ops=0.0, t_flop=0.0, max_abs_err=0.0, max_rel_err=0.0, max_rel_diff_v1=0.0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for role, xs, ws, weight in items:
            x = torch.randn(xs, generator=g, device="cuda").to(dtype)
            fan_in = ws[0] * ws[1] * ws[2] * ws[3]
            w = (torch.randn(ws, generator=g, device="cuda") * (2.0 / fan_in) ** 0.5).to(dtype)
            routed = cf.launches_by_route(cf.conv3d_flat_v2_cuda)[route]
            y = cf.conv3d_flat_v2_cuda(x, w, role)
            again = cf.conv3d_flat_v2_cuda(x, w, role)
            check(cf.launches_by_route(cf.conv3d_flat_v2_cuda)[route] == routed + 2,
                  f"conv v2 {dtype} x{xs} w{ws}: not through the {route} route")
            y1 = cf.conv3d_flat_cuda(x, w, role)
            ref = cf.conv3d_flat_v2_plain(x, w)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"conv v2 {dtype} x{xs} w{ws}: two runs differ")
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            v1_rel = (y.float() - y1.float()).abs().max().item() / scale
            check(err <= limit * scale and v1_rel <= limit and torch.isfinite(y).all().item(),
                  f"conv v2 {dtype} x{xs} w{ws}: max|err| {err} of {scale}, v1 diff {v1_rel}")
            del ref, y1
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            n, c = xs[:2]
            b_ms, t_bytes, t_ops = _conv_bound(n, c, ws[-1], ws[0] * ws[1] * ws[2],
                                               math.prod(xs[2:]), dtype)
            t = dict(ms=time_ms(lambda: cf.conv3d_flat_v2_cuda(x, w, role), reps=5, warmup=1),
                     v1_ms=time_ms(lambda: cf.conv3d_flat_cuda(x, w, role), reps=5, warmup=1),
                     plain_ms=time_ms(lambda: cf.conv3d_flat_v2_plain(x, w), reps=2, warmup=0),
                     library_ms=time_ms(lambda: F.conv3d(x, wt, padding="same"), reps=5,
                                        warmup=1),
                     bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops,
                     t_flop=2 * n * ws[-1] * c * ws[0] * ws[1] * ws[2] * math.prod(xs[2:]))
            plan = (cf.conv_v2_tc_plan if route == "tc" else cf.conv_v2_simt_plan)(
                xs, ws, sms=cf._sm_count(x.device))
            plan_s = ", ".join(f"{k} {v}" for k, v in vars(plan).items())
            detail.append(dict(kernel="conv3d_flat_v2", route=route, role=role, dtype=str(dtype),
                               x=list(xs), w=list(ws), weight=weight, max_abs_err=err,
                               scale=scale, rel_diff_v1=v1_rel, plan=plan_s,
                               tflops=t["t_flop"] / t["ms"] / 1e9,
                               share_of_bound=b_ms / t["ms"], **t))
            print(f"conv v2 {str(dtype)[6:]} {role} x{xs} w{ws} x{weight:g}: kernel "
                  f"{t['ms']:.4f} ms, kernel #1 {t['v1_ms']:.4f}, plain {t['plain_ms']:.4f}, "
                  f"F.conv3d {t['library_ms']:.4f}, bound {b_ms:.4f} "
                  f"({'ops' if t_ops > t_bytes else 'bytes'}), err {err:.3g} of {scale:.3g}, "
                  f"bit-identical rerun{_rate_line(t)}; plan {plan_s}", flush=True)
            for k in ("ms", "plain_ms", "library_ms", "v1_ms", "bound_ms", "t_bytes", "t_ops",
                      "t_flop"):
                e[k] += weight * t[k]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["max_rel_err"] = max(e["max_rel_err"], err / scale)
            e["max_rel_diff_v1"] = max(e["max_rel_diff_v1"], v1_rel)
    return e


def check_mbstd(detail):
    """Kernel #5 through ``minibatch_stddev_stat_cuda`` at ``profile_mbstd.mbstd_inputs``:
    group 4 at N 8 and 16, the per-sample feature counts of the largest and smallest
    phase-6 D activation, f32 and bf16, and group 3 (not a template size of the kernel)
    at N 12.  Sums over the eight group-4 inputs, as earlier runs summed them."""
    g = torch.Generator(device="cuda").manual_seed(6)
    e = dict(ms=0.0, device_ms=0.0, host_us=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
             t_ops=0.0, max_abs_err=0.0)
    for which, shape, dtype, group in mbstd_inputs():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        before = mb.minibatch_stddev_stat_cuda.launches
        s = mb.minibatch_stddev_stat_cuda(x, group)
        again = mb.minibatch_stddev_stat_cuda(x, group)
        ref = mb.minibatch_stddev_stat_plain(x, group)
        torch.cuda.synchronize()
        label = f"mbstd {dtype} {tuple(x.shape)} G {group}"
        check(mb.minibatch_stddev_stat_cuda.launches == before + 2, f"{label}: launch count")
        check(torch.equal(s, again), f"{label}: reruns differ")
        err = (s - ref).abs().max().item()
        check(err <= 1e-5 * ref.abs().max().item(), f"{label}: max|err| {err}")
        calls = count_kernels(lambda: mb.minibatch_stddev_stat_cuda(x, group))
        check(calls["launch_calls"] == 1, f"{label}: {calls} launches per call")
        nbytes = x.numel() * x.element_size() + s.numel() * 4
        b_ms, t_bytes, t_ops = bound(nbytes, 5 * x.numel(), F32_FLOPS)
        t = time_three_ways(lambda: mb.minibatch_stddev_stat_cuda(x, group))
        t.update(plain_ms=time_ms(lambda: mb.minibatch_stddev_stat_plain(x, group), reps=5,
                                  warmup=1),
                 bound_ms=b_ms, t_bytes=t_bytes, t_ops=t_ops)
        detail.append(dict(kernel="minibatch_stddev_stat", shape=list(x.shape),
                           dtype=str(dtype), group_size=group, which=which, max_abs_err=err,
                           plan=str(mb.mbstd_plan(shape[0], x[0].numel(), dtype, group,
                                                  cf._sm_count(x.device))),
                           **calls, **t))
        print(f"{label} ({which}): ms {t['ms']:.4f}, device_ms {t['device_ms']:.4f}, host_us "
              f"{t['host_us']:.1f}, plain {t['plain_ms']:.4f}, bound {b_ms:.4f} "
              f"({'bytes' if t_bytes >= t_ops else 'ops'}), err {err:.3g}, bit-identical "
              f"rerun, {calls['launch_calls']} launch call / {calls['kernels']} kernel per call",
              flush=True)
        if group == 4:
            for k in ("ms", "device_ms", "host_us", "plain_ms", "bound_ms", "t_bytes", "t_ops"):
                e[k] += t[k]
        e["max_abs_err"] = max(e["max_abs_err"], err)
    return e


class _TimedExtractor:
    """A feature extractor whose extract() calls are timed (host clock; the call returns
    numpy, so the card's work is inside)."""

    def __init__(self, extractor):
        self.extractor, self.seconds, self.images = extractor, 0.0, 0

    def extract(self, images):
        t0 = time.perf_counter()
        out = self.extractor.extract(images)
        self.seconds += time.perf_counter() - t0
        self.images += len(images)
        return out


def check_metrics(data: Path, params, cfg, tmp: Path):
    """The metrics slice at full width: ``generate()``'s report at phase 6 for 8 volumes
    of 32x128x128 (one batch of 8) from the serving generator on the trainer's npy
    pyramid, every metric on, FID over the random-feature extractor (the
    --allow_uncalibrated_fid route); then FID-only over the Inception network with random
    parameters written to an npz.  Every value finite; FID(real, real) at most 1e-2 of
    FID(real, fake) for both extractors; Inception pool3 features of 8 slices on the card
    within 1e-3 * max|CPU| of the CPU's.  Prints the seconds of feature extraction (on
    the card) against the numpy/scipy metric arithmetic (on the host)."""
    zero_counts()
    model = ckpt.save_params(str(tmp / f"model_{PHASE}"), params, ema=params)
    npz = minc.save_inception_npz(minc.random_inception_params(0), str(tmp / "inception.npz"))
    everything = dict(compute_FID=True, compute_swds=True, compute_ssims=True,
                      compute_psnrs=True, compute_mses=True, compute_nrmses=True)
    out = dict(volumes=BATCH, slices_per_volume=cfg.current_shape(PHASE, 1)[2])
    for name, extra, compute in (
            ("random", dict(allow_uncalibrated_fid=True), everything),
            ("inception", dict(inception_weights=npz), dict(compute_FID=True))):
        rcfg = dataclasses.replace(cfg, **extra)
        extractor = _TimedExtractor(mfid.default_extractor(
            allow_uncalibrated=rcfg.allow_uncalibrated_fid, npz_path=rcfg.inception_weights,
            device="cuda"))
        check(isinstance(extractor.extractor, mfid.RandomConvFeatures if name == "random"
                         else mfid.InceptionFeatures), f"metrics: extractor for {name}")
        t0 = time.perf_counter()
        report = generate("pgan", str(data), model, str(tmp / f"report_{name}"), cfg=rcfg,
                          phase=PHASE, num_samples=BATCH, batch_size=BATCH, seed=0,
                          compute_metrics=compute, device="cuda", extractor=extractor)
        wall = time.perf_counter() - t0
        want = {"fid"} | ({"swd", "psnr", "ssim", "mse", "nrmse"} if compute is everything
                          else set())
        check(set(report) == want and all(math.isfinite(v) for v in report.values()),
              f"metrics ({name}): report {report}")
        # the same real batch (the dataset's seeded stream) against itself
        real = get_numpy_dataset(PHASE, cfg.starting_phase, cfg.start_shape, str(data), None,
                                 seed=0).batch(BATCH).astype(np.float32)
        extracted, sliced, t1 = extractor.seconds, extractor.images, time.perf_counter()
        fid_same = mfid.calculate_fid_given_batch_volumes(real, real, extractor,
                                                          verbose=False)
        frechet_s = time.perf_counter() - t1 - (extractor.seconds - extracted)
        check(abs(fid_same) <= 1e-2 * report["fid"],
              f"metrics ({name}): FID(real, real) {fid_same} against FID(real, fake) "
              f"{report['fid']}")
        row = dict(report=report, fid_real_real=fid_same, wall_s=wall,
                   extraction_s=extracted, slices=sliced,
                   extract_ms_per_volume=1e3 * extracted / (2 * BATCH),
                   host_s=dict(frechet_distance=frechet_s))
        if compute is everything:  # the host's metric arithmetic on the report's arrays
            fake = np.stack([np.load(tmp / f"report_{name}" / f"fake_0000_{j}.npy")[None]
                             for j in range(BATCH)])
            host = row["host_s"]
            for metric, fn in (("swd", lambda: swd.get_swd_for_volumes(real, fake)),
                               ("ssim", lambda: skim.get_ssim(real, fake)),
                               ("psnr", lambda: skim.get_psnr(real, fake)),
                               ("mse", lambda: skim.get_mean_squared_error(real, fake)),
                               ("nrmse", lambda: skim.get_normalized_root_mse(real, fake))):
                t1 = time.perf_counter()
                fn()
                host[metric] = time.perf_counter() - t1
        out[name] = row
        print(f"metrics ({name} features): report {report}; FID(real, real) {fid_same:.4g}; "
              f"generate() {wall:.2f} s, of which extraction {extracted:.2f} s on the card for "
              f"{sliced} slices ({row['extract_ms_per_volume']:.1f} ms per "
              f"{out['slices_per_volume']}-slice volume); host numpy/scipy seconds on the same "
              f"arrays {json.dumps({k: round(v, 3) for k, v in row['host_s'].items()})}",
              flush=True)

    counts = read_counts()
    check(counts["fused"] > 0 and counts["plain"] == 0,
          f"metrics: generate() sampled without the fused kernel or through a plain version "
          f"({counts})")
    out["launches"] = counts

    # the Inception features of 8 slices, card against CPU
    slices = stdnormal_to_8bit_numpy(np.repeat(real[0, 0, :8, :, :, None], 3, axis=-1))
    slices = slices.astype(np.float32)
    p = minc.load_inception_npz(npz)
    on_card = minc.InceptionPool3Features(p, device="cuda").extract(slices)
    on_cpu = minc.InceptionPool3Features(p, device="cpu").extract(slices)
    diff = float(np.abs(on_card - on_cpu).max())
    scale = float(np.abs(on_cpu).max())
    check(diff <= 1e-3 * scale, f"metrics: Inception features card vs CPU {diff} of {scale}")
    out["inception_card_vs_cpu"] = dict(max_abs_diff=diff, scale=scale)
    print(f"metrics: Inception pool3 of 8 slices, card against CPU: max|diff| {diff:.3g} of "
          f"{scale:.3g}", flush=True)
    return out


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
    seconds = {}
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)

    report = _build.build_all()
    print(f"build: {sorted(report) or 'cached libraries'}", flush=True)
    ptxas = {}
    for name, r in report.items():
        print(f"  {name}: {r['seconds']:.1f} s", flush=True)
        if name.startswith(("conv3d_", "fused_", "minibatch_")):  # registers and spills
            ptxas[name] = _build.ptxas_report(r["log"])
            for row in ptxas[name]:
                print(f"    {_kernel_label(row['function'])}: {row['registers']} registers, "
                      f"spills {row['spill_stores']} B stored / {row['spill_loads']} B loaded",
                      flush=True)
        else:
            print(r["log"][-2000:], flush=True)
    hmma = tensor_core_instructions()
    ptxas["hmma_instructions"] = hmma
    print(f"tensor-core (HMMA) instructions in the SASS of the bf16 conv libraries: {hmma}",
          flush=True)
    check(all(hmma.values()), f"a bf16 conv library has no tensor-core instruction: {hmma}")
    phase_done("build")

    cfg = Config(**BENCH_CFG, starting_phase=PHASE, ending_phase=PHASE).finalize()
    fused_shapes, serve_convs = serving_shapes(cfg, PHASE, BATCH)
    check(len(fused_shapes) == 11 and len(serve_convs) == 6, "phase-6 serving shapes")
    detail = []
    fused = check_fused(fused_shapes, detail)
    conv = check_conv(serve_convs, detail)
    phase_done("serving kernels")

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
    phase_done("serving")

    # training: the flagship step under both engines from one initial state
    tcfg = bench_train_config(PHASE, BATCH)
    state0, opts = init_train_state(get_architecture("pgan"), torch.Generator().manual_seed(0),
                                    phase=PHASE, cfg=tcfg, device="cuda")
    real = real_batch(tcfg, PHASE, BATCH, "cuda")
    trained = {engine: train_engine(tcfg, engine, state0, opts, real)
               for engine in ("flat", "direct")}
    phase_done("train step")
    conv_shapes, wgrad_shapes = trained["flat"][2]
    train_steps = TRAIN_STEPS * 2  # both halves
    train_convs = check_train_convs(conv_shapes, wgrad_shapes, train_steps, detail)
    train_fused, train_fused_grad = check_train_fused(fused_shapes, detail)
    phase_done("training kernels")
    engines_f32 = compare_engines_f32(state0, real)
    del state0, real
    phase_done("f32 engines")

    # the trainer through its CLI: phase 5 -> 6 at full width, then a preempted and
    # resumed run of the same command that must end bit-equal
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp / "data")
        trainer = run_trainer(tmp / "data", tmp / "run")
        phase_done("trainer")
        resume = check_bitwise_resume(tmp / "data", tmp / "resumed", tmp / "run")
        phase_done("bitwise resume")
        metrics = check_metrics(tmp / "data", params, cfg, tmp)
        phase_done("metrics")

    # kernel #3 (standalone) at the serving shapes (f32) and the train step's forward and
    # dgrad shapes (bf16), and kernel #5 (standalone)
    zero_counts()
    by_role = {}
    for (role, xs, ws, _), count in sorted(conv_shapes.items(), key=str):
        by_role.setdefault(role, []).append((role, xs, ws, count / train_steps))
    v2, v2_launches = {}, {}
    for key, shapes, dtype in (
            ("f32", [("forward", xs, ws, 1) for xs, ws in serve_convs], torch.float32),
            ("forward", by_role["forward"], torch.bfloat16),
            ("dgrad", by_role["dgrad"], torch.bfloat16)):
        before = cf.conv3d_flat_v2_cuda.launches
        v2[key] = check_conv_v2(shapes, dtype, detail)
        v2_launches[key] = cf.conv3d_flat_v2_cuda.launches - before
    mbstd = check_mbstd(detail)
    mbstd_launches = mb.minibatch_stddev_stat_cuda.launches
    phase_done("standalone kernels")

    main_launches = served["flat"][2]
    dispatches = served["flat"][1]["dispatches"]
    flat_runs = trained["flat"][1]
    train_launches = {k: sum(flat_runs[h]["total"][k] for h in flat_runs)
                      for k in ("forward", "dgrad", "wgrad", "fused", "fused_grad")}
    per = (f"one phase-6 batch-8 f32 serving forward (sum over its launches); launches "
           f"counted over {dispatches} dispatches")
    per_step = (f"one phase-6 batch-8 bf16 train step under flat (sum over its launches); "
                f"launches counted over {train_steps} steps")
    per_f32 = ("one phase-6 batch-8 f32 gradient computation of the train step under flat "
               "(sum over the kernel's launches at the bf16 step's per-step counts, whose "
               "shapes it shares); launches counted over that one computation (phase 7)")
    fwd32, dgrad32 = train_convs[("forward", "float32")], train_convs[("dgrad", "float32")]
    conv32 = {k: fwd32[k] + dgrad32[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "t_bytes", "t_ops", "t_flop")}
    conv32["max_abs_err"] = max(fwd32["max_abs_err"], dgrad32["max_abs_err"])
    f32_launches = engines_f32["flat_launches"]
    per_v2 = (f"{STANDALONE_3}; ms per phase-6 batch-8 f32 serving forward / bf16 train step "
              f"(sum over the shapes kernel #1 runs at); launches of this entry's own standalone "
              f"check, its timing repeats included")
    per_mbstd = (f"{STANDALONE_5}; ms, device_ms and host_us summed over 8 inputs (group 4, "
                 f"N 8 and 16, the largest and smallest phase-6 D activation, f32 and bf16); "
                 f"launches of this standalone check (a ninth input of group 3 included)")
    kernels = []
    for name, route, source, replaces, e, launches, library, per_what, unit in (
            ("fused_bias_act_pixelnorm", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:112", fused, main_launches["fused"], None, per,
             dispatches),
            ("conv3d_flat", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/pallas_conv.py:124", conv, main_launches["conv"], "library_ms", per,
             dispatches),
            ("fused_bias_act_pixelnorm[train,bf16]", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:112", train_fused, train_launches["fused"], None,
             per_step, train_steps),
            ("fused_bias_act_pixelnorm_grad[train,bf16]", "cuda", FUSED_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:123",
             train_fused_grad, train_launches["fused_grad"], None, per_step, train_steps),
            ("conv3d_flat[forward+dgrad,f32,train]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd.cu",
             "saragan_tpu/ops/pallas_conv.py:124", conv32,
             f32_launches["forward"] + f32_launches["dgrad"], "library_ms", per_f32, 1),
            ("conv3d_wgrad[f32,train]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad.cu",
             "saragan_tpu/ops/pallas_conv.py:183", train_convs[("wgrad", "float32")],
             f32_launches["wgrad"], "library_ms", per_f32, 1),
            ("conv3d_flat[forward,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:124", train_convs[("forward", "bfloat16")],
             train_launches["forward"], "library_ms", per_step, train_steps),
            ("conv3d_flat[dgrad,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_tc.cu",
             "saragan_tpu/ops/core.py:386", train_convs[("dgrad", "bfloat16")],
             train_launches["dgrad"], "library_ms", per_step, train_steps),
            ("conv3d_wgrad[bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_wgrad_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:183", train_convs[("wgrad", "bfloat16")],
             train_launches["wgrad"], "library_ms", per_step, train_steps),
            ("conv3d_flat_v2[f32]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_v2.cu",
             "saragan_tpu/ops/pallas_conv.py:288", v2["f32"], v2_launches["f32"], "library_ms",
             per_v2, None),
            ("conv3d_flat_v2[forward,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_v2_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:288", v2["forward"], v2_launches["forward"],
             "library_ms", per_v2, None),
            ("conv3d_flat_v2[dgrad,bf16]", "cuda", "saragan_tpu_torch/csrc/conv3d_fwd_v2_tc.cu",
             "saragan_tpu/ops/pallas_conv.py:288", v2["dgrad"], v2_launches["dgrad"],
             "library_ms", per_v2, None),
            ("minibatch_stddev_stat", "cuda", MBSTD_SOURCE,
             "saragan_tpu/ops/pallas_kernels.py:159", mbstd, mbstd_launches, None, per_mbstd,
             None)):
        check(launches > 0, f"{name}: not launched")
        k = dict(name=name, route=route, source=source, replaces=replaces, launches=launches,
                 max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
                 bound_ms=e["bound_ms"],
                 bound_by="operations" if e["t_ops"] > e["t_bytes"] else "bytes",
                 library_ms=e[library] if library else None, per=per_what)
        if unit:
            k["launches_per_unit"] = launches / unit
        for extra in ("device_ms", "host_us", "v1_ms", "max_rel_diff_v1", "oracle_autograd_ms",
                      "function_backward_ms", "gb_max_abs_err", "kernels_per_call"):
            if extra in e:
                k[extra] = e[extra]
        if "t_flop" in e:  # the conv rows: the rate
            k["tflops"] = e["t_flop"] / e["ms"] / 1e9
            k["share_of_bound"] = e["bound_ms"] / e["ms"]
        kernels.append(k)
    f32_train = {f"{kind}[f32]": {x: e[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "max_abs_err", "launches_per_step")}
                 for (kind, dt), e in train_convs.items() if dt == "float32"}
    training = {e: dict(timing=trained[e][0], launches=trained[e][1]) for e in trained}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, shapes=detail, f32_train_kernels=f32_train, ptxas=ptxas,
        serving={e: served[e][1] for e in served}, training=training,
        engines_f32=engines_f32, trainer=trainer, bitwise_resume=resume, metrics=metrics,
        seconds=seconds), indent=1))
    print(f"serving: " + json.dumps({e: served[e][1] for e in served}), flush=True)
    print("training: " + json.dumps({e: {h: dict(step_ms=r["step_ms"], peak_mib=r["peak_mib"])
                                         for h, r in trained[e][0].items()} for e in trained}),
          flush=True)
    print("f32 training-shape kernels: " + json.dumps(f32_train), flush=True)
    print(f"f32 gradient computation under flat: {engines_f32['flat_grads_ms']:.2f} ms", flush=True)
    print("trainer: " + json.dumps(dict(
        launches=trainer["launches"], wall_s=trainer["wall_s"],
        phases={p: {k: v for k, v in r.items() if not k.endswith("_all")}
                for p, r in trainer["phases"].items()})), flush=True)
    print("metrics: " + json.dumps({k: v for k, v in metrics.items()}), flush=True)
    print("seconds: " + json.dumps(seconds), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
