"""Data parallelism on the card: the data-parallel flagship step against the one-process
step on the global batch, its all-reduce, and the depth-halo conv against kernel #1 on the
whole volume.

    python -m torch.distributed.run --nproc_per_node N -m saragan_tpu_torch.tools.profile_parallel \
        [--device cuda:0]

Every rank joins the group torchrun describes (``parallel.init_mesh``; each rank on
``cuda:LOCAL_RANK`` unless ``--device`` names one card for all, and then over gloo: NCCL
refuses two ranks on one card). Then, for f32 and bf16, the flagship step
(``bench.py:99-119``'s configuration, ``profile_training.bench_train_config``; the
mixing half, alpha 0.5; ``flat``): every rank builds the same seeded state and the
global batch (N(0, 1) from numpy seed 0, 8 rows per rank) and runs one data-parallel
step on its rows from a generator seeded alike; rank 0 also runs the one-process step on
the whole global batch and compares (``compare_states``: f32 at rtol 1e-4 / atol 1e-6,
bf16 against the f32 step); every rank's state after the step and after 3 more must be
bit-equal to rank 0's (sha-256 of every tensor). The timed steps are chained (CUDA
events, per rank); rank 0 then times the one-process step on its own 8 rows alone (the
others waiting), the step a rank would take without the others. The all-reduce is timed alone on a dict shaped like the G and D
gradients (host clock around a synchronised call, median of 5). The halo conv: phase 6's
last generator conv (batch 8, f32) with its depth split over the ranks, through kernel
#1 (``halo_conv3d(engine="flat")``), held against #1 on the whole volume (within 1e-5 of
max, bit-equality reported); its time against the whole-volume #1's, and #1's own time
on the extended slab beside its plain version, ``F.conv3d`` on the same slab and the
bound. Rank 0 prints one JSON line and writes it to
``chiprun_out/profile_parallel.json``; a failed check raises on every rank. No number
here is a multi-card speed-up: ranks sharing one card measure the protocol's cost.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops.core import conv_apply
from saragan_tpu_torch.parallel import (allreduce_mean_, any_rank, halo_conv3d, init_mesh,
                                        shard_rows)
from saragan_tpu_torch.tools.profile_serving import time_ms
from saragan_tpu_torch.tools.profile_training import bench_train_config, real_batch
from saragan_tpu_torch.train.step import init_train_state, make_train_step

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA data sheet), as chip_smoke.py
F32_FLOPS = 67e12
LR = 1e-3
# bf16: how much farther from the f32 step the data-parallel gradient may be than the
# one-process bf16 gradient is.  Measured on an H100 (every run alike): G 3.05e-3 against
# 2.60e-3 of max (1.17x), D 4.07e-2 against 4.07e-2 (1.00x)
BF16_GRAD_MARGIN = 1.5
ALPHA = 0.5
PHASE, BATCH, STEPS = 6, 8, 3  # the flagship step's phase and rows per rank; timed steps
OUT = Path("chiprun_out") / "profile_parallel.json"


def state_sha(state) -> str:
    """sha-256 over every tensor of a TrainState, names sorted."""
    h = hashlib.sha256()
    trees = {"g": state.g_params, "d": state.d_params, "ema": state.ema,
             **{f"g_opt/{s}": t for s, t in state.g_opt.slots.items()},
             **{f"d_opt/{s}": t for s, t in state.d_opt.slots.items()}}
    for name in sorted(trees):
        for k in sorted(trees[name]):
            h.update(f"{name}/{k}".encode())
            h.update(trees[name][k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _grads(state, net):
    """A network's gradients after one step from a fresh state: Adam's first moment at
    beta1 0."""
    return getattr(state, f"{net}_opt").slots["mu"]


def _err(a, b, top) -> float:
    return max(float((a[k] - v).abs().max()) for k, v in b.items()) / top


def compare_states(dp, one, compute_dtype: str, f32_one=None) -> dict:
    """The data-parallel step's state `dp` against the one-process step's `one` (both
    from one state; Adam with beta1 0, so the first moment is the gradient).

    f32: parameters and EMA within rtol 1e-4 / atol 1e-6 but for entries whose gradient is
    below 1e-7 of the network's largest (Adam's step there is set by the rounding of a
    gradient under its eps), those within 2 lr and fewer than 1e-4 of the entries; each
    network's gradients within 1e-4 of its largest.
    bf16: the gradients no farther from the one-process f32 step's `f32_one` than
    ``BF16_GRAD_MARGIN`` times the one-process bf16 step's are (bf16 rounds each rank's
    partial sums, so the data-parallel gradient is another bf16 rounding of the same sum);
    parameters and EMA within lr / 2 of the one-process bf16 step's but where the f32
    gradient is within those gradient errors (plus 1e-7) of zero, so that its sign, and
    so Adam's step of about lr sign(g) at beta1 0, is not determined in bf16: those within
    2 lr.  Returns the measured errors and whether every limit held."""
    out, ok = {}, True
    for net, params in (("g", "g_params"), ("d", "d_params")):
        mu_dp, mu_one = _grads(dp, net), _grads(one, net)
        top = max(float(v.abs().max()) for v in mu_one.values())
        row = dict(grad_rel_err=_err(mu_dp, mu_one, top))
        worst = ptop = 0.0
        loose = total = 0
        if compute_dtype != "float32":
            ref = _grads(f32_one, net)
            f32_top = max(float(v.abs().max()) for v in ref.values())
            row.update(dp_vs_f32=_err(mu_dp, ref, f32_top),
                       one_vs_f32=_err(mu_one, ref, f32_top))
            unsigned = max(row["dp_vs_f32"], row["one_vs_f32"]) * f32_top + 1e-7
        for part in (params, "ema"):
            for k, v in getattr(one, part).items():
                if not k.startswith("generator/" if net == "g" else "discriminator/"):
                    continue
                d = (getattr(dp, part)[k] - v).abs()
                worst = max(worst, float(d.max()))
                ptop = max(ptop, float(v.abs().max()))
                if compute_dtype == "float32":
                    off = d > 1e-6 + 1e-4 * v.abs()
                    tiny = mu_one[k].abs() < 1e-7 * top
                else:
                    off = d > 0.5 * LR
                    tiny = ref[k].abs() <= unsigned
                ok &= not bool((off & ~tiny).any())
                loose += int(off.sum())
                total += v.numel()
        row.update(param_max_abs_diff=worst, param_max_abs=ptop, params=total)
        ok &= worst <= 2 * LR + 1e-6
        if compute_dtype == "float32":
            ok &= row["grad_rel_err"] <= 1e-4 and loose <= 1e-4 * total
            row["params_outside_rtol"] = loose
        else:
            ok &= row["dp_vs_f32"] <= BF16_GRAD_MARGIN * row["one_vs_f32"]
            row["params_beyond_half_lr"] = loose
        out[net] = row
    out["ok"] = bool(ok)
    return out


def _all_equal(value, mesh) -> bool:
    import torch.distributed as dist

    got = [None] * mesh.world_size
    dist.all_gather_object(got, value, group=mesh.host_group)
    return all(v == got[0] for v in got)


def host_ms(fn, reps=5) -> float:
    """Median wall time of `fn` between two device synchronisations."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def allreduce_ms(mesh, params) -> dict:
    """The step's all-reduce alone: G and D gradients' shapes (f32) plus the loss
    scalars, as one ``allreduce_mean_``."""
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    grads["step/losses"] = torch.ones(3, device=mesh.device)
    nbytes = sum(v.numel() * v.element_size() for v in grads.values())
    return dict(ms=host_ms(lambda: allreduce_mean_(dict(grads), mesh)), mbytes=nbytes / 1e6,
                backend=mesh.backend, transport=mesh.transport)


def dp_step(mesh, phase: int, batch: int, compute_dtype: str, steps: int, f32_one=None):
    """One data-parallel step against the one-process step on the global batch (rank
    0; `f32_one` the one-process f32 step's state, for bf16), the ranks' states
    compared, then `steps` chained steps timed.  Returns (report, the one-process
    step's state on rank 0, else None)."""
    dev = mesh.device
    cfg = bench_train_config(phase, batch, compute_dtype=compute_dtype)
    arch = get_architecture("pgan")
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=phase,
                                    cfg=cfg, device=dev)
    real = real_batch(cfg, phase, batch * mesh.world_size, dev)
    step = make_train_step(arch, cfg, phase, *opts, conv_engine="flat", mesh=mesh)
    new, metrics = step(state0, shard_rows(real, mesh), torch.Generator(dev).manual_seed(1),
                        ALPHA, LR, LR)
    report = dict(losses=[float(metrics.gen_loss), float(metrics.disc_loss),
                          float(metrics.gp_loss)])
    report["ranks_bit_equal_first"] = _all_equal(state_sha(new), mesh)
    if mesh.rank == 0:
        one = make_train_step(arch, cfg, phase, *opts, conv_engine="flat")
        ref, ref_m = one(state0, real, torch.Generator(dev).manual_seed(1), ALPHA, LR, LR)
        report["against_one_process"] = compare_states(new, ref, compute_dtype, f32_one)
        report["one_process_losses"] = [float(ref_m.gen_loss), float(ref_m.disc_loss),
                                        float(ref_m.gp_loss)]
    else:
        ref = None
    state = new
    gen = torch.Generator(dev).manual_seed(2)
    events = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, shard_rows(real, mesh), gen, ALPHA, LR, LR)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    report["step_ms"] = [s.elapsed_time(e) for s, e in events]
    report["ranks_bit_equal_after"] = _all_equal(state_sha(state), mesh)
    report["allreduce"] = allreduce_ms(mesh, {**state.g_params, **state.d_params})
    if mesh.rank == 0:  # the one-process step on one rank's rows, the others waiting
        plain = make_train_step(arch, cfg, phase, *opts, conv_engine="flat")
        mine = shard_rows(real, mesh)
        plain(state0, mine, gen, ALPHA, LR, LR)  # warm-up
        events = []
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain(state0, mine, gen, ALPHA, LR, LR)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        report["one_process_local_step_ms"] = [s.elapsed_time(e) for s, e in events]
    _all_equal(0, mesh)  # a barrier on the host group
    return report, ref


def halo(mesh, phase: int, batch: int) -> dict:
    """The depth-halo conv at phase `phase`'s last generator conv (f32) against kernel #1
    on the whole volume; #1's own numbers on this rank's extended slab."""
    dev = mesh.device
    cfg = bench_train_config(phase, batch)
    fs, ks = cfg.resolved_filter_spec(), cfg.resolved_kernel_spec()
    c, f = fs[phase - 1][0], fs[phase - 1][1]
    spatial = [d * 2 ** (phase - 1) for d in cfg.base_shape[1:]]
    kernel = tuple(ks[phase - 1][1])
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn((batch, c, *spatial), generator=g, device=dev)
    w = torch.randn((*kernel, c, f), generator=g, device=dev) * (2.0 / (c * np.prod(kernel))) ** 0.5
    depth = spatial[0] // mesh.world_size
    local = shard_rows(x.transpose(0, 2), mesh).transpose(0, 2).contiguous()
    with torch.no_grad():
        before = cf.conv3d_flat_cuda.launches
        y = halo_conv3d(local, w, mesh, engine="flat")
        launches = cf.conv3d_flat_cuda.launches - before
        whole = conv_apply(x, w, "flat")
        mine = whole[:, :, mesh.rank * depth:(mesh.rank + 1) * depth]
        scale = float(whole.abs().max())
        err = float((y - mine).abs().max())
        radius = kernel[0] // 2
        from saragan_tpu_torch.parallel.halo import _halo_exchange_depth

        x_ext = _halo_exchange_depth(local, radius, mesh)
        plain = cf.conv3d_flat_plain(x_ext, w)[:, :, radius:radius + depth]
        kern = cf.conv3d_flat_cuda(x_ext, w)[:, :, radius:radius + depth]
        kernel_err = float((kern - plain).abs().max())
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        halo_ms = host_ms(lambda: halo_conv3d(local, w, mesh, engine="flat"))
        whole_ms = time_ms(lambda: cf.conv3d_flat_cuda(x, w))
        local_ms = time_ms(lambda: cf.conv3d_flat_cuda(x_ext, w))
        plain_ms = time_ms(lambda: cf.conv3d_flat_plain(x_ext, w), reps=3, warmup=1)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            library_ms = time_ms(lambda: F.conv3d(x_ext, wt, padding=(0, kernel[1] // 2,
                                                                       kernel[2] // 2)))
    taps = int(np.prod(kernel))
    vox_out = depth * spatial[1] * spatial[2]
    vox_in = x_ext.shape[2] * spatial[1] * spatial[2]
    flop = 2 * batch * f * c * taps * vox_out
    t_bytes = (batch * c * vox_in + taps * c * f + batch * f * vox_out) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = flop / F32_FLOPS * 1e3
    ok = err <= 1e-5 * scale and kernel_err <= 1e-4 * float(plain.abs().max()) and launches > 0
    return dict(x=list(x.shape), w=list(w.shape), local=list(local.shape),
                extended=list(x_ext.shape), max_abs_err=err, scale=scale,
                bit_equal=bool(torch.equal(y, mine)), launches=launches, halo_ms=halo_ms,
                whole_ms=whole_ms, ok=bool(ok),
                kernel=dict(ms=local_ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=max(t_bytes, t_ops), t_bytes=t_bytes, t_ops=t_ops,
                            t_flop=flop, max_abs_err=kernel_err))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="every rank's card (default cuda:LOCAL_RANK)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_parallel: no CUDA device is available")
    mesh = init_mesh(args.device)
    try:
        report = dict(world=mesh.world_size, backend=mesh.backend, transport=mesh.transport,
                      device=str(mesh.device), card=torch.cuda.get_device_name(mesh.device))
        f32, f32_one = dp_step(mesh, PHASE, BATCH, "float32", STEPS)
        bf16, _ = dp_step(mesh, PHASE, BATCH, "bfloat16", STEPS, f32_one)
        report["steps"] = {"float32": f32, "bfloat16": bf16}
        report["halo"] = halo(mesh, PHASE, BATCH)
        failed = [k for k, v in report["steps"].items()
                  if not (v["ranks_bit_equal_first"] and v["ranks_bit_equal_after"]
                          and v.get("against_one_process", {"ok": True})["ok"])]
        if not report["halo"]["ok"]:
            failed.append("halo")
        failed_anywhere = any_rank(bool(failed), mesh)
        if mesh.rank == 0:
            line = json.dumps(report, default=str)
            print(line, flush=True)
            OUT.parent.mkdir(parents=True, exist_ok=True)
            OUT.write_text(line)
        if failed_anywhere:
            raise SystemExit(f"profile_parallel: rank {mesh.rank}: checks failed: {failed}")
    finally:
        mesh.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
