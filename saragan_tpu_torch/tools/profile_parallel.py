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
``chiprun_out/profile_parallel.json``; a failed check raises on every rank.

Spatial mode (``--space S [--space2 S2] [--phase P] [--f32_only | --bf16_only]
[--architecture A[,B..]] [--batch N] [--remat | --remat_offload |
--single_chip_big_volume] [--lever_check P2]``): the world is data x S x S2
(``init_mesh``), every volume's depth split over S ranks and its height over S2.  For
each family (default pgan) and for f32 (unless ``--bf16_only``) and bf16 (unless
``--f32_only``) the flagship step's configuration at phase P (default 6;
``bench_train_config``, N rows a data rank, default 8, under the memory lever given) runs
on each rank's rows and slab (``train.step.slab``) and rank 0 holds it against the
one-process step on the global batch from the same state and generator seed
(``compare_states(space=True)``: in f32 also against the same step with f64 activations,
``f64_witness``: the sharded f64 step within ``F64_GRAD_LIMIT`` of max of the one-process
f64 step's gradients, the f32 gradients within ``GRAD_LIMIT`` of max or
``SPACE_F32_MARGIN`` times f32's own distance from f64, parameters rtol 1e-4 / atol 1e-6
but where the gradient is within that limit of zero; bf16 at ``BF16_SPACE_GRAD_MARGIN``,
the other families at ``BF16_SPACE_FAMILY_GRAD_MARGIN``;
with ``--bf16_only`` rank 0 runs the one-process f32 step as bf16's reference); the
ranks' states bit-equal after it and after 3 more; #1 (forward and dgrad), #2 and #4's
launches in that step counted on each rank (set to 0 just before, read just after; #4 for
pgan, the one family that calls it) and every conv shape with its count
(rank 0's, for the kernels' own timing elsewhere), with the crop of each halo conv's
extended slab (for the kernels' bounds); the ms per step per rank (CUDA events), each
rank's peak device memory over the timed steps and the bytes its step parks in host
memory (``remat_offload``), and, in one more step with a device synchronisation around
each exchange (the halo exchanges and their adjoints, the slab gathers, the penalty's
space sum), the exchanges' host seconds against that step's.  ``--lever_check P2``:
first, in f32 and bf16, the flagship step at phase P2 (8 rows a data rank) sharded under
``remat`` and under ``remat_offload`` from the same state and draws, bit-equal to the
sharded plain step on every rank.  Written to ``--out`` (default
``chiprun_out/profile_parallel_space.json``). No number here is a multi-card speed-up:
ranks sharing one card measure the protocol's cost.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.ops.core import conv_apply
from saragan_tpu_torch.parallel import (allreduce_mean_, any_rank, halo, halo_conv3d,
                                        init_mesh, shard_rows)
from saragan_tpu_torch.tools.profile_serving import time_ms
from saragan_tpu_torch.tools.profile_training import bench_train_config, real_batch
from saragan_tpu_torch.train.step import init_train_state, make_train_step, slab

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA data sheet), as chip_smoke.py
F32_FLOPS = 67e12
LR = 1e-3
# bf16: how much farther from the f32 step the data-parallel gradient may be than the
# one-process bf16 gradient is.  Measured on an H100 (every run alike): G 3.05e-3 against
# 2.60e-3 of max (1.17x), D 4.07e-2 against 4.07e-2 (1.00x)
BF16_GRAD_MARGIN = 1.5
# the same for the spatially sharded step, whose slab-edge input gradients also sum two
# bf16-rounded partial dgrads (the halo's adjoint; every voxel is an edge at 4 x 16^2 and
# below).  Measured on an H100 at phase 6, depth 16 + 16, in two runs of the same code
# (the kernels are deterministic: the readings are equal to the bit): G 5.82e-3 against
# 3.63e-3 of max (1.61x), D 5.63e-2 against 4.15e-2 (1.35x)
BF16_SPACE_GRAD_MARGIN = 2.0
# the same for the other families' sharded steps (surfgan, the one they run in bf16 on the
# card): each rank rounds its slab's partial gradient of the 1x1 modulated RGB convs (and
# of the constant input) to bf16 before the f32 sum.  Measured on an H100 at phase 6,
# depth 16 + 16: G 5.35e-2 against 2.51e-2 of max (2.13x; the worst entry to_rgb_5's
# weight, 2.26x its one-process distance), D 1.17e-1 against 1.03e-1 (1.13x); the same
# step with f64 activations lies 6.4e-8 (G) and 7.5e-8 (D) of max from one process's
BF16_SPACE_FAMILY_GRAD_MARGIN = 2.5
# f32: each network's gradients within this fraction of its largest from the one-process
# step's
GRAD_LIMIT = 1e-4
# f32, spatial step: or within this many times the one-process f32 step's own distance
# from the same step with f64 activations, f32's rounding of this step.  Measured on an
# H100 at phase 5, space 2 and space 2 x space2 2 alike (two runs each, equal to the
# bit): D 1.52e-4 of max from the one-process f32 step, which lies 7.03e-5 from f64
# (2.2x; the sharded f32 step 1.52e-4 from f64); G 2.95e-5, within GRAD_LIMIT
SPACE_F32_MARGIN = 3.0
# the sharded step with f64 activations against the one-process f64 step: the sharded
# path's own error (the gradient is stored in f32).  Measured on an H100 at phases 5 and
# 6: 2.6e-8 to 1.0e-7 of max
F64_GRAD_LIMIT = 1e-6
# f32, spatial step: the parameters off rtol 1e-4 / atol 1e-6 (all where the gradient is
# within the gradient limit of zero) may be at most this fraction of the entries.
# Measured (two runs each, equal): G 1052 of 7.40e6 (1.4e-4) at phase 6 over two
# ranks, 2038 of 7.36e6 (2.8e-4) at phase 5 over 2 x 2; D 29 and 49
SPACE_LOOSE_SHARE = 1e-3
ALPHA = 0.5
PHASE, BATCH, STEPS = 6, 8, 3  # the flagship step's phase and rows per rank; timed steps
LEVERS = ("remat", "remat_offload", "single_chip_big_volume")
OUT = Path("chiprun_out") / "profile_parallel.json"
OUT_SPACE = Path("chiprun_out") / "profile_parallel_space.json"


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


def _worst(a, b, top, n=4):
    """The `n` entries of `a` farthest from `b`'s, as (name, distance over `top`)."""
    errs = sorted(((float((a[k] - v).abs().max()) / top, k) for k, v in b.items()),
                  reverse=True)[:n]
    return [(k, e) for e, k in errs]


def compare_states(dp, one, compute_dtype: str, f32_one=None, space: bool = False,
                   f64=None, family: bool = False) -> dict:
    """The data-parallel step's state `dp` against the one-process step's `one` (both
    from one state; Adam with beta1 0, so the first moment is the gradient).

    f32: parameters and EMA within rtol 1e-4 / atol 1e-6 but for entries whose gradient is
    below 1e-7 of the network's largest (Adam's step there is set by the rounding of a
    gradient under its eps), those within 2 lr and fewer than 1e-4 of the entries; each
    network's gradients within ``GRAD_LIMIT`` of its largest.  With `space` (the spatially
    sharded step, whose gradients differ by more than 1e-7 of max: its slabs' partial
    sums meet in other orders, and the penalty's (|g| - 1) amplifies that) and `f64`
    (``f64_witness``'s): the sharded f64 step within ``F64_GRAD_LIMIT`` of the one-process
    f64 step, and the gradient limit the larger of ``GRAD_LIMIT`` and
    ``SPACE_F32_MARGIN`` times the one-process f32 step's distance from f64; the
    exception is every entry whose gradient is within that limit of max of zero, where a
    gradient that meets the limit may have the other sign, so that Adam's step of about
    lr sign(g) is not determined: those within 2 lr and fewer than
    ``SPACE_LOOSE_SHARE`` of the entries.
    bf16: the gradients no farther from the one-process f32 step's `f32_one` than
    ``BF16_GRAD_MARGIN`` times the one-process bf16 step's are (bf16 rounds each rank's
    partial sums, so the data-parallel gradient is another bf16 rounding of the same sum);
    parameters and EMA within lr / 2 of the one-process bf16 step's but where the f32
    gradient is within those gradient errors (plus 1e-7) of zero, so that its sign, and
    so Adam's step of about lr sign(g) at beta1 0, is not determined in bf16: those within
    2 lr; with `space` the margin is ``BF16_SPACE_GRAD_MARGIN``, for a `family` other than
    pgan ``BF16_SPACE_FAMILY_GRAD_MARGIN``.  Every "within 2 lr"
    allows each parameter its own f32 rounding, twice (2 lr + 2^-22 |w|).  Returns the measured
    errors, the entries off their limit where the sign is determined (``determined_off``,
    which must be 0) and whether every limit held."""
    out, ok = {}, True
    margin = ((BF16_SPACE_FAMILY_GRAD_MARGIN if family else BF16_SPACE_GRAD_MARGIN) if space
              else BF16_GRAD_MARGIN)
    for net, params in (("g", "g_params"), ("d", "d_params")):
        mu_dp, mu_one = _grads(dp, net), _grads(one, net)
        top = max(float(v.abs().max()) for v in mu_one.values())
        row = dict(grad_rel_err=_err(mu_dp, mu_one, top), worst=_worst(mu_dp, mu_one, top))
        limit = GRAD_LIMIT
        if f64 is not None:
            limit = max(GRAD_LIMIT, SPACE_F32_MARGIN * f64[net]["one_process_f32"])
            ok &= f64[net]["sharded_f64"] <= F64_GRAD_LIMIT
        worst = ptop = 0.0
        past_2lr = -1.0
        loose = total = determined_off = 0
        unsigned = limit * top
        if compute_dtype != "float32":
            ref = _grads(f32_one, net)
            f32_top = max(float(v.abs().max()) for v in ref.values())
            row.update(dp_vs_f32=_err(mu_dp, ref, f32_top),
                       one_vs_f32=_err(mu_one, ref, f32_top),
                       worst_dp_vs_f32=_worst(mu_dp, ref, f32_top),
                       worst_one_vs_f32=_worst(mu_one, ref, f32_top))
            unsigned = max(row["dp_vs_f32"], row["one_vs_f32"]) * f32_top + 1e-7
        for part in (params, "ema"):
            for k, v in getattr(one, part).items():
                if not k.startswith("generator/" if net == "g" else "discriminator/"):
                    continue
                d = (getattr(dp, part)[k] - v).abs()
                worst = max(worst, float(d.max()))
                # two Adam steps of about lr apart, each result rounded to f32 at the
                # parameter's own magnitude (the style mappings' lrmul-0.01 weights reach
                # |w| ~ 500, where f32's spacing is 6e-5)
                past_2lr = max(past_2lr, float((d - 2 * LR - 1e-6 - 2 ** -22 * v.abs()).max()))
                ptop = max(ptop, float(v.abs().max()))
                if compute_dtype == "float32":
                    off = d > 1e-6 + 1e-4 * v.abs()
                    tiny = (mu_one[k].abs() <= unsigned if space
                            else mu_one[k].abs() < 1e-7 * top)
                else:
                    off = d > 0.5 * LR
                    tiny = ref[k].abs() <= unsigned
                determined_off += int((off & ~tiny).sum())
                loose += int(off.sum())
                total += v.numel()
        row.update(param_max_abs_diff=worst, param_max_abs=ptop, params=total,
                   determined_off=determined_off, past_2lr=past_2lr)
        ok &= past_2lr <= 0 and determined_off == 0
        if compute_dtype == "float32":
            share = SPACE_LOOSE_SHARE if space else 1e-4
            ok &= row["grad_rel_err"] <= limit and loose <= share * total
            row.update(params_outside_rtol=loose, grad_limit=limit)
        else:
            ok &= row["dp_vs_f32"] <= margin * row["one_vs_f32"]
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


def halo_report(mesh, phase: int, batch: int) -> dict:
    """The depth-halo conv at phase `phase`'s last generator conv (f32) against kernel #1
    on the whole volume; #1's own numbers on this rank's extended slab.  `mesh`: every rank
    a depth slab (data 1 x space W)."""
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
    local = halo.take_slab(x, mesh)
    with torch.no_grad():
        before = cf.conv3d_flat_cuda.launches
        y = halo_conv3d(local, w, mesh, engine="flat")
        launches = cf.conv3d_flat_cuda.launches - before
        whole = conv_apply(x, w, "flat")
        mine = whole[:, :, mesh.rank * depth:(mesh.rank + 1) * depth]
        scale = float(whole.abs().max())
        err = float((y - mine).abs().max())
        radius = kernel[0] // 2
        x_ext = halo.halo_exchange(local, radius, mesh, 2)
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


KINDS = ("forward", "dgrad", "wgrad", "fused", "fused_grad", "plain")


def zero_counts():
    for fn in (cf.conv3d_flat_cuda, cf.conv3d_flat_wgrad_cuda):
        fn.launches = 0
        fn.by_shape.clear()
    fba.fused_bias_act_pixelnorm.launches = 0
    fba.fused_bias_act_pixelnorm_grad.launches = 0
    for fn in (cf.conv3d_flat_plain, cf.conv3d_flat_wgrad_plain, fba.bias_act_pixelnorm_plain,
               fba.bias_act_pixelnorm_grad_plain):
        fn.calls = 0


def read_counts() -> dict:
    roles = {"forward": 0, "dgrad": 0}
    for (role, *_), n in cf.conv3d_flat_cuda.by_shape.items():
        roles[role] += n
    return dict(roles, wgrad=cf.conv3d_flat_wgrad_cuda.launches,
                fused=fba.fused_bias_act_pixelnorm.launches,
                fused_grad=fba.fused_bias_act_pixelnorm_grad.launches,
                plain=(cf.conv3d_flat_plain.calls + cf.conv3d_flat_wgrad_plain.calls
                       + fba.bias_act_pixelnorm_plain.calls
                       + fba.bias_act_pixelnorm_grad_plain.calls))


def _gathered(value, mesh):
    import torch.distributed as dist

    got = [None] * mesh.world_size
    dist.all_gather_object(got, value, group=mesh.host_group)
    return got


class _ExchangeClock:
    """Host seconds inside the exchanges (``parallel.halo``'s point-to-point halos and
    their adjoints, the slab gathers, the space sums and all-reduces), each bracketed by device
    synchronisations so that its time is its own."""

    NAMES = ("_exchange", "_exchange_adjoint", "_gather_axis", "space_sum", "space_allreduce")

    def __init__(self):
        self.seconds, self.calls, self._saved = 0.0, 0, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(halo, name)
            self._saved[name] = fn

            def timed(*a, _fn=fn, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out

            setattr(halo, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(halo, name, fn)


class _HaloCrops:
    """The extended slabs of ``halo_conv3d``'s convs under ``flat`` in a step: {(the
    slab's spatial shape, the kernel): [depth, height] slices cropped at each end}, the
    part of #1, #1' and #2's work at those shapes that the step drops."""

    def __init__(self, mesh):
        self.mesh, self.crops, self._saved = mesh, {}, None

    def __enter__(self):
        self._saved = apply = halo.conv_apply

        def recorded(x, w, engine):
            kernel = tuple(int(k) for k in w.shape[:3])
            radii = [kernel[a - 2] // 2 if self.mesh.axis_size(a) > 1 else 0 for a in (2, 3)]
            self.crops[(tuple(x.shape[2:]), kernel)] = radii
            return apply(x, w, engine)

        halo.conv_apply = recorded
        return self

    def __exit__(self, *exc):
        halo.conv_apply = self._saved


def space_step(mesh, phase: int, batch: int, compute_dtype: str, steps: int, f32_one=None,
               arch_name: str = "pgan", levers=None):
    """The spatially sharded step of `arch_name` (the flagship's configuration under the
    memory `levers`) against the one-process step on the global batch (rank 0), as the
    module says.  Returns (report, rank 0's one-process state)."""
    dev = mesh.device
    levers = levers or {}
    cfg = bench_train_config(phase, batch, compute_dtype=compute_dtype,
                             architecture=arch_name, **levers)
    arch = get_architecture(arch_name)
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=phase,
                                    cfg=cfg, device=dev)
    real = real_batch(cfg, phase, batch * mesh.data_size, dev)
    step = make_train_step(arch, cfg, phase, *opts, conv_engine="flat", mesh=mesh)
    if step.space is None:
        raise RuntimeError(f"phase {phase} does not split over {mesh.describe()}")
    mine = slab(shard_rows(real, mesh), step)
    zero_counts()  # the main path: counts set to 0 just before, read just after
    with _HaloCrops(mesh) as halos:
        new, metrics = step(state0, mine, torch.Generator(dev).manual_seed(1), ALPHA, LR, LR)
    torch.cuda.synchronize()
    counts = read_counts()
    shapes = dict(conv=[[list(k), n] for k, n in cf.conv3d_flat_cuda.by_shape.items()],
                  wgrad=[[list(k), n] for k, n in cf.conv3d_flat_wgrad_cuda.by_shape.items()],
                  halo_crops=[[list(k), r] for k, r in halos.crops.items()])
    report = dict(architecture=arch_name, levers=sorted(levers),
                  losses=[float(metrics.gen_loss), float(metrics.disc_loss),
                          float(metrics.gp_loss)], slab=list(mine.shape),
                  launches_by_rank=_gathered(counts, mesh), shapes=shapes,
                  needs_fused=bool(cfg.use_pallas_fusion and arch_name == "pgan"))
    report["ranks_bit_equal_first"] = _all_equal(state_sha(new), mesh)
    ref = None
    if mesh.rank == 0:
        one = make_train_step(arch, cfg, phase, *opts, conv_engine="flat")
        ref, ref_m = one(state0, real, torch.Generator(dev).manual_seed(1), ALPHA, LR, LR)
        report["one_process_losses"] = [float(ref_m.gen_loss), float(ref_m.disc_loss),
                                        float(ref_m.gp_loss)]
        if compute_dtype != "float32" and f32_one is None:  # bf16's reference
            c32 = bench_train_config(phase, batch, compute_dtype="float32",
                                     architecture=arch_name, **levers)
            f32_one, _ = make_train_step(arch, c32, phase, *opts, conv_engine="flat")(
                state0, real, torch.Generator(dev).manual_seed(1), ALPHA, LR, LR)
    if compute_dtype == "float32":
        report["f64"] = f64_witness(mesh, phase, batch, real, new, ref, arch_name, levers)
    if mesh.rank == 0:
        report["against_one_process"] = compare_states(new, ref, compute_dtype, f32_one,
                                                       space=True, f64=report.get("f64"),
                                                       family=arch_name != "pgan")
    f32_one = None
    torch.cuda.empty_cache()
    state, gen, events = new, torch.Generator(dev).manual_seed(2), []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, mine, gen, ALPHA, LR, LR)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    report["step_ms"] = [s.elapsed_time(e) for s, e in events]
    report["memory_by_rank"] = _gathered(dict(
        peak_mib=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
        parked_mib=step.parked_bytes / 2 ** 20), mesh)
    report["ranks_bit_equal_after"] = _all_equal(state_sha(state), mesh)
    with _ExchangeClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, mine, gen, ALPHA, LR, LR)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    report["exchanges"] = dict(calls=clock.calls, ms=1e3 * clock.seconds,
                               instrumented_step_ms=1e3 * step_s,
                               share=clock.seconds / step_s)
    _all_equal(0, mesh)  # a barrier on the host group
    return report, ref


def lever_check(mesh, phase: int, batch: int, compute_dtype: str, arch_name: str = "pgan"):
    """The sharded step under ``remat`` and under ``remat_offload``, from one state and
    generator seed, against the sharded plain step: {lever: bit-equal on every rank}, and
    the bytes the offload step parked on this rank."""
    dev = mesh.device
    cfg = bench_train_config(phase, batch, compute_dtype=compute_dtype,
                             architecture=arch_name)
    arch = get_architecture(arch_name)
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=phase,
                                    cfg=cfg, device=dev)
    real = real_batch(cfg, phase, batch * mesh.data_size, dev)
    shas, parked = {}, {}
    for name, lever in (("plain", {}), ("remat", dict(remat=True)),
                        ("remat_offload", dict(remat_offload=True))):
        c = dataclasses.replace(cfg, **lever)
        step = make_train_step(arch, c, phase, *opts, conv_engine="flat", mesh=mesh)
        new, _ = step(state0, slab(shard_rows(real, mesh), step),
                      torch.Generator(dev).manual_seed(1), ALPHA, LR, LR)
        shas[name] = state_sha(new)
        parked[name] = step.parked_bytes / 2 ** 20
    equal = {k: v == shas["plain"] for k, v in shas.items() if k != "plain"}
    return dict(phase=phase, dtype=compute_dtype, bit_equal=equal,
                bit_equal_all_ranks=all(_gathered(all(equal.values()), mesh)),
                ranks_equal=_all_equal(shas["plain"], mesh),
                parked_mib_by_rank=_gathered(parked["remat_offload"], mesh))


def f64_witness(mesh, phase: int, batch: int, real, sharded32, one32, arch_name="pgan",
                levers=None) -> dict:
    """The f32 steps' gradients against the same step with f64 activations (under the
    library conv and the fused op's plain version; f32 parameters and state, the same
    draws): each network's distance, as a fraction of its largest gradient, of the
    sharded f32 step (`sharded32`), the one-process f32 step (`one32`, rank 0's) and the
    sharded f64 step from the one-process f64 step.  The last is the sharded path's own
    error; the one-process f32 step's is f32's.  Every rank runs the sharded step; the
    result is rank 0's (None elsewhere)."""
    dev = mesh.device
    cfg = bench_train_config(phase, batch, compute_dtype="float64", use_pallas_fusion=False,
                             architecture=arch_name, **(levers or {}))
    arch = get_architecture(arch_name)
    state0, opts = init_train_state(arch, torch.Generator().manual_seed(0), phase=phase,
                                    cfg=cfg, device=dev)
    step = make_train_step(arch, cfg, phase, *opts, conv_engine="direct", mesh=mesh)
    sharded64, _ = step(state0, slab(shard_rows(real, mesh), step),
                        torch.Generator(dev).manual_seed(1), ALPHA, LR, LR)
    if mesh.rank != 0:
        return None
    one = make_train_step(arch, cfg, phase, *opts, conv_engine="direct")
    one64, _ = one(state0, real, torch.Generator(dev).manual_seed(1), ALPHA, LR, LR)
    out = {}
    for net in ("g", "d"):
        truth = _grads(one64, net)
        top = max(float(v.abs().max()) for v in truth.values())
        out[net] = {name: _err(_grads(st, net), truth, top) for name, st in
                    (("sharded_f32", sharded32), ("one_process_f32", one32),
                     ("sharded_f64", sharded64))}
    return out


def space_main(args) -> int:
    mesh = init_mesh(args.device, num_space=args.space, num_space2=args.space2)
    levers = {k: True for k in LEVERS if getattr(args, k)}
    dtypes = (["float32"] if not args.bf16_only else []) + ([] if args.f32_only
                                                              else ["bfloat16"])
    try:
        report = dict(world=mesh.world_size, layout=[mesh.data_size, mesh.num_space,
                                                     mesh.num_space2],
                      backend=mesh.backend, transport=mesh.transport, phase=args.phase,
                      batch=args.batch, levers=sorted(levers), device=str(mesh.device),
                      card=torch.cuda.get_device_name(mesh.device), runs={})
        if args.lever_check is not None:
            report["lever_check"] = [lever_check(mesh, args.lever_check, BATCH, dt)
                                     for dt in ("float32", "bfloat16")]
        for arch_name in args.architecture.split(","):
            steps, f32_one = {}, None
            for dt in dtypes:
                steps[dt], one = space_step(mesh, args.phase, args.batch, dt, STEPS, f32_one,
                                            arch_name, levers)
                f32_one = one if dt == "float32" else None
            report["runs"][arch_name] = steps
        report["steps"] = report["runs"][args.architecture.split(",")[0]]
        failed = [f"{a} {k}" for a, steps in report["runs"].items() for k, v in steps.items()
                  if not (v["ranks_bit_equal_first"] and v["ranks_bit_equal_after"]
                          and v.get("against_one_process", {"ok": True})["ok"]
                          and all(min(c[k] for k in KINDS[:5 if v["needs_fused"] else 3]) > 0
                                  and c["plain"] == 0 for c in v["launches_by_rank"]))]
        failed += [f"lever_check {c['dtype']}" for c in report.get("lever_check", [])
                   if not (c["bit_equal_all_ranks"] and c["ranks_equal"])]
        failed_anywhere = any_rank(bool(failed), mesh)
        if mesh.rank == 0:
            line = json.dumps(report, default=str)
            print(line, flush=True)
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(line)
        if failed_anywhere:
            raise SystemExit(f"profile_parallel: rank {mesh.rank}: checks failed: {failed}")
    finally:
        mesh.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="every rank's card (default cuda:LOCAL_RANK)")
    p.add_argument("--space", type=int, default=1, help="depth shards: the spatial mode")
    p.add_argument("--space2", type=int, default=1, help="height shards (spatial mode)")
    p.add_argument("--phase", type=int, default=PHASE, help="the spatial mode's phase")
    p.add_argument("--f32_only", action="store_true", help="spatial mode: no bf16 step")
    p.add_argument("--bf16_only", action="store_true",
                   help="spatial mode: no sharded f32 step (rank 0's one-process f32 step "
                        "is bf16's reference)")
    p.add_argument("--architecture", default="pgan",
                   help="spatial mode: the families, comma-separated")
    p.add_argument("--batch", type=int, default=BATCH, help="spatial mode: rows a data rank")
    for lever in LEVERS:
        p.add_argument(f"--{lever}", action="store_true",
                       help=f"spatial mode: the step under {lever}")
    p.add_argument("--lever_check", type=int, default=None, metavar="PHASE",
                   help="spatial mode: first the flagship step at PHASE under remat and "
                        "remat_offload bit-equal to the plain step, f32 and bf16")
    p.add_argument("--out", default=str(OUT_SPACE), help="the spatial mode's JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_parallel: no CUDA device is available")
    if args.space > 1 or args.space2 > 1:
        return space_main(args)
    mesh = init_mesh(args.device)
    try:
        report = dict(world=mesh.world_size, backend=mesh.backend, transport=mesh.transport,
                      device=str(mesh.device), card=torch.cuda.get_device_name(mesh.device))
        f32, f32_one = dp_step(mesh, PHASE, BATCH, "float32", STEPS)
        bf16, _ = dp_step(mesh, PHASE, BATCH, "bfloat16", STEPS, f32_one)
        report["steps"] = {"float32": f32, "bfloat16": bf16}
        report["halo"] = halo_report(init_mesh(args.device, num_space=mesh.world_size,
                                               verbose=False), PHASE, BATCH)
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
