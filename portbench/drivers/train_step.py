"""Driver of the ``train_step`` traffic kind: the port's train step at one phase and batch.

Parameters (the traffic file): ``phase``, ``batch``, ``volume_scale`` and ``volume_offset``
(the ranges of each real volume's scale, log-uniform, and offset), ``alpha_start`` (the
mixing half's alpha at the first step, stepped down after each mixing step as the trainer
steps it), ``inputs`` (how many distinct batches and draws the steps cycle through),
``profile_steps`` (per half, in a ``--trace 1`` run) and ``host_steps`` (per half, for the
host's enqueue time).

Set-up builds the one state the window trains: the weights drawn on the card from the
seed (N(0, 1 / lrmul), as the equalized learning rate stores them: 100 for the style
mapping's; biases, noise strengths and the w-average at 0.1), the optimizer state and the
EMA, and the steps as the port's trainer builds them (``Trainer._run_phase``): the mixing
step with the previous phase's names frozen and alpha as a number, the stabilizing step at
static alpha 0, under the trainer's conv engine for the device.  The batches (volumes in the
compute dtype, each with its scale and offset) and every draw of a step (``losses.Draws``:
latents, the penalty's weights, and for a style family its mixing draws, refresh latents
and per-layer noise) are drawn on the card from the seed.  The first four steps
(stabilizing, mixing, mixing, stabilizing) warm both steps and are the ones the reference
follows (three of them): the gradients of steps 1 and 2 as Adam's first moments hold them,
and the parameters and EMA after steps 1 and 3, kept on the host (``compare.Trail``); the
window then runs the mixing step for its first half and the stabilizing step for the
second, on the same state, and is timed over all its steps.  The reference runs once the
window has closed and the program's state is freed.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import statistics
import time
from typing import Dict

import torch

from portbench import PROCESS_START, compare, counts, peaks
from portbench import trace as tr
from portbench.reference import train as rt
from portbench.reference.ops import Params

# set-up's steps: the first, a stabilizing step, leaves no name frozen, so its gradient
# reaches every leaf; then the mixing step twice (the previous phase's names frozen)
FIRST_STEPS = ("stab", "mix", "mix", "stab")
SMALL = ("bias", "noise_strength", "d_z_avg")  # drawn at a tenth of the weights' scale
# weights whose layer scales them by a learning-rate multiplier at use are stored
# N(0, 1 / lrmul), as the equalized learning rate stores them: the style mapping's (0.01)
LRMUL = (("/g_mapping/", 0.01),)


def port_config(config: dict, phase: int):
    """The port's ``Config`` of a configuration file's fields at `phase`: past the final
    shape's phases the final shape doubles until it holds `phase`, as the port's
    profiling tool builds its phase-8 step (the model at a phase does not depend on the
    final shape)."""
    from saragan_tpu_torch.config import Config, parse_tuple

    fields = dict(config)
    final = list(parse_tuple(fields["final_shape"]))
    cfg = Config(**fields)
    while cfg.num_phases < phase:
        final = [final[0]] + [2 * d for d in final[1:]]
        cfg = dataclasses.replace(cfg, final_shape=str(tuple(final)))
    return dataclasses.replace(cfg, starting_phase=phase, ending_phase=phase).finalize()


def weight_scale(name: str) -> float:
    """The standard deviation a parameter is drawn with (module docstring)."""
    if name.endswith(SMALL):
        return 0.1
    for part, lrmul in LRMUL:
        if part in name and name.endswith("/weight"):
            return 1.0 / lrmul
    return 1.0


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from one N(0, 1) draw on `device` (sorted by name), scaled by
    ``weight_scale``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    names = sorted(shapes)
    sizes = [max(1, int(torch.Size(shapes[k]).numel())) for k in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(names, flat.split(sizes)):
        out[k] = (part * weight_scale(k)).reshape(shapes[k]).clone()
    return out


def noise_shapes(ref_cfg: dict, phase: int, batch: int) -> Dict[str, tuple]:
    """The per-layer noise a style generator asks for at `batch`: {name: shape}."""
    seen = {}

    def record(name, shape):
        seen[name] = tuple(shape)
        return torch.zeros(shape, device="meta")

    shapes = rt.param_shapes(ref_cfg, phase)
    params = {k: torch.zeros(s, device="meta") for k, s in shapes.items()}
    rt.ARCHS[ref_cfg["architecture"]].generator(
        Params(params), torch.zeros((batch, ref_cfg["latent_dim"]), device="meta"), 0.0,
        phase=phase, cfg=ref_cfg, noise=record)
    return seen


def make_inputs(ref_cfg: dict, cfg, phase: int, batch: int, n: int, dtype, seed: int, device,
                scale=(1.0, 1.0), offset=(0.0, 0.0)):
    """`n` (real batch, reference draws) pairs drawn on `device` from the seed.  Each
    volume is N(offset, scale^2), its scale log-uniform in `scale` and its offset uniform
    in `offset` (volumes of one batch differ in contrast and level, as CT volumes do)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    shape = cfg.current_shape(phase, batch)
    latent = cfg.latent_dim
    style = ref_cfg["architecture"] == "surfgan"
    noise = noise_shapes(ref_cfg, phase, batch) if style else {}
    log_lo, log_hi = math.log(scale[0]), math.log(scale[1])
    row = (batch,) + (1,) * (len(shape) - 1)
    out = []
    for _ in range(n):
        s = torch.exp(log_lo + (log_hi - log_lo) * torch.rand(row, generator=gen, device=device))
        m = offset[0] + (offset[1] - offset[0]) * torch.rand(row, generator=gen, device=device)
        real = (torch.randn(shape, generator=gen, device=device) * s + m).to(dtype)
        z = torch.randn((batch, latent), generator=gen, device=device).to(dtype)
        gamma = torch.rand((batch, 1, 1, 1, 1), generator=gen, device=device).to(dtype)
        draws = rt.Draws(z=z, gamma=gamma)
        if style:
            draws = draws._replace(
                z_mix=torch.randn((batch, latent), generator=gen, device=device).to(dtype),
                mix_coin=torch.rand((), generator=gen, device=device),
                mix_cutoff=torch.randint(1, max(phase, 2), (), generator=gen, device=device),
                refresh_z=torch.randn((64, latent), generator=gen, device=device),
                noise={k: torch.randn(s, generator=gen, device=device).to(dtype)
                       for k, s in sorted(noise.items())})
        out.append((real, draws))
    return out


def volume_spread(t: dict) -> dict:
    """The traffic's per-volume scale and offset ranges (none: N(0, 1) volumes)."""
    return dict(scale=tuple(t.get("volume_scale", (1.0, 1.0))),
                offset=tuple(t.get("volume_offset", (0.0, 0.0))))


def port_draws(d: rt.Draws):
    from saragan_tpu_torch import losses
    from saragan_tpu_torch.ops.core import NoiseByName

    return losses.Draws(d.z, d.gamma, None, None, d.z_mix, d.mix_coin, d.mix_cutoff,
                        d.refresh_z, None if d.noise is None else NoiseByName(d.noise))


def alpha_delta(cfg, batch: int) -> float:
    """How far alpha falls after each mixing step, as the trainer steps it."""
    return cfg.starting_alpha / max(1, cfg.mixing_nimg // batch)


def first_halves(cfg, t: dict):
    """(half, alpha) of the first three steps."""
    delta = alpha_delta(cfg, int(t["batch"]))
    alpha, out = float(t["alpha_start"]), []
    for half in FIRST_STEPS[:3]:
        out.append((half, alpha if half == "mix" else 0.0))
        if half == "mix":
            alpha = max(alpha - delta, 0.0)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _keep(tree):
    """A copy of `tree` on the host: what the check keeps stays out of the card's peak."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def run(cell, seed: int, seconds: float, trace: bool, device=None) -> dict:
    """One run of a ``train_step`` cell; see ``portbench/run.py`` for the result."""
    from saragan_tpu_torch.config import resolve_ops
    from saragan_tpu_torch.models import get_architecture
    from saragan_tpu_torch.optim.ema import ema_init
    from saragan_tpu_torch.optim.factory import make_optimizers_from_config
    from saragan_tpu_torch.optim.freeze import apply_freeze_names
    from saragan_tpu_torch.train.step import TrainState, compute_dtype, make_train_step

    marks, t_mark = {"imports": time.time() - PROCESS_START}, [time.time()]

    def mark(name):
        now = time.time()
        marks[name] = now - t_mark[0]
        t_mark[0] = now

    t = cell.traffic
    phase, batch = int(t["phase"]), int(t["batch"])
    dev = torch.device(device or "cuda")
    cfg = port_config(cell.config["config"], phase)
    ref_cfg = rt.model_cfg(cell.config["config"])
    dtype = compute_dtype(cfg)
    arch = get_architecture(cfg.architecture)

    shapes = rt.param_shapes(ref_cfg, phase)
    port_shapes = {k: tuple(v.shape) for k, v in arch.init(
        torch.Generator().manual_seed(0), phase=phase, cfg=cfg, device="meta").items()}
    if port_shapes != shapes:
        raise RuntimeError(f"the port's parameters differ from the reference's: "
                           f"{sorted(set(port_shapes.items()) ^ set(shapes.items()))[:4]}")
    params = make_weights(shapes, seed, dev)
    theta0 = _keep(params)
    g_opt, d_opt = make_optimizers_from_config(cfg)
    g = {k: v for k, v in params.items() if k.startswith("generator/")}
    d = {k: v for k, v in params.items() if k.startswith("discriminator/")}
    state = TrainState(g, d, g_opt.init(g), d_opt.init(d), ema_init(params))
    del params
    prev = arch.init(torch.Generator().manual_seed(0), phase=phase - 1, cfg=cfg, device="meta")
    frozen = apply_freeze_names(theta0, prev) if cfg.mixing_nimg > 0 else frozenset()
    ops = resolve_ops(cfg, dev.type)
    steps = {
        "mix": make_train_step(arch, cfg, phase, g_opt, d_opt, frozen_names=frozen,
                               freeze=bool(frozen), static_alpha=None, conv_engine=ops),
        "stab": make_train_step(arch, cfg, phase, g_opt, d_opt, static_alpha=0.0,
                                conv_engine=ops),
    }
    mark("state and steps")
    inputs = make_inputs(ref_cfg, cfg, phase, batch, int(t["inputs"]), dtype, seed, dev,
                         **volume_spread(t))
    _sync(dev)
    mark("inputs")
    feed = [(real, port_draws(dr)) for real, dr in inputs]
    delta = alpha_delta(cfg, batch)
    alpha = [float(t["alpha_start"])]  # the mixing half's alpha
    count = [0]

    def one(half: str):
        real, draws = feed[count[0] % len(feed)]
        a = alpha[0] if half == "mix" else 0.0
        new, metrics = steps[half](state_box[0], real, None, a, cfg.g_lr, cfg.d_lr,
                                   draws=draws)
        state_box[0] = new
        if half == "mix":
            alpha[0] = max(alpha[0] - delta, 0.0)
        count[0] += 1
        return a, metrics

    state_box = [state]
    del state
    # the first steps: both steps warm, and the reference follows the first three
    first, b1 = [], g_opt.b1

    def moments():
        st = state_box[0]
        return {**st.g_opt.mu, **st.d_opt.mu}

    for i, half in enumerate(FIRST_STEPS):
        a, m = one(half)
        first.append((half, a, (m.gen_loss, m.disc_loss, m.gp_loss)))
        _sync(dev)
        mark(f"step {i + 1}")
        st = state_box[0]
        if i == 0:  # Adam's first moment after one step is (1 - b1) g
            mu1 = _keep(moments())
            grad1 = {k: v / (1.0 - b1) for k, v in mu1.items()}
            theta1, ema1 = _keep({**st.g_params, **st.d_params}), _keep(st.ema)
        if i == 1:  # and after the second b1 mu1 + (1 - b1) g2
            grad2 = {k: (v - b1 * mu1[k]) / (1.0 - b1) for k, v in _keep(moments()).items()}
            del mu1
        if i == 2:
            theta3, ema3 = _keep({**st.g_params, **st.d_params}), _keep(st.ema)
        del st
    _sync(dev)
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # the window
    window_start = time.time()
    t0 = time.perf_counter()
    done = collections.Counter()
    inflight = collections.deque()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        half = "mix" if elapsed < seconds / 2 else "stab"
        one(half)
        done[half] += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > 2:
                inflight.popleft().synchronize()
    _sync(dev)
    window_s = time.perf_counter() - t0
    n_steps = done["mix"] + done["stab"]
    vol_s = n_steps * batch / window_s
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    result = dict(window_start=window_start,
                  end_to_end={"train_vol_s": vol_s, "train_peak_gib": window_peak / 2 ** 30},
                  attempted=n_steps, failed=0,
                  memory_peak_bytes=max(setup_peak, window_peak),
                  note=f"{done['mix']} mixing and {done['stab']} stabilizing steps of batch "
                       f"{batch} in {window_s:.3f} s")

    if trace:
        p_steps, h_steps = int(t["profile_steps"]), int(t["host_steps"])

        def profiled():
            for half in ("mix", "stab"):
                for _ in range(p_steps):
                    one(half)
            return 2 * p_steps

        _sync(dev)
        record = tr.profile(profiled)
        host = []
        for half in ("mix", "stab"):
            for _ in range(h_steps):
                _sync(dev)
                h0 = time.perf_counter()
                one(half)
                host.append((time.perf_counter() - h0) * 1e3)
        _sync(dev)
        elem = torch.tensor([], dtype=dtype).element_size()
        card = peaks.peaks(torch.cuda.get_device_name(dev)) if cuda else None
        mix_c = counts.train_step_counter(ref_cfg, phase, batch, fading=True)
        stab_c = counts.train_step_counter(ref_cfg, phase, batch, fading=False)
        flops = {"mix": mix_c.totals(elem)["flops"], "stab": stab_c.totals(elem)["flops"]}
        flops_per_volume = ((done["mix"] * flops["mix"] + done["stab"] * flops["stab"])
                            / max(1, n_steps) / batch)
        rec = dict(kind="train_step", vol_s=vol_s, flops_per_volume=flops_per_volume,
                   peaks=card, busy_s=record.busy_s, window_s=record.window_s,
                   steps=record.units, group_s=record.group_s(), launches=record.launches,
                   host_enqueue_ms=statistics.median(host), conv_groups=tr.CONV_GROUPS,
                   gemm_groups=tr.GEMM_GROUPS)
        if card is not None:
            bound = {}
            roof = 0.0
            for c in (mix_c, stab_c):
                s, b = c.roofline_s(elem, card[_compute_peak(dtype)], card["hbm"])
                roof += s * p_steps
                for key, v in b.items():
                    bound[key] = bound.get(key, 0) + v
            rec.update(roofline_s=roof, roofline_bound=bound,
                       peak_flops=card[_compute_peak(dtype)])
        result.update(record=rec, busy_s=record.busy_s, trace_window_s=record.window_s,
                      breakdown={"device_ops": record.top_ops(),
                                 "idle_gaps": record.idle_gaps()})

    # the reference, once the program's state is freed
    prog = compare.Trail([[float(v) for v in f[2]] for f in first[:3]], grad1, grad2, theta1,
                         theta3, ema1, ema3)
    state_box.clear()
    del steps, feed, one
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.time()
    theta0_dev = {k: v.to(dev) for k, v in theta0.items()}
    ref, rounded = reference_steps(ref_cfg, phase, theta0_dev, inputs,
                                   [(f[0], f[1]) for f in first[:3]], dev,
                                   rule_dtype=None if dtype == torch.float32 else dtype)
    readings = compare.leaf_readings(prog, ref, theta0, rt.frozen_names(ref_cfg, phase),
                                     rounded)
    result["numbers"], notes = compare.numbers_of(readings)
    result["note"] += ("; worst leaves: " + ", ".join(f"{k} {v}" for k, v in notes.items())
                       + "; set-up " + ", ".join(f"{k} {v:.2f} s" for k, v in marks.items())
                       + f"; reference {time.time() - t_ref:.2f} s")
    result["readings"] = readings
    return result


def _compute_peak(dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def reference_steps(ref_cfg: dict, phase: int, theta0, inputs, halves, device, q=None,
                    rows=None, rule_dtype=None, swap_alpha=False):
    """(the reference's ``compare.Trail`` of the first three steps from `theta0` on the
    same inputs, and with a `rule_dtype` step 1's gradient once more with values and
    cotangents rounded to it, for the rule of which leaves count; else None).  `q`,
    `rows` and `swap_alpha` (1 - alpha in the mixing steps) put a lower precision or a
    fault in the reference, for the check's controls."""
    from portbench.reference.ops import NO_ROUNDING, Rounding

    frozen = rt.frozen_names(ref_cfg, phase)
    state = rt.init_state(theta0)
    losses, grads, thetas, emas = [], [], [], []
    with rt.full_float32():
        for i, (half, a) in enumerate(halves):
            real, draws = inputs[i]
            if half == "mix":
                alpha = torch.tensor(1.0 - a if swap_alpha else a, device=device)
            else:
                alpha = 0.0
            state, l, g = rt.step(state, real, draws, alpha, cfg=ref_cfg, phase=phase,
                                  frozen=frozen if half == "mix" else frozenset(),
                                  q=q or NO_ROUNDING, rows=rows)
            losses.append(list(l))
            grads.append({k: v.detach() for k, v in g.items()} if i < 2 else None)
            thetas.append(state.params)
            emas.append(state.ema)
            del g
        rounded = None
        if rule_dtype is not None:
            half, a = halves[0]
            real, draws = inputs[0]
            _, rounded = rt.losses_and_grads(
                theta0, real, draws, torch.tensor(a, device=device) if half == "mix" else 0.0,
                cfg=ref_cfg, phase=phase, q=Rounding(rule_dtype, rule_dtype))
            rounded = {k: v.detach() for k, v in rounded.items()}
    return compare.Trail(losses, grads[0], grads[1], thetas[0], thetas[2], emas[0],
                         emas[2]), rounded
