"""The port's data parallelism across real processes on the CPU (gloo), held against the
JAX package (counterpart of ``tests/test_multiprocess.py`` and the mesh tests of
``tests/test_parallel.py`` / ``tests/test_halo.py``).

A module-scoped fixture spawns the ranks once per world size: one run of 2 ranks (every
scenario below but the 4-rank ones) and one of 4 (the halo conv and its gradients, and the
spatially sharded steps at data 2 x space 2 and space 2 x space2 2). The ranks are this file
run as a script; they import the port only (JAX and the JAX package are refused) and
assert that no module of either was loaded. The parent writes their inputs, computes the
JAX references while they run (the conftest's 8 virtual CPU devices:
``make_mesh(num_data=2)``, ``jit_train_step``, ``halo_conv3d``), then compares. Each
fixture has its own time limit: when it runs out, or a rank fails, the others are killed
and the fixture fails naming the scenario each rank was in.

Tolerances: the DP step against the JAX 2-way mesh step on the same global batch and draws,
losses rtol 1e-4 / atol 1e-6, parameters and EMA rtol 1e-4 / atol 1e-6 (as
``tests/test_parallel.py`` holds the JAX mesh step to one device; entries whose gradient
is under Adam's eps excepted, ``_assert_params_close``), surfgan's G and D gradients
(Adam's mu at beta1 0) rtol 1e-3 / atol 1e-3 max|g| (the families' step tolerance); with
gradient accumulation 2, also the port's one-process step on the global batch at the
parameter tolerance above (gradients within 1e-5 of the largest), and surfgan's parameters
against JAX at the families' one-step tolerance (``assert_step_close``); the ranks
bit-equal to each other; the halo conv in f64 within 1e-12 of max|ref|, its first-order
gradients within 1e-11 of the JAX package's GSPMD ones and its second order within 1e-11
of the unsharded conv's; the spatially sharded pgan step against the JAX mesh step of the
same layout at ``tests/test_halo.py``'s tolerances (disc_loss rtol 1e-4, G rtol 1e-3 /
atol 1e-5, D rtol 1e-2 / atol 2.5e-3), the ranks bit-equal.
"""

import os
import pickle
import sys
import time
import traceback

import numpy as np

HALO_CASES = {2: [(3, 8), (5, 8), (1, 8)], 4: [(3, 8), (5, 8), (1, 8)]}  # (kd, depth)
HALO_SHAPE = (2, 3, 8, 6)  # N, C, H, W
# the differentiable halo conv: (data, space, space2) layouts per world size, the kernels
# (kd, kh, kw) of both convs of each, and the volume (N, C, D, H, W) of the GSPMD tests
# of tests/test_halo.py (its radius-2+ cases, and the D+H exchange at space2 2)
GRAD_LAYOUTS = {2: [(1, 2, 1)], 4: [(1, 4, 1), (1, 2, 2)]}
GRAD_KERNELS = (3, 5, 7)
GRAD_SHAPE = (4, 3, 16, 8, 8)
# the sharded pgan step: tag -> (data, space, space2), kernel_spec; tests/test_halo.py's
# tiny config at phase 2 (8^3 volumes, batch 4)
SPACE_STEPS = {"space_dp2_sp2": ((2, 2, 1), [[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]]),
               "space_sp2_sp2": ((1, 2, 2), [[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]]),
               "space_k5": ((2, 2, 1), [[[], [3, 3, 3]], [[5, 5, 5], [3, 3, 3]]])}


# the five families after pgan, spatially sharded (phase 3 of a flagship-shaped pyramid:
# 1 x 4^2, 2 x 8^2, 4 x 16^2, so that over two depth ranks resolution 1 is replicated,
# 2 holds one slice a rank and 3 two, where the adaptive kernel of the global depth is 3
# and of a slab's 1): each at data 1 x space 2 on the 2-rank fixture, stylegan and surfgan
# also at data 2 x space 2 on the 4-rank fixture
SPACE_FAMILIES = ["surfgan", "pgan2", "pgandeep", "stylegan", "stylegan2"]
SPACE_FAMILIES_DP = ["stylegan", "surfgan"]
FAMILY_PHASE = 3
FAMILY_CFG = dict(start_shape="(1, 1, 4, 4)", final_shape="(1, 8, 32, 32)", latent_dim=16,
                  network_size="xxs", loss_fn="wgan", gp_weight=10.0, adam_beta1=0.0,
                  adam_beta2=0.9, noise_stddev=0.0, g_lr=1e-3, d_lr=1e-3, fused_grads=True,
                  batched_passes=True, starting_phase=FAMILY_PHASE, ending_phase=FAMILY_PHASE)
# the conv engines of the sharded step (pgan at the families' phase 3, data 1 x space 2, f64
# activations), each against the port's one-process step under the same engine: their
# ``ops.core.Ops`` fields (s2d folding every input, so that it reaches the 256- and
# 64-channel layers of 'xxs')
ENGINE_CASES = {"s2d": dict(conv="s2d", s2d_max_cin=256), "gemm_custom": dict(conv="gemm_custom")}
# the memory levers under the sharded step, each against the sharded plain step of the
# same configuration: (architecture, compute dtype, the levers' Config fields); the
# single_chip_big_volume preset (unfused transitions, no stacked passes) against itself
# without remat_offload
LEVER_CASES = {"pgan_f32": ("pgan", "float32", [dict(remat=True), dict(remat_offload=True)]),
               "pgan_bf16": ("pgan", "bfloat16", [dict(remat=True), dict(remat_offload=True)]),
               "pgan_preset": ("pgan", "float32", [dict(single_chip_big_volume=True)]),
               "stylegan2_f32": ("stylegan2", "float32", [dict(remat_offload=True)])}


def grad_kernel(k, layout):
    return (k, k if layout[2] > 1 else 3, 3)


def grad_inputs(k, layout):
    rng = np.random.default_rng(1000 + 10 * k + layout[2])
    kd, kh, kw = grad_kernel(k, layout)
    x = rng.normal(size=GRAD_SHAPE)
    w1 = rng.normal(size=(kd, kh, kw, 3, 5)) * 0.1
    w2 = rng.normal(size=(kd, kh, kw, 5, 4)) * 0.1
    return x, w1, w2


def tiny_space_cfg(kernel_spec):
    return dict(architecture="pgan", start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)",
                latent_dim=16, base_batch_size=4, kernel_spec=kernel_spec,
                filter_spec=[[8, 8], [8, 8]], loss_fn="wgan", noise_stddev=0.0, g_lr=1e-3,
                d_lr=1e-3, starting_phase=2, ending_phase=2)


def halo_inputs(kd, depth):
    rng = np.random.default_rng(100 * kd + depth)
    n, c, h, w = HALO_SHAPE
    x = rng.normal(size=(n, c, depth, h, w))
    wt = rng.normal(size=(kd, 3, 3, c, 5)) * 0.1
    return x, wt


# ---------------------------------------------------------------------------
# The ranks (this file run as a script): the port only
# ---------------------------------------------------------------------------


BLOCKED = ("jax", "jaxlib", "optax", "saragan_tpu", "tensorflow")


def _loaded(names):
    return sorted(m for m, v in sys.modules.items()
                  if v is not None and m.split(".")[0] in names)


def _worker(outdir):
    # JAX and the JAX package refused (an import raises, a probe finds nothing); also
    # TensorFlow, which TensorBoard imports where it is installed and which imports JAX
    for name in BLOCKED:
        sys.modules[name] = None
    import torch

    torch.set_num_threads(1)
    from saragan_tpu_torch.parallel import init_mesh

    mesh = init_mesh("cpu", verbose=False)
    r, world = mesh.rank, mesh.world_size
    results = {}
    t0 = time.time()

    def mark(name):
        with open(os.path.join(outdir, f"progress_{r}.txt"), "a") as f:
            f.write(f"{name} @ {time.time() - t0:.1f}s\n")

    mark("init")
    # the steps last: the parent writes their inputs while the ranks run the rest
    scenarios = ([_halo, _halo_grads, _space_levers, _space_dp2_sp2_step, _space_sp2_sp2_step,
                  _space_k5_step, _space_families_dp2] if world == 4 else
                 [_broadcast, _synchronized_trial, _batch_sharded, _halo, _halo_grads,
                  _harness, _interrupt, _cli, _cli_space, _shared_logdir, _pgan_step,
                  _surfgan_step, _pgan_accum_step, _surfgan_accum_step, _space_families,
                  _space_engines])
    for fn in scenarios:
        results[fn.__name__.strip("_")] = fn(mesh, outdir)
        mark(fn.__name__.strip("_"))
    assert not _loaded(BLOCKED), _loaded(BLOCKED)
    with open(os.path.join(outdir, f"result_{r}.pkl"), "wb") as f:
        pickle.dump(results, f)
    mesh.close()
    mark("done")


def _broadcast(mesh, outdir):
    from saragan_tpu_torch.parallel import any_rank, broadcast_json, broadcast_scalar

    return {"scalar": broadcast_scalar(0.1 + 0.2 if mesh.rank == 0 else -1.0, mesh).hex(),
            "json": broadcast_json({"lr": 1e-3, "opt": "Adam"} if mesh.rank == 0 else None,
                                   mesh),
            "any": [any_rank(mesh.rank == 1, mesh), any_rank(False, mesh)]}


def _synchronized_trial(mesh, outdir):
    from saragan_tpu_torch.parallel import SynchronizedTrial, synchronized_trial

    class PruneAtThird:
        number = 11

        def __init__(self):
            self.reports = []

        def report(self, v, step):
            self.reports.append((v, step))

        def should_prune(self):
            return len(self.reports) >= 3

        def suggest_float(self, name, low, high, **kw):
            return 0.123

        def suggest_categorical(self, name, choices):
            return list(choices)[1]

    st = synchronized_trial(PruneAtThird() if mesh.rank == 0 else None, mesh)
    assert isinstance(st, SynchronizedTrial)
    out = {"number": st.number, "suggested": st.suggest_float("lr", 0.0, 1.0),
           "suggested_cat": st.suggest_categorical("opt", ["Adam", "LAMB"])}
    out["pruned_at"] = None
    for step in range(6):
        st.report(float(step), step)
        if st.should_prune():
            out["pruned_at"] = step
            break
    out["none_trial"] = synchronized_trial(None, mesh) is None
    return out


def _batch_sharded(mesh, outdir):
    from saragan_tpu_torch.data.dataset import NumpyPathDataset

    ds = NumpyPathDataset(os.path.join(outdir, "ids"), None, seed=7)
    drawn = []
    for _ in range(3):  # global batches of 4: each of the 8 volumes once per 2 batches
        b = ds.batch_sharded(2, mesh.world_size, mesh.rank)
        drawn.append([int(v) for v in b[:, 0, 0, 0, 0]])
    return drawn


def _halo(mesh, outdir):
    """The forward halo conv with every rank a depth slab (a mesh of data 1 x space W)."""
    import torch

    from saragan_tpu_torch.parallel import halo_conv3d, init_mesh

    mesh = init_mesh("cpu", num_space=mesh.world_size, verbose=False)
    out = {}
    for kd, depth in HALO_CASES[mesh.world_size]:
        x, w = halo_inputs(kd, depth)
        d = depth // mesh.world_size
        local = torch.from_numpy(x[:, :, mesh.rank * d:(mesh.rank + 1) * d])
        for engine in ("direct", "flat"):
            y = halo_conv3d(local, torch.from_numpy(w), mesh, engine=engine)
            assert y.dtype == torch.float64 and y.shape[2] == d
            out[(kd, depth, engine)] = y.numpy()
    x, w = halo_inputs(7, 4 if mesh.world_size == 2 else 8)  # radius 3 > a rank's 2 slices
    local = torch.from_numpy(x[:, :, :2])
    try:
        halo_conv3d(local, torch.from_numpy(w), mesh)
        out["too_deep"] = None
    except ValueError as e:
        out["too_deep"] = str(e)
    return out


def _halo_grads(mesh, outdir):
    """The differentiable halo conv in f64 on each of ``GRAD_LAYOUTS``: two convs with a
    leaky ReLU between, L = sum(z^2).  First order: the gathered input gradient and the
    weight gradients summed over the ranks (for the parent's JAX GSPMD reference); second
    order: the gradients of L + |dL/dx|^2 against the unsharded conv's on rank 0."""
    import torch
    import torch.distributed as dist

    from saragan_tpu_torch.ops.core import conv_apply
    from saragan_tpu_torch.parallel import gather_slabs, halo_conv3d, init_mesh, take_slab

    def loss(x, w1, w2, conv):
        y = conv(x, w1)
        return conv(torch.where(y > 0, y, 0.2 * y), w2)

    def summed(t):
        t = t.detach().clone()
        dist.all_reduce(t)
        return t.numpy()

    out = {}
    for layout in GRAD_LAYOUTS[mesh.world_size]:
        m = init_mesh("cpu", num_data=layout[0], num_space=layout[1], num_space2=layout[2],
                      verbose=False)
        for k in GRAD_KERNELS:
            x, w1, w2 = (torch.from_numpy(a) for a in grad_inputs(k, layout))
            for engine in ("direct", "flat"):
                xs = take_slab(x, m).requires_grad_(True)
                ws = [w.clone().requires_grad_(True) for w in (w1, w2)]
                z = loss(xs, *ws, lambda a, b: halo_conv3d(a, b, m, engine=engine))
                gx, g1, g2 = torch.autograd.grad((z * z).sum(), [xs, *ws], create_graph=True)
                second = torch.autograd.grad((z * z).sum() + (gx * gx).sum(), [xs, *ws])
                res = {"first": [gather_slabs(gx.detach(), m).numpy(), summed(g1), summed(g2)],
                       "second": [gather_slabs(second[0], m).numpy(), summed(second[1]),
                                  summed(second[2])]}
                if mesh.rank == 0:
                    xr = x.clone().requires_grad_(True)
                    wr = [w.clone().requires_grad_(True) for w in (w1, w2)]
                    zr = loss(xr, *wr, lambda a, b: conv_apply(a, b, engine))
                    gxr, = torch.autograd.grad((zr * zr).sum(), xr, create_graph=True)
                    res["second_unsharded"] = [g.numpy() for g in torch.autograd.grad(
                        (zr * zr).sum() + (gxr * gxr).sum(), [xr, *wr])]
                out[(layout, k, engine)] = res
    return out


def _dp_step(mesh, outdir, arch_name, tag, layout=None, f64=False, engine="direct"):
    """The step of case `tag` on this rank's rows (and slab, on a `layout` of the world),
    with `f64` activations under `engine` (f32 parameters and state), and on rank 0
    under accumulation or a f32 layout the port's one-process step on the global batch."""
    import dataclasses

    import torch

    from saragan_tpu_torch import losses
    from saragan_tpu_torch.config import Config
    from saragan_tpu_torch.convert import train_state_from_numpy, train_state_to_numpy
    from saragan_tpu_torch.models import get_architecture
    from saragan_tpu_torch.ops.core import NoiseByName
    from saragan_tpu_torch.optim.factory import make_optimizers_from_config
    from saragan_tpu_torch.parallel import init_mesh, shard_rows
    from saragan_tpu_torch.train.step import make_train_step, slab

    if layout is not None:  # a spatially sharded mesh of the same world
        mesh = init_mesh("cpu", num_data=layout[0], num_space=layout[1],
                         num_space2=layout[2], verbose=False)
    path = os.path.join(outdir, f"inputs_{tag}.pkl")
    while not os.path.exists(path):  # written whole (renamed into place) by the parent
        time.sleep(0.1)
    with open(path, "rb") as f:
        inp = pickle.load(f)
    cfg = Config(**inp["cfg"]).finalize()

    def to_draws(d, dtype=torch.float32):
        d = dict(d)
        noise = d.pop("noise")
        t = {k: torch.from_numpy(v) for k, v in d.items()}
        t.update({k: t[k].to(dtype) for k in ("z", "gamma", "z_mix") if k in t})
        return losses.Draws(**t, noise=None if noise is None else NoiseByName(
            {k: torch.from_numpy(v).to(dtype) for k, v in noise.items()}))

    def all_draws(dtype=torch.float32):
        draws = [to_draws(d, dtype) for d in inp["draws"]]  # the global micro-batches'
        return draws[0] if len(draws) == 1 else draws

    state = train_state_from_numpy(inp["state"], "cpu")

    def run(m, real, c=cfg, engine="flat", dtype=torch.float32):
        step = make_train_step(get_architecture(arch_name), c, inp["phase"],
                               *make_optimizers_from_config(c), conv_engine=engine, mesh=m)
        if m is not None:
            assert (step.space is not None) == (layout is not None)
            real = slab(shard_rows(real, m), step)
        return step(state, real, None, inp["alpha"], 1e-3, 1e-3, draws=all_draws(dtype))

    if f64:
        new, m = run(mesh, torch.from_numpy(inp["real"]),
                     dataclasses.replace(cfg, compute_dtype="float64"), engine, torch.float64)
    else:
        new, m = run(mesh, torch.from_numpy(inp["real"]))
    out = {"state": train_state_to_numpy(new),
           "metrics": {k: float(getattr(m, k)) for k in ("gen_loss", "disc_loss", "gp_loss",
                                                        "fake_min", "fake_max")}}
    if (cfg.gradient_accumulation > 1 or layout is not None) and not f64 and mesh.rank == 0:
        # the port's one-process step
        out["one_process"] = train_state_to_numpy(run(None, torch.from_numpy(inp["real"]))[0])
    return out


def _pgan_step(mesh, outdir):
    return _dp_step(mesh, outdir, "pgan", "pgan")


def _surfgan_step(mesh, outdir):
    return _dp_step(mesh, outdir, "surfgan", "surfgan")


def _pgan_accum_step(mesh, outdir):
    return _dp_step(mesh, outdir, "pgan", "pgan_accum")


def _surfgan_accum_step(mesh, outdir):
    return _dp_step(mesh, outdir, "surfgan", "surfgan_accum")


def _space_dp2_sp2_step(mesh, outdir):
    return _dp_step(mesh, outdir, "pgan", "space_dp2_sp2", SPACE_STEPS["space_dp2_sp2"][0])


def _space_sp2_sp2_step(mesh, outdir):
    return _dp_step(mesh, outdir, "pgan", "space_sp2_sp2", SPACE_STEPS["space_sp2_sp2"][0])


def _space_k5_step(mesh, outdir):
    return _dp_step(mesh, outdir, "pgan", "space_k5", SPACE_STEPS["space_k5"][0])


def _space_families(mesh, outdir):
    """Each family of ``SPACE_FAMILIES`` at data 1 x space 2 with f64 activations on the
    parent's inputs (the references, the JAX package's one-device step and the port's
    one-process step, are the parent's; see
    ``test_space_sharded_families_match_jax_one_device_step``)."""
    return {arch: _dp_step(mesh, outdir, arch, f"family_{arch}", (1, 2, 1), True)
            for arch in SPACE_FAMILIES}


def _space_engines(mesh, outdir):
    """pgan at data 1 x space 2 with f64 activations under each engine of
    ``ENGINE_CASES`` (``test_space_sharded_engines_match_the_one_process_step``)."""
    from saragan_tpu_torch.ops.core import Ops

    return {name: _dp_step(mesh, outdir, "pgan", "family_pgan", (1, 2, 1), True, Ops(**kw))
            for name, kw in ENGINE_CASES.items()}


def _space_families_dp2(mesh, outdir):
    """stylegan and surfgan at data 2 x space 2, as ``_space_families``."""
    return {arch: _dp_step(mesh, outdir, arch, f"family_{arch}", (2, 2, 1), True)
            for arch in SPACE_FAMILIES_DP}


def _state_sha(state):
    import hashlib

    h = hashlib.sha256()
    trees = {"g": state.g_params, "d": state.d_params, "ema": state.ema,
             **{f"g_opt/{s}": t for s, t in state.g_opt.slots.items()},
             **{f"d_opt/{s}": t for s, t in state.d_opt.slots.items()}}
    for name in sorted(trees):
        for k in sorted(trees[name]):
            h.update(f"{name}/{k}".encode())
            h.update(trees[name][k].detach().float().numpy().tobytes())
    return h.hexdigest()


def _space_levers(mesh, outdir):
    """``LEVER_CASES`` at data 2 x space 2 (each space group the one of the issue's space 2,
    the rows split over the data axis): the sharded step from the port's seeded init and
    draws, plain and under each lever, as state hashes and losses (pgan at 8 filters a
    layer); then the trainer's variants of the step, sharded: the lazy penalty's step
    without it and the histogram step."""
    import dataclasses

    import torch

    from saragan_tpu_torch import losses
    from saragan_tpu_torch.config import Config
    from saragan_tpu_torch.models import get_architecture
    from saragan_tpu_torch.parallel import init_mesh, shard_rows
    from saragan_tpu_torch.train.step import init_train_state, make_train_step, slab

    mesh = init_mesh("cpu", num_data=2, num_space=2, verbose=False)
    out = {}

    def one(arch_name, cfg, **kw):
        a = get_architecture(arch_name)
        state, opts = init_train_state(a, torch.Generator().manual_seed(0),
                                       phase=FAMILY_PHASE, cfg=cfg, device="cpu")
        real = torch.from_numpy(np.random.default_rng(4).normal(
            size=cfg.current_shape(FAMILY_PHASE, 4)).astype(np.float32))
        step = make_train_step(a, cfg, FAMILY_PHASE, *opts, conv_engine="flat", mesh=mesh,
                               **kw)
        assert step.space is mesh
        new, m = step(state, slab(shard_rows(real, mesh), step),
                      torch.Generator().manual_seed(6), 0.5, 1e-3, 1e-3)
        return {"sha": _state_sha(new), "parked": step.parked_bytes,
                "losses": [float(m.gen_loss), float(m.disc_loss), float(m.gp_loss)],
                "hists": None if m.g_hists is None else len(m.g_hists) + len(m.d_hists)}

    for tag, (arch_name, dtype, levers) in LEVER_CASES.items():
        small = {"filter_spec": [[8, 8]] * FAMILY_PHASE} if arch_name == "pgan" else {}
        base = Config(**dict(FAMILY_CFG, architecture=arch_name, compute_dtype=dtype, **small,
                             **(levers[0] if "single_chip_big_volume" in levers[0] else {}))
                      ).finalize()
        if base.single_chip_big_volume:  # the preset's model without its lever
            assert not (base.fused_transitions or base.batched_passes)
            plain = dataclasses.replace(base, remat_offload=False)
            out[tag] = {"plain": one(arch_name, plain), "preset": one(arch_name, base)}
            continue
        out[tag] = {"plain": one(arch_name, base)}
        for lever in levers:
            out[tag][next(iter(lever))] = one(arch_name, dataclasses.replace(base, **lever))
    cfg = Config(**dict(FAMILY_CFG, architecture="pgan", lazy_gp=2,
                        filter_spec=[[8, 8]] * FAMILY_PHASE)).finalize()
    out["variants"] = {"no_gp": one("pgan", cfg, apply_gp=False),
                       "histograms": one("pgan", cfg, grad_histograms=True)}
    return out


def _harness(mesh, outdir):
    """Intra-trial HPO across the ranks: rank 0 alone binds the shared storage, every
    objective call sees rank 0's parameters, and the walltime loop stops every rank after
    the same trial although their trials take different times."""
    from saragan_tpu_torch.config import Config
    from saragan_tpu_torch.hpo import harness
    from saragan_tpu_torch.parallel import synchronized_trial

    calls, wt_calls = [], []

    def objective(trial, cfg):
        trial = synchronized_trial(trial, mesh)
        lr = trial.suggest_float("generator_LR", 1e-4, 1e-1)
        calls.append(lr)
        return float((np.log10(lr) + 2.5) ** 2)

    study = harness.run(Config(optuna_ntrials=4, optuna_storage=f"sqlite:///{outdir}/study.db",
                               optuna_study_name="twoproc", optuna_sampler="TPE",
                               noise_stddev=0.0), objective, mesh=mesh)

    def slow(trial, cfg):
        trial = synchronized_trial(trial, mesh)
        wt_calls.append(trial.suggest_float("generator_LR", 1e-4, 1e-1))
        time.sleep(0.2 + 0.3 * mesh.rank)  # the clocks would diverge without lockstep
        return 1.0

    harness.run(Config(optuna_ntrials=None, optuna_walltime=1.2,
                       optuna_storage=f"sqlite:///{outdir}/wt.db", optuna_study_name="wt",
                       optuna_sampler="random", noise_stddev=0.0), slow, mesh=mesh)
    return {"lrs": calls, "n_trials": len(study.trials),
            "storage_is_shared": study._storage.path is not None,
            "walltime_ntrials": len(wt_calls)}


def _interrupt(mesh, outdir):
    """A SIGTERM that reaches rank 0 alone, during phase 1's second step: every rank
    stops after that step (whether a signal arrived is agreed after each step), writes
    its exact-resume checkpoint and raises ``TrainingInterrupted`` at the same step; none
    is left in a collective."""
    import signal

    import torch

    from saragan_tpu_torch import losses
    from saragan_tpu_torch.config import Config
    from saragan_tpu_torch.train.trainer import Trainer, TrainingInterrupted

    cfg = Config(architecture="pgan", dataset_path=os.path.join(outdir, "tdata"),
                 start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)", starting_phase=1,
                 ending_phase=2, latent_dim=16, network_size="xxs", base_batch_size=4,
                 mixing_nimg=16, stabilizing_nimg=16, noise_stddev=0.0, g_lr=1e-3,
                 d_lr=1e-3, loss_fn="wgan", gp_weight=10.0, grad_histograms=False,
                 validation_fraction=0.2, test_fraction=0.2,
                 logdir=os.path.join(outdir, f"interrupt_{mesh.rank}")).finalize()

    def draws_fn(phase, local_step):
        if mesh.rank == 0 and local_step == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        n = cfg.batch_size_for_phase(phase) * mesh.world_size
        return losses.draw_inputs(torch.Generator().manual_seed(local_step), n,
                                  cfg.latent_dim, cfg.current_shape(phase, 1)[1:],
                                  torch.float32, "cpu")

    tr = Trainer(cfg, mesh=mesh, verbose=False, prefetch=False, draws_fn=draws_fn)
    try:
        tr.run()
        return None
    except TrainingInterrupted as e:
        return {"global_step": e.global_step, "phase": e.phase,
                "resume": os.path.basename(e.resume_path),
                "exists": os.path.exists(e.resume_path),
                "handler_restored": signal.getsignal(signal.SIGTERM) == signal.SIG_DFL}


def _cli_argv(outdir, logdir, ending_phase, *extra):
    return ["pgan", os.path.join(outdir, "tdata"), "--start_shape", "(1, 4, 4, 4)",
            "--final_shape", "(1, 16, 16, 16)", "--starting_phase", "1", "--ending_phase",
            str(ending_phase), "--latent_dim", "16", "--network_size", "xxs",
            "--base_batch_size", "4", "--mixing_nimg", "8", "--stabilizing_nimg", "8",
            "--noise_stddev", "0", "--g_lr", "1e-3", "--d_lr", "1e-3", "--loss_fn", "wgan",
            "--gp_weight", "10", "--validation_fraction", "0.2", "--test_fraction", "0.2",
            "--disable_grad_histograms", "--horovod", "--device", "cpu", "--logdir", logdir,
            *extra]


def _cli_space(mesh, outdir):
    """The CLI with ``--num_space_shards 2``, phase 1 -> 2: the ranks are one data index,
    each training on its depth slab of the same rows."""
    return _cli(mesh, outdir, "cli_space", "--num_space_shards", "2")


def _cli(mesh, outdir, name="cli", *extra):
    """The CLI, phase 1 -> 2, each rank its own logdir: both ranks finish with the same
    checkpoints and bit-equal parameters."""
    import hashlib

    from saragan_tpu_torch import cli
    from saragan_tpu_torch.train import trainer as trainer_mod

    made = []
    init = trainer_mod.Trainer.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    trainer_mod.Trainer.__init__ = recording_init
    try:
        logdir = os.path.join(outdir, f"{name}_{mesh.rank}")
        cli.main(_cli_argv(outdir, logdir, 2,
                           *(extra or ("--num_data_shards", str(mesh.world_size)))))
    finally:
        trainer_mod.Trainer.__init__ = init
    tr = made[-1]
    h = hashlib.sha256()
    params = {**tr.state.g_params, **tr.state.d_params}
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].numpy().tobytes())
    return {"params_sha": h.hexdigest(), "global_size": tr.global_size,
            "space": (tr.mesh.num_space, tr.mesh.num_space2),
            "ckpts": sorted(f for f in os.listdir(logdir) if f.startswith("model_")),
            "events": os.path.exists(os.path.join(logdir, "events.jsonl"))}


def _shared_logdir(mesh, outdir):
    """Both ranks write their (identical) checkpoints into one logdir at the same steps:
    every file loads whole and no temporary file is left."""
    import torch
    import torch.distributed as dist

    from saragan_tpu_torch import cli

    logdir = os.path.join(outdir, "shared")
    cli.main(_cli_argv(outdir, logdir, 1, "--checkpoint_every_nsteps", "8",
                       "--full_state_checkpoints"))
    dist.barrier(group=mesh.host_group)
    names = sorted(os.listdir(logdir))
    loaded = {}
    for name in names:
        path = os.path.join(logdir, name)
        if name.endswith(".npz"):
            with np.load(path) as z:
                loaded[name] = sum(int(z[k].size) for k in z.files)
        elif name.endswith(".pkl"):
            loaded[name] = len(torch.load(path, weights_only=False)["state"]["g_params"])
    return {"names": names, "loaded": loaded}


if __name__ == "__main__":
    try:
        _worker(sys.argv[1])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.exit(0)


# ---------------------------------------------------------------------------
# The parent: inputs, JAX references, comparisons
# ---------------------------------------------------------------------------

import socket  # noqa: E402
import subprocess  # noqa: E402

from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

import saragan_tpu.ops.core as jax_ops_core  # noqa: E402
from saragan_tpu.data.dataset import NumpyPathDataset as JaxNumpyPathDataset  # noqa: E402
from saragan_tpu.models import get_architecture as jax_arch  # noqa: E402
from saragan_tpu.optim.ema import ema_init as jax_ema_init  # noqa: E402
from saragan_tpu.optim.factory import make_optimizers_from_config as jax_optimizers  # noqa: E402
from saragan_tpu.parallel import (jit_train_step, make_mesh, replicated_sharding,  # noqa: E402
                                  shard_global_batch)
from saragan_tpu.config import Config as JaxConfig  # noqa: E402
from saragan_tpu.parallel.halo import halo_conv3d as jax_halo_conv3d  # noqa: E402
from saragan_tpu.parallel.halo import volume_sharding  # noqa: E402
from saragan_tpu.parallel.mesh import batch_sharding  # noqa: E402
from saragan_tpu.train import TrainState as JaxTrainState  # noqa: E402
from saragan_tpu.train.step import split_params as jax_split_params  # noqa: E402
from saragan_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from tests.test_torch_families import (SMALL, _tree, assert_step_close, configs,  # noqa: E402
                                       phase_of, step_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GLOBAL, ALPHA = 4, 0.5
BUDGET_S = {2: 300.0, 4: 240.0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _progress(outdir, world):
    lines = []
    for r in range(world):
        p = os.path.join(outdir, f"progress_{r}.txt")
        done = open(p).read().splitlines() if os.path.exists(p) else []
        last = done[-1] if done else "(nothing: died before joining the group)"
        lines.append(f"rank {r}: {len(done)} scenarios done, last completed: {last}")
    return "\n".join(lines)


def _tail(outdir, r):
    p = os.path.join(outdir, f"out_{r}.txt")
    return open(p).read()[-4000:] if os.path.exists(p) else ""


def _launch(outdir, world):
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        with open(os.path.join(outdir, f"out_{r}.txt"), "w") as out:  # the rank keeps its copy
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), outdir],
                                          env=env, stdout=out, stderr=subprocess.STDOUT,
                                          cwd=REPO))
    return procs


def _finish(procs, outdir, world, started):
    """Wait for every rank within the world's budget; on a failed rank or the budget's
    end, kill the others and fail naming the scenario each was in."""
    while True:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            break
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        late = time.time() - started > BUDGET_S[world]
        if failed or late:
            for p in procs:
                p.kill()
            why = (f"rank {failed[0]} exited {codes[failed[0]]}" if failed
                   else f"the {world}-rank run exceeded {BUDGET_S[world]:.0f} s")
            r = failed[0] if failed else 0
            pytest.fail(f"{why}\n{_progress(outdir, world)}\n--- rank {r} output tail ---\n"
                        f"{_tail(outdir, r)}")
        time.sleep(0.2)
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


STEP_CASES = {"pgan": ("pgan", 1), "surfgan": ("surfgan", 1), "pgan_accum": ("pgan", 2),
              "surfgan_accum": ("surfgan", 2)}  # tag: (architecture, gradient_accumulation)


def _jax_state(arch, cfg, jcfg, phase):
    """Both sides' initial state: the port's init from seed 0 (the same names and shapes
    as the reference's, whose init, run op by op, takes tens of seconds on the CPU) as the
    reference's TrainState."""
    import torch

    from saragan_tpu_torch.models import get_architecture

    params = get_architecture(arch).init(torch.Generator().manual_seed(0), phase=phase,
                                         cfg=cfg, device="cpu")
    g, d = jax_split_params({k: jnp.asarray(v.numpy()) for k, v in params.items()})
    g_opt, d_opt = jax_optimizers(jcfg)
    return JaxTrainState(g, d, g_opt.init(g), d_opt.init(d), jax_ema_init({**g, **d}))


def _write_step_inputs(outdir, tag, states):
    """The reference's initial state (one per architecture in `states`), global batch,
    step key and its draws (numpy): under accumulation K, micro-batch k's from the k-th of
    K keys split from the step key (the reference's scan), the refresh latents from the
    step key."""
    arch, accum = STEP_CASES[tag]
    kw = dict(fused_grads=True, batched_passes=True, gradient_accumulation=accum)
    jcfg, cfg = configs(arch, **kw)
    phase = phase_of(arch)
    if arch not in states:
        states[arch] = _jax_state(arch, cfg, jcfg, phase)
    state, opts = states[arch], jax_optimizers(jcfg)
    real = np.random.default_rng(10).normal(
        size=cfg.current_shape(phase, N_GLOBAL)).astype(np.float32)
    key = jax.random.PRNGKey(20)
    keys = jax.random.split(key, accum) if accum > 1 else [key]
    draws = []
    for k, mkey in enumerate(keys):
        d = step_draws(arch, cfg, phase, mkey, N_GLOBAL // accum, jnp.float32, real.shape[1:])
        if d.refresh_z is not None and accum > 1:  # as step_draws, from the step key
            d = d._replace(refresh_z=np.asarray(jax.random.normal(
                jax.random.fold_in(key, 7), (64, cfg.latent_dim))) if k == 0 else None)
        m = {f: np.asarray(getattr(d, f)) for f in ("z", "gamma", "z_mix", "mix_coin",
                                                 "mix_cutoff", "refresh_z")
             if getattr(d, f) is not None}
        m["noise"] = None if d.noise is None else {n: v.numpy()
                                                   for n, v in d.noise.tensors.items()}
        draws.append(m)
    inp = {"cfg": dict(SMALL, architecture=arch, starting_phase=phase, ending_phase=phase,
                       **kw),
           "phase": phase, "alpha": ALPHA, "real": real, "state": _tree(state),
           "draws": draws}
    path = os.path.join(outdir, f"inputs_{tag}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(inp, f)
    os.replace(path + ".tmp", path)
    return jcfg, arch, phase, state, opts, real, key


def _jax_mesh_step(jcfg, arch, phase, state, opts, real, key):
    """The reference's step jitted over a 2-way data mesh (the global batch sharded)."""
    mesh = make_mesh(num_data=2)
    step = jit_train_step(jax_make_train_step(jax_arch(arch), jcfg, phase, *opts), mesh, 5,
                          donate=False)
    new, m = step(jax.device_put(state, replicated_sharding(mesh)),
                  shard_global_batch(mesh, real), key, ALPHA, 1e-3, 1e-3)
    return _tree(new), {k: float(getattr(m, k)) for k in ("gen_loss", "disc_loss", "gp_loss")}


def _jax_halo(world):
    jax.config.update("jax_enable_x64", True)
    try:
        mesh = make_mesh(num_data=1, num_space=world)
        out = {}
        for kd, depth in HALO_CASES[world]:
            x, w = halo_inputs(kd, depth)
            with jax.sharding.set_mesh(mesh):
                y = jax_halo_conv3d(jnp.asarray(x), jnp.asarray(w), mesh)
            assert y.dtype == jnp.float64
            out[(kd, depth)] = np.asarray(y)
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def _write_space_inputs(outdir, tag):
    """The JAX mesh step's initial state (the port's init), batch, key and draws of one
    ``SPACE_STEPS`` case, written for the ranks; returns the JAX step's arguments."""
    from saragan_tpu_torch.config import Config

    layout, kernel_spec = SPACE_STEPS[tag]
    kw = tiny_space_cfg(kernel_spec)
    jcfg, cfg = JaxConfig(**kw).finalize(), Config(**kw).finalize()
    state, opts = _jax_state("pgan", cfg, jcfg, 2), jax_optimizers(jcfg)
    real = np.random.default_rng(0).normal(size=(N_GLOBAL, 1, 8, 8, 8)).astype(np.float32)
    key = jax.random.PRNGKey(42)
    d = step_draws("pgan", cfg, 2, key, N_GLOBAL, jnp.float32, real.shape[1:])
    inp = {"cfg": kw, "phase": 2, "alpha": ALPHA, "real": real, "state": _tree(state),
           "draws": [{"z": np.asarray(d.z), "gamma": np.asarray(d.gamma), "noise": None}]}
    path = os.path.join(outdir, f"inputs_{tag}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(inp, f)
    os.replace(path + ".tmp", path)
    return jcfg, layout, state, opts, real, key


def _jax_space_step(jcfg, layout, state, opts, real, key):
    """The reference's step over its data x space (x space2) mesh, the batch's depth on
    'space' and height on 'space2' (``tests/test_halo.py``'s mesh steps)."""
    mesh = make_mesh(num_data=layout[0], num_space=layout[1], num_space2=layout[2])
    step = jit_train_step(jax_make_train_step(jax_arch("pgan"), jcfg, 2, *opts), mesh, 5,
                          donate=False, space_axis=2)
    new, m = step(jax.device_put(state, replicated_sharding(mesh)),
                  jax.device_put(real, volume_sharding(mesh)), key, ALPHA, 1e-3, 1e-3)
    return _tree(new), {k: float(getattr(m, k)) for k in ("gen_loss", "disc_loss", "gp_loss")}


def _write_family_inputs(outdir, arch):
    """One ``SPACE_FAMILIES`` case's inputs for the ranks (the port's init as the JAX
    TrainState, the global batch, and the reference's draws of its step key, the style
    families' noise by layer name over the whole volume); returns the JAX step's
    arguments."""
    from saragan_tpu_torch.config import Config

    kw = dict(FAMILY_CFG, architecture=arch)
    jcfg, cfg = JaxConfig(**kw).finalize(), Config(**kw).finalize()
    state, opts = _jax_state(arch, cfg, jcfg, FAMILY_PHASE), jax_optimizers(jcfg)
    real = np.random.default_rng(11).normal(
        size=cfg.current_shape(FAMILY_PHASE, N_GLOBAL)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    d = step_draws(arch, cfg, FAMILY_PHASE, key, N_GLOBAL, jnp.float32, real.shape[1:])
    m = {f: np.asarray(getattr(d, f)) for f in ("z", "gamma", "z_mix", "mix_coin",
                                             "mix_cutoff", "refresh_z")
         if getattr(d, f) is not None}
    m["noise"] = None if d.noise is None else {n: v.numpy() for n, v in d.noise.tensors.items()}
    inp = {"cfg": kw, "phase": FAMILY_PHASE, "alpha": ALPHA, "real": real,
           "state": _tree(state), "draws": [m]}
    path = os.path.join(outdir, f"inputs_family_{arch}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(inp, f)
    os.replace(path + ".tmp", path)
    return arch, jcfg, state, opts, real, key


_FAMILY_REFS = {}


def _jax_family_step(arch, jcfg, state, opts, real, key):
    """The reference's one-device step of a ``SPACE_FAMILIES`` case (computed once for
    both fixtures: their inputs are the same)."""
    if arch not in _FAMILY_REFS:
        step = jit_train_step(jax_make_train_step(jax_arch(arch), jcfg, FAMILY_PHASE, *opts),
                              None, 5, donate=False)
        new, m = step(state, jnp.asarray(real), key, ALPHA, 1e-3, 1e-3)
        _FAMILY_REFS[arch] = (_tree(new), {k: float(getattr(m, k))
                                           for k in ("gen_loss", "disc_loss", "gp_loss")})
    return _FAMILY_REFS[arch]


_FAMILY_ONE = {}


def _port_family_f64(outdir, arch, engine=None):
    """The port's one-process step of a ``SPACE_FAMILIES`` case with f64 activations
    (under the ``Ops`` fields `engine`, ``direct`` by default; f32 parameters and state) on
    its global batch, from the inputs the ranks read (computed once for both fixtures)."""
    key = arch if engine is None else (arch, tuple(sorted(engine.items())))
    if key not in _FAMILY_ONE:
        import dataclasses

        import torch

        from saragan_tpu_torch import losses
        from saragan_tpu_torch.config import Config
        from saragan_tpu_torch.convert import train_state_from_numpy, train_state_to_numpy
        from saragan_tpu_torch.models import get_architecture
        from saragan_tpu_torch.ops.core import NoiseByName, Ops
        from saragan_tpu_torch.optim.factory import make_optimizers_from_config
        from saragan_tpu_torch.train.step import make_train_step

        with open(os.path.join(outdir, f"inputs_family_{arch}.pkl"), "rb") as f:
            inp = pickle.load(f)
        cfg = dataclasses.replace(Config(**inp["cfg"]).finalize(), compute_dtype="float64")
        d = dict(inp["draws"][0])
        noise = d.pop("noise")
        t = {k: torch.from_numpy(v) for k, v in d.items()}
        t.update({k: t[k].double() for k in ("z", "gamma", "z_mix") if k in t})
        draws = losses.Draws(**t, noise=None if noise is None else NoiseByName(
            {k: torch.from_numpy(v).double() for k, v in noise.items()}))
        step = make_train_step(get_architecture(arch), cfg, FAMILY_PHASE,
                               *make_optimizers_from_config(cfg),
                               conv_engine=Ops(**(engine or {})))
        new, _ = step(train_state_from_numpy(inp["state"], "cpu"),
                      torch.from_numpy(inp["real"]), None, ALPHA, 1e-3, 1e-3, draws=draws)
        _FAMILY_ONE[key] = train_state_to_numpy(new)
    return _FAMILY_ONE[key]


def _jax_one_device_step(jcfg, layout, state, opts, real, key):
    """The reference's step on one device, on the same state, batch and key."""
    step = jit_train_step(jax_make_train_step(jax_arch("pgan"), jcfg, 2, *opts), None, 5,
                          donate=False)
    return _tree(step(state, jnp.asarray(real), key, ALPHA, 1e-3, 1e-3)[0])


def _jax_halo_grads(world):
    """The first-order gradients of ``_halo_grads``'s loss through the reference's GSPMD
    mesh (the batch's depth on 'space', its height on 'space2'), in f64."""
    jax.config.update("jax_enable_x64", True)
    try:
        def loss(x, w1, w2):
            dn = ("NCDHW", "DHWIO", "NCDHW")
            y = jax.lax.conv_general_dilated(x, w1, (1, 1, 1), "SAME", dimension_numbers=dn)
            y = jnp.where(y > 0, y, 0.2 * y)
            z = jax.lax.conv_general_dilated(y, w2, (1, 1, 1), "SAME", dimension_numbers=dn)
            return jnp.sum(z * z)

        grad_fn = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
        out = {}
        for layout in GRAD_LAYOUTS[world]:
            mesh = make_mesh(num_data=layout[0], num_space=layout[1], num_space2=layout[2])
            for k in GRAD_KERNELS:
                x, w1, w2 = grad_inputs(k, layout)
                xs = jax.device_put(jnp.asarray(x), batch_sharding(mesh, 5, space_axis=2))
                ws = [jax.device_put(jnp.asarray(w), replicated_sharding(mesh)) for w in (w1, w2)]
                out[(layout, k)] = [np.asarray(g) for g in grad_fn(xs, *ws)]
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def _write_files(outdir):
    """The 8 id-volumes of batch_sharded and the pyramid of the CLI runs."""
    ids = os.path.join(outdir, "ids")
    os.makedirs(ids)
    for i in range(8):
        np.save(os.path.join(ids, f"v{i}.npy"), np.full((2, 4, 4), float(i), np.float32))
    rng = np.random.default_rng(0)
    for size in (4, 8):
        d = os.path.join(outdir, "tdata", f"{size}x{size}")
        os.makedirs(d)
        for i in range(12):
            np.save(os.path.join(d, f"v{i}.npy"),
                    rng.normal(size=(size, size, size)).astype(np.float32))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(per-rank results, JAX references) of the 2-rank run."""
    outdir = str(tmp_path_factory.mktemp("two_ranks"))
    saved = jax_ops_core.CONV3D_ALGORITHM
    jax_ops_core.CONV3D_ALGORITHM = "direct"
    try:
        _write_files(outdir)
        started = time.time()
        procs = _launch(outdir, 2)
        try:
            states = {}
            # each reference step compiles as soon as its inputs are written, the longest
            # to compile first, side by side with the rest
            with ThreadPoolExecutor(len(STEP_CASES) + 2 * len(SPACE_FAMILIES)) as pool:
                steps = {tag: pool.submit(_jax_mesh_step,
                                          *_write_step_inputs(outdir, tag, states))
                         for tag in sorted(STEP_CASES, key=STEP_CASES.get, reverse=True)}
                families = {arch: pool.submit(_jax_family_step,
                                              *_write_family_inputs(outdir, arch))
                            for arch in SPACE_FAMILIES}
                one = {arch: pool.submit(_port_family_f64, outdir, arch)
                       for arch in SPACE_FAMILIES}
                _write_family_inputs(outdir, "pgan")
                engines = {name: pool.submit(_port_family_f64, outdir, "pgan", kw)
                           for name, kw in ENGINE_CASES.items()}
                refs = {"steps": {tag: f.result() for tag, f in steps.items()},
                        "families": {arch: f.result() for arch, f in families.items()},
                        "family_one": {arch: f.result() for arch, f in one.items()},
                        "engines_one": {name: f.result() for name, f in engines.items()}}
            refs["halo"] = _jax_halo(2)  # after the steps: it switches on x64 globally
            refs["grads"] = _jax_halo_grads(2)
            ids = []
            for shard in range(2):
                ds = JaxNumpyPathDataset(os.path.join(outdir, "ids"), None, seed=7)
                ids.append([[int(v) for v in ds.batch_sharded(2, 2, shard)[:, 0, 0, 0, 0]]
                            for _ in range(3)])
            refs["ids"] = ids
        except BaseException:
            for p in procs:
                p.kill()
            raise
        results = _finish(procs, outdir, 2, started)
    finally:
        jax_ops_core.CONV3D_ALGORITHM = saved
    return results, refs


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(per-rank results, JAX references) of the 4-rank run: the halo conv, its gradients
    and the spatially sharded steps."""
    outdir = str(tmp_path_factory.mktemp("four_ranks"))
    saved = jax_ops_core.CONV3D_ALGORITHM
    jax_ops_core.CONV3D_ALGORITHM = "direct"
    try:
        started = time.time()
        procs = _launch(outdir, 4)
        try:
            with ThreadPoolExecutor(2 * len(SPACE_STEPS) + 2 * len(SPACE_FAMILIES_DP)) as pool:
                steps, one = {}, {}
                for tag in SPACE_STEPS:
                    args = _write_space_inputs(outdir, tag)
                    steps[tag] = pool.submit(_jax_space_step, *args)
                    spec = str(SPACE_STEPS[tag][1])  # the inputs differ by kernel spec alone
                    one.setdefault(spec, pool.submit(_jax_one_device_step, *args))
                families = {arch: pool.submit(_jax_family_step,
                                              *_write_family_inputs(outdir, arch))
                            for arch in SPACE_FAMILIES_DP}
                ports = {arch: pool.submit(_port_family_f64, outdir, arch)
                         for arch in SPACE_FAMILIES_DP}
                refs = {"steps": {tag: f.result() for tag, f in steps.items()},
                        "one_device": {tag: one[str(SPACE_STEPS[tag][1])].result()
                                       for tag in SPACE_STEPS},
                        "families": {arch: f.result() for arch, f in families.items()},
                        "family_one": {arch: f.result() for arch, f in ports.items()}}
            refs["halo"] = _jax_halo(4)  # after the steps: x64 is global
            refs["grads"] = _jax_halo_grads(4)
        except BaseException:
            for p in procs:
                p.kill()
            raise
        results = _finish(procs, outdir, 4, started)
    finally:
        jax_ops_core.CONV3D_ALGORITHM = saved
    return results, refs


def test_broadcast_primitives(two_ranks):
    """0.1 + 0.2 arrives bit for bit; the JSON and the any-rank flag on every rank."""
    (r0, r1), _ = two_ranks
    assert r0["broadcast"] == r1["broadcast"]
    assert r0["broadcast"]["scalar"] == (0.1 + 0.2).hex()
    assert r0["broadcast"]["json"] == {"lr": 1e-3, "opt": "Adam"}
    assert r0["broadcast"]["any"] == [True, False]


def test_synchronized_trial_lockstep_prune(two_ranks):
    """The values of ``tests/test_multiprocess.py``: trial 11, 0.123, 'LAMB', pruned on
    step 2 on both ranks."""
    (r0, r1), _ = two_ranks
    assert r0["synchronized_trial"] == r1["synchronized_trial"] == {
        "number": 11, "suggested": 0.123, "suggested_cat": "LAMB", "pruned_at": 2,
        "none_trial": True}


def test_batch_sharded_exactly_once_as_the_reference(two_ranks):
    """Each global batch's volumes once across the ranks, every 8 in two batches, and the
    shards the JAX package's own on the same files and seed."""
    (r0, r1), refs = two_ranks
    assert [r0["batch_sharded"], r1["batch_sharded"]] == refs["ids"]
    for a, b in zip(r0["batch_sharded"], r1["batch_sharded"]):
        assert not set(a) & set(b)
    assert sorted(sum(r0["batch_sharded"][:2] + r1["batch_sharded"][:2], [])) == list(range(8))


LR = 1e-3


def _assert_params_close(ours, ref):
    """Parameters and EMA within rtol 1e-4 / atol 1e-6, but for entries whose reference
    gradient is below 1e-7 of its network's largest: there Adam's step lr g / (|g| + 1e-8)
    is set by the rounding of a gradient under eps (the sign-boundary effect
    ``tests/test_halo.py`` documents), so they are held to 2 lr, and they must be fewer
    than 1e-4 of the entries."""
    for net in ("g", "d"):
        mu = ref[f"{net}_opt"]["mu"]
        top = max(np.abs(g).max() for g in mu.values())
        loose = total = 0
        for part in (f"{net}_params", "ema"):
            for k, v in ref[part].items():
                if not k.startswith("generator/" if net == "g" else "discriminator/"):
                    continue
                d = np.abs(ours[part][k] - v)
                off = d > 1e-6 + 1e-4 * np.abs(v)
                tiny = np.abs(mu[k]) < 1e-7 * top
                assert not np.any(off & ~tiny), (part, k, d[off & ~tiny].max())
                assert d.max() <= 2 * LR + 1e-6, (part, k, d.max())
                loose += int(np.sum(off))
                total += v.size
        assert loose <= 1e-4 * total, (net, loose, total)


def _assert_dp_step(two_ranks, tag, params_close=_assert_params_close):
    (r0, r1), refs = two_ranks
    a, b = r0[f"{tag}_step"], r1[f"{tag}_step"]
    for part in ("g_params", "d_params", "ema"):  # the ranks bit-equal
        for k, v in a["state"][part].items():
            np.testing.assert_array_equal(v, b["state"][part][k], err_msg=k)
    assert a["metrics"] == b["metrics"]
    ref_state, ref_m = refs["steps"][tag]
    for name, v in ref_m.items():
        np.testing.assert_allclose(a["metrics"][name], v, rtol=1e-4, atol=1e-6, err_msg=name)
    params_close(a["state"], ref_state)
    return a, ref_state


def test_pgan_dp_step_matches_jax_mesh_step(two_ranks):
    """The pgan DP step (f32, fused_grads, batched_passes, 2 + 2 of a global batch of 4)
    against the JAX package's step over a 2-way data mesh on the same batch and draws."""
    _assert_dp_step(two_ranks, "pgan")


def _assert_grads_close(ours, ref):
    """G's and D's gradients (Adam's mu at beta1 0) at the families' step tolerance."""
    for net in ("g", "d"):
        mu_ref, mu = ref[f"{net}_opt"]["mu"], ours["state"][f"{net}_opt"]["mu"]
        for k, g in mu_ref.items():
            np.testing.assert_allclose(mu[k], g, rtol=1e-3, atol=1e-3 * np.abs(g).max(),
                                       err_msg=k)


def test_surfgan_dp_step_matches_jax_mesh_step(two_ranks):
    """surfgan's minibatch-stddev groups span the ranks (group 4 over the global 4): the
    gathered statistic, its gradient and the penalty's second-order pass through the
    gather equal the JAX mesh step's; D's gradients (Adam's mu) compared too."""
    _assert_grads_close(*_assert_dp_step(two_ranks, "surfgan"))


@pytest.mark.parametrize("arch", ["pgan", "surfgan"])
def test_dp_step_with_accumulation_matches_jax_mesh_step(two_ranks, arch):
    """``gradient_accumulation`` 2 over the 2-way mesh: micro-batch k is the global
    batch's k-th contiguous half (here rank k's whole local batch), shared out over both
    ranks with its draws, as the reference splits its global array; one all-reduce after
    both micro-batches.  surfgan's stddev groups then span each micro-batch's global rows.
    Held to the port's one-process step on the global batch at the data-parallel
    tolerance, and to the JAX mesh step: pgan at that tolerance too, surfgan at the
    families' one-step tolerance (``assert_step_close``), since its first micro-batch
    alone, one process and no accumulation, is 1.8e-5 (G) and 3.1e-5 (D) of the largest
    gradient from the reference's (a stddev group of two rows)."""
    ours, ref = _assert_dp_step(two_ranks, f"{arch}_accum", _assert_params_close
                                if arch == "pgan" else partial(assert_step_close, arch=arch))
    _assert_grads_close(ours, ref)
    one = ours["one_process"]
    _assert_params_close(ours["state"], one)
    for net in ("g", "d"):
        mu_one, mu = one[f"{net}_opt"]["mu"], ours["state"][f"{net}_opt"]["mu"]
        top = max(np.abs(g).max() for g in mu_one.values())
        for k, g in mu_one.items():
            np.testing.assert_allclose(mu[k], g, rtol=0, atol=1e-5 * top, err_msg=k)


def test_intra_trial_hpo_lockstep(two_ranks):
    """The harness's lockstep (``tests/test_multiprocess.py:137-151``): the same parameters
    on every call, 4 trials each, only rank 0 on the shared storage, and the walltime loop
    ending both ranks after the same trial."""
    (r0, r1), _ = two_ranks
    h0, h1 = r0["harness"], r1["harness"]
    assert h0["lrs"] == h1["lrs"] and len(h0["lrs"]) == 4
    assert h0["n_trials"] == h1["n_trials"] == 4
    assert h0["storage_is_shared"] and not h1["storage_is_shared"]
    assert h0["walltime_ntrials"] == h1["walltime_ntrials"] >= 2


def test_a_signal_on_one_rank_stops_every_rank_after_the_same_step(two_ranks):
    """SIGTERM on rank 0 alone during phase 1's second step: both ranks stop after it
    (global step 16 of 8 images a step), each with its exact-resume checkpoint, their
    handlers given back; the JAX package can leave the other rank in a collective
    (ROADMAP.md, faults of the reference)."""
    (r0, r1), _ = two_ranks
    i0, i1 = r0["interrupt"], r1["interrupt"]
    assert i0 is not None and i0 == i1
    assert i0["global_step"] == 16 and i0["phase"] == 1
    assert i0["resume"] == "model_1_ckpt_16_interrupt.pkl" and i0["exists"]
    assert i0["handler_restored"]


def test_cli_trains_on_two_ranks(two_ranks):
    """``--horovod`` through the CLI, phase 1 -> 2: both ranks finish, the same checkpoints,
    bit-equal parameters, a global size of 2; rank 0 alone writes events."""
    (r0, r1), _ = two_ranks
    c0, c1 = r0["cli"], r1["cli"]
    assert c0["global_size"] == c1["global_size"] == 2
    assert c0["ckpts"] == c1["ckpts"] == ["model_1.npz", "model_2.npz"]
    assert c0["params_sha"] == c1["params_sha"]
    assert c0["events"] and not c1["events"]


def test_shared_logdir_checkpoints_load_whole(two_ranks):
    """Two ranks writing the same checkpoints into one logdir at once (per-process
    temporary names): every npz and pkl loads whole, none is left half-written."""
    (r0, r1), _ = two_ranks
    s0, s1 = r0["shared_logdir"], r1["shared_logdir"]
    assert s0 == s1
    assert not [n for n in s0["names"] if n.endswith(".tmp")]
    assert {"model_1.npz", "model_1_ckpt_8.npz", "model_1_ckpt_8_full.pkl"} <= set(
        s0["loaded"])
    assert all(v > 0 for v in s0["loaded"].values())


@pytest.mark.parametrize("world", [2, 4])
def test_halo_conv_matches_jax_f64(two_ranks, four_ranks, world):
    """The depth-halo conv on 2 and 4 ranks, both engines, in f64 against the JAX
    package's ``halo_conv3d`` (each rank's slab): radius 1 and 2 (radius 2 equals a
    4-way rank's depth of 2) within 1e-12 of max|ref|, kd = 1 without an exchange; a
    radius deeper than a rank's slab raises."""
    results, refs = two_ranks if world == 2 else four_ranks
    for (kd, depth), ref in refs["halo"].items():
        d = depth // world
        for r, res in enumerate(results):
            for engine in ("direct", "flat"):
                got = res["halo"][(kd, depth, engine)]
                part = ref[:, :, r * d:(r + 1) * d]
                np.testing.assert_allclose(got, part, rtol=0,
                                           atol=1e-12 * np.abs(ref).max(),
                                           err_msg=f"kd {kd} rank {r} {engine}")
    for res in results:
        assert "halo radius 3 exceeds local shard depth 2" in res["halo"]["too_deep"]


@pytest.mark.parametrize("world", [2, 4])
def test_halo_conv_grads_match_jax_f64(two_ranks, four_ranks, world):
    """The differentiable halo conv in f64 (both engines, k = 3, 5, 7; depth over 2 and 4
    ranks, depth and height over 2 x 2 with k x k x 3 kernels): the first-order gradients
    (the input's gathered, the weights' summed over the ranks) within 1e-11 of max|ref| of
    the JAX package's GSPMD mesh gradients, the second order (the gradients of
    L + |dL/dx|^2, the penalty's shape) within 1e-11 of the unsharded conv's, and every rank
    holding the same result."""
    results, refs = two_ranks if world == 2 else four_ranks
    cases = results[0]["halo_grads"]
    assert len(cases) == 2 * len(GRAD_KERNELS) * len(GRAD_LAYOUTS[world])
    for (layout, k, engine), res in cases.items():
        for part, want in (("first", refs["grads"][(layout, k)]),
                           ("second", res["second_unsharded"])):
            for i, (got, ref) in enumerate(zip(res[part], want)):
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11 * np.abs(ref).max(),
                                           err_msg=f"{layout} k {k} {engine} {part} {i}")
                for other in results[1:]:
                    np.testing.assert_array_equal(
                        other["halo_grads"][(layout, k, engine)][part][i], got)


@pytest.mark.parametrize("tag", list(SPACE_STEPS))
def test_space_sharded_step_matches_jax_mesh_step(four_ranks, tag):
    """The pgan WGAN-GP step (f32, fused_grads, batched_passes, fused_transitions) on 4
    ranks with each volume's depth (and height) split, against the JAX package's step on
    its mesh of the same layout (``tests/test_halo.py``): data 2 x space 2, space 2 x
    space2 2, and the NAS kernel-5 spec at data 2 x space 2.  disc_loss within rtol 1e-4
    (gen_loss too for the kernel-5 spec), G's parameters rtol 1e-3 / atol 1e-5, D's
    rtol 1e-2 / atol 2.5e-3 (the tolerances there); the 4 ranks bit-equal.

    At this lr Adam moves each of D's entries by about lr, so D's parameter check cannot
    see a wrong gradient.  The step's gradients (Adam's mu at beta1 0), the penalty's
    double backward through the exchanges, gathers and space sums included, are held
    within 1e-4 of each network's largest to the JAX package's one-device step, and
    within 1e-5 to the port's one-process step.  The JAX mesh step is held to that too
    where the reference's own mesh step agrees with its one-device step, data 1: with
    data and space both above 1 the reference's D conv-weight gradients are up to 25 %
    of the largest from its one-device step (ROADMAP, faults of the reference)."""
    results, refs = four_ranks
    ours = [r[f"{tag}_step"] for r in results]
    for other in ours[1:]:
        for part in ("g_params", "d_params", "ema"):
            for k, v in ours[0]["state"][part].items():
                np.testing.assert_array_equal(v, other["state"][part][k], err_msg=k)
        assert other["metrics"] == ours[0]["metrics"]
    ref_state, ref_m = refs["steps"][tag]
    got = ours[0]
    np.testing.assert_allclose(got["metrics"]["disc_loss"], ref_m["disc_loss"], rtol=1e-4)
    if tag == "space_k5":
        np.testing.assert_allclose(got["metrics"]["gen_loss"], ref_m["gen_loss"], rtol=1e-4)
    for k, v in ref_state["g_params"].items():
        np.testing.assert_allclose(got["state"]["g_params"][k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    for k, v in ref_state["d_params"].items():
        np.testing.assert_allclose(got["state"]["d_params"][k], v, rtol=1e-2, atol=2.5e-3,
                                   err_msg=k)
    wants = [(refs["one_device"][tag], 1e-4), (got["one_process"], 1e-5)]
    if SPACE_STEPS[tag][0][0] == 1:
        wants.append((ref_state, 1e-4))
    for net in ("g", "d"):
        mu = got["state"][f"{net}_opt"]["mu"]
        for want, limit in wants:
            mu_ref = want[f"{net}_opt"]["mu"]
            top = max(np.abs(g).max() for g in mu_ref.values())
            assert top > 0, net
            for k, g in mu_ref.items():
                np.testing.assert_allclose(mu[k], g, rtol=0, atol=limit * top, err_msg=k)


def test_cli_trains_spatially_sharded_on_two_ranks(two_ranks):
    """``--horovod --num_space_shards 2`` through the CLI, phase 1 -> 2: both ranks are
    data index 0 (a global size of 1), each training on its depth slab; both finish with
    the same checkpoints and bit-equal parameters; rank 0 alone writes events."""
    (r0, r1), _ = two_ranks
    c0, c1 = r0["cli_space"], r1["cli_space"]
    assert c0["global_size"] == c1["global_size"] == 1
    assert c0["space"] == c1["space"] == (2, 1)
    assert c0["ckpts"] == c1["ckpts"] == ["model_1.npz", "model_2.npz"]
    assert c0["params_sha"] == c1["params_sha"]
    assert c0["events"] and not c1["events"]


def _assert_space_family(results, refs, arch, key):
    """One family's sharded step (`key` of each rank's results) against the JAX package's
    one-device step and the port's one-process step, and the ranks bit-equal."""
    ours = [r[key][arch] for r in results]
    for other in ours[1:]:
        for part in ("g_params", "d_params", "ema"):
            for k, v in ours[0]["state"][part].items():
                np.testing.assert_array_equal(v, other["state"][part][k], err_msg=k)
        assert other["metrics"] == ours[0]["metrics"]
    got, (ref_state, ref_m) = ours[0], refs["families"][arch]
    for name, v in ref_m.items():
        np.testing.assert_allclose(got["metrics"][name], v, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    for net, rtol, atol in (("g", 1e-3, 1e-5), ("d", 1e-2, 2.5e-3)):
        mu_ref = ref_state[f"{net}_opt"]["mu"]
        top = max(np.abs(g).max() for g in mu_ref.values())
        loose = total = 0
        for part in (f"{net}_params", "ema"):
            for k, v in ref_state[part].items():
                if not k.startswith("generator/" if net == "g" else "discriminator/"):
                    continue
                d = np.abs(got["state"][part][k] - v)
                # Adam's first step lr g / (|g| + eps) turns on the gradient's rounding
                # where |g| is within the gradient limit below (1e-4 of max) of zero, the
                # mapping's biases (lrmul 0.01) among them: those within 2 lr, at most
                # 1e-3 of the entries (the limits of profile_parallel's spatial check)
                free = np.abs(mu_ref[k]) <= 1e-4 * top
                off = d > atol + rtol * np.abs(v)
                assert not np.any(off & ~free), (part, k, d.max())
                assert d.max() <= 2 * LR + 1e-6, (part, k, d.max())
                loose += int(off.sum())
                total += v.size
        assert loose <= 1e-3 * total, (net, loose, total)
        mu = got["state"][f"{net}_opt"]["mu"]
        for want, limit in ((ref_state, 1e-4), (refs["family_one"][arch], 1e-5)):
            w = want[f"{net}_opt"]["mu"]
            wtop = max(np.abs(g).max() for g in w.values())
            assert wtop > 0, net
            for k, g in w.items():
                np.testing.assert_allclose(mu[k], g, rtol=0, atol=limit * wtop,
                                           err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", SPACE_FAMILIES)
def test_space_sharded_families_match_jax_one_device_step(two_ranks, arch):
    """Each family after pgan (fused_grads, batched_passes, alpha 0.5) with every volume's
    depth split over two ranks (data 1 x space 2), at phase 3 of 1 x 4^2 -> 4 x 16^2:
    resolution 1 replicated (the generator enters the slab at 2, the discriminator
    gathers before its pool into 1), 2 one slice a rank, 3 two slices with the global
    depth's kernel 3, the style families' noise the slab of the whole volume's draw,
    stylegan's instance norm over the space group.  The sharded step runs f64 activations
    (f32 parameters and state) under ``direct`` (each halo conv VALID on the exchanged
    axis; the ``flat`` halo convs run in the pgan and lever cases).  Against the JAX
    package's one-device f32 step on the same parameters and
    draws: losses rtol 1e-4, gradients (Adam's mu at beta1 0) within 1e-4 of each
    network's largest, parameters and EMA at ``tests/test_halo.py``'s tolerances (G rtol
    1e-3 / atol 1e-5, D rtol 1e-2 / atol 2.5e-3; entries whose gradient is within the
    gradient limit of zero within 2 lr, at most 1e-3 of the entries).  Against the port's
    one-process step with f64 activations: gradients within 1e-5 of max (measured: at
    most 8e-9, the gradients' f32 rounding).
    Not in f32: on one CPU thread the gradients of the noise strengths and biases of
    stylegan2's top block sum 65536 products with a condition of about 250, and the
    sharded f32 step lies 4.6e-4 of max from the f64 step while the one-process f32 step
    lies 1.4e-7 from it (on other inputs the other way round: 0.7 % off one process's
    sum).  The ranks bit-equal."""
    results, refs = two_ranks
    _assert_space_family(results, refs, arch, "space_families")


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_space_sharded_engines_match_the_one_process_step(two_ranks, name):
    """pgan's step at data 1 x space 2 (phase 3 of 1 x 4^2 -> 4 x 16^2, f64 activations)
    under ``s2d`` and ``gemm_custom``: every halo conv the engine's SAME conv of the
    extended slab, cropped (``s2d`` folds the 4-slice extended slabs of resolution 3 and
    gives the odd 3-slice ones of resolution 2 to the direct conv).  Against the port's
    one-process step under the same engine: gradients (Adam's mu at beta1 0) within
    ``F64_GRAD_LIMIT`` of each network's largest, the ranks bit-equal."""
    from saragan_tpu_torch.tools.profile_parallel import F64_GRAD_LIMIT

    results, refs = two_ranks
    ours = [r["space_engines"][name]["state"] for r in results]
    for part in ("g_params", "d_params", "ema"):
        for k, v in ours[0][part].items():
            np.testing.assert_array_equal(v, ours[1][part][k], err_msg=k)
    want = refs["engines_one"][name]
    for net in ("g", "d"):
        w = want[f"{net}_opt"]["mu"]
        top = max(np.abs(g).max() for g in w.values())
        assert top > 0, net
        for k, g in w.items():
            np.testing.assert_allclose(ours[0][f"{net}_opt"]["mu"][k], g, rtol=0,
                                       atol=F64_GRAD_LIMIT * top, err_msg=f"{name} {k}")


@pytest.mark.parametrize("arch", SPACE_FAMILIES_DP)
def test_space_sharded_families_dp2_match_jax_one_device_step(four_ranks, arch):
    """stylegan and surfgan at data 2 x space 2 (surfgan's minibatch-stddev groups over the
    data axis alone, after the head's gather) against the JAX package's one-device step,
    at the limits of the data 1 x space 2 case.  The JAX mesh step is no oracle here: its
    D conv-weight gradients are wrong wherever data and space are both above 1 (ROADMAP,
    faults of the reference)."""
    results, refs = four_ranks
    _assert_space_family(results, refs, arch, "space_families_dp2")


@pytest.mark.parametrize("tag", list(LEVER_CASES))
def test_space_sharded_levers_bit_equal_to_the_sharded_plain_step(four_ranks, tag):
    """Under spatial sharding (data 2 x space 2) a step under ``remat`` and under
    ``remat_offload`` is bit-equal to the sharded plain step of the same configuration
    (pgan in f32 and bf16, stylegan2 in f32): the recompute regions re-run their halo
    exchanges, crossings and space sums inside the backward and the penalty's double
    backward, in the same order on every rank.  The ``single_chip_big_volume`` preset
    (unfused transitions, no stacked passes, offload) equals its model without offload.
    Every offload step parks its block taps (pgan; stylegan2 has none), every rank ends
    with the same state.  Also the trainer's variants of the step (the lazy penalty's
    step without it, the histogram step) run sharded, the ranks equal."""
    results, _ = four_ranks
    cases = [r["space_levers"][tag] for r in results]
    for c in cases[1:]:
        assert c == cases[0]
    runs = cases[0]
    for lever, run in runs.items():
        assert run["sha"] == runs["plain"]["sha"], lever
        assert run["losses"] == runs["plain"]["losses"], lever
        assert all(np.isfinite(run["losses"])), lever
        offload = lever in ("remat_offload", "preset")
        assert (run["parked"] > 0) == (offload and tag.startswith("pgan")), (lever, run)
    variants = [r["space_levers"]["variants"] for r in results]
    assert all(v == variants[0] for v in variants)
    assert variants[0]["no_gp"]["losses"][2] == 0.0
    assert variants[0]["histograms"]["hists"] > 0
    assert all(np.isfinite(v["losses"]).all() for v in variants[0].values())
