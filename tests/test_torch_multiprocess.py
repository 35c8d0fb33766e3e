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
    scenarios = ([_halo, _halo_grads, _space_dp2_sp2_step, _space_sp2_sp2_step,
                  _space_k5_step] if world == 4 else
                 [_broadcast, _synchronized_trial, _batch_sharded, _halo, _halo_grads,
                  _harness, _interrupt, _cli, _cli_space, _shared_logdir, _pgan_step,
                  _surfgan_step, _pgan_accum_step, _surfgan_accum_step])
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


def _dp_step(mesh, outdir, arch_name, tag, layout=None):
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

    def to_draws(d):
        noise = d.pop("noise")
        return losses.Draws(**{k: torch.from_numpy(v) for k, v in d.items()},
                            noise=None if noise is None else NoiseByName(
                                {k: torch.from_numpy(v) for k, v in noise.items()}))

    draws = [to_draws(d) for d in inp["draws"]]  # the global micro-batches'
    draws = draws[0] if len(draws) == 1 else draws
    state = train_state_from_numpy(inp["state"], "cpu")

    def run(m, real):
        step = make_train_step(get_architecture(arch_name), cfg, inp["phase"],
                               *make_optimizers_from_config(cfg), conv_engine="flat", mesh=m)
        if m is not None:
            assert (step.space is not None) == (layout is not None)
            real = slab(shard_rows(real, m), step)
        return step(state, real, None, inp["alpha"], 1e-3, 1e-3, draws=draws)

    new, m = run(mesh, torch.from_numpy(inp["real"]))
    out = {"state": train_state_to_numpy(new),
           "metrics": {k: float(getattr(m, k)) for k in ("gen_loss", "disc_loss", "gp_loss",
                                                        "fake_min", "fake_max")}}
    if (cfg.gradient_accumulation > 1 or layout is not None) and mesh.rank == 0:
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
            with ThreadPoolExecutor(len(STEP_CASES)) as pool:
                steps = {tag: pool.submit(_jax_mesh_step,
                                          *_write_step_inputs(outdir, tag, states))
                         for tag in sorted(STEP_CASES, key=STEP_CASES.get, reverse=True)}
                refs = {"steps": {tag: f.result() for tag, f in steps.items()}}
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
            with ThreadPoolExecutor(2 * len(SPACE_STEPS)) as pool:
                steps, one = {}, {}
                for tag in SPACE_STEPS:
                    args = _write_space_inputs(outdir, tag)
                    steps[tag] = pool.submit(_jax_space_step, *args)
                    spec = str(SPACE_STEPS[tag][1])  # the inputs differ by kernel spec alone
                    one.setdefault(spec, pool.submit(_jax_one_device_step, *args))
                refs = {"steps": {tag: f.result() for tag, f in steps.items()},
                        "one_device": {tag: one[str(SPACE_STEPS[tag][1])].result()
                                       for tag in SPACE_STEPS}}
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
