"""The run modes of the trainer's CLI (counterpart of ``saragan_tpu/hpo/harness.py``).

``run(cfg, objective)`` dispatches on the configuration, as the reference does:

1. **normal**: one training run, no HPO (``objective(None, cfg)``);
2. **best-trial replay** (``optuna_use_best_trial``): load the study from storage, fix
   the best trial's params (``FixedTrial``), run once;
3. **inter-trial** (``optuna_distributed``): N worker processes each run their own
   trials against one shared SQLite study; worker 0 creates the study, the others wait
   for the database file and then load it with a delay staggered by their id, so that
   they do not all open SQLite at once.  The worker's id comes from
   ``SARAGAN_WORKER_ID``, the worker count from ``SARAGAN_NUM_WORKERS``
   (``optuna_ntrials`` is split between them), and each worker logs under
   ``<logdir>/<id>``;
4. **intra-trial** (``optuna_ntrials``, ``optuna_walltime`` or ``optuna_storage``): the
   study's trials one after the other, each a whole training run, data-parallel over the
   ranks of the `mesh` when one is given (``--horovod``).  Then only rank 0 binds the
   shared storage; the others run as many trials against a local throwaway study, every
   suggestion and prune decision coming from rank 0 (``parallel.synchronized_trial`` in
   ``default_objective``), and whether another trial starts is rank 0's decision,
   broadcast, so that no rank's clock or count can leave the others in a collective.

Each trial is a ``Trainer`` run (``default_objective``), scored by the FID of
``make_metrics_callback``; with ``hpo_seeds`` k > 1 the same sampled configuration
trains under k seeds (a stride of 7919) and the sampler gets the median.  Only
out-of-memory errors (``MemoryError``, ``torch.cuda.OutOfMemoryError``) fail a trial
and let the study go on; any other error ends the run, so a kernel that does not build
or launch is never a quietly failed trial.  After each trial the trainer's tensors are
dropped and the garbage collected (``gc_after_trial``).  The harness prints a line as
each trial starts and, on a CUDA device, the device memory allocated then and when the
study ends, with each trial's peak: a trial that leaves tensors behind shows as a higher
level at the next start.
"""

from __future__ import annotations

import os
import time
from typing import Callable

from saragan_tpu_torch import hpo
from saragan_tpu_torch.config import Config


def worker_id(mesh=None) -> int:
    """``SARAGAN_WORKER_ID``, else this process's rank (0 without a mesh)."""
    wid = os.environ.get("SARAGAN_WORKER_ID")
    if wid is not None:
        return int(wid)
    return 0 if mesh is None else mesh.rank


def make_sampler(cfg: Config, multi_objective: bool):
    s = hpo.samplers
    name = cfg.optuna_sampler
    # NSGAII/MOTPE are the (FID, train_time) multi-objective samplers and nothing else
    # is (is_multi_objective); a mismatch means the caller passed inconsistent arguments
    assert multi_objective == (name in ("NSGAII", "MOTPE")), (name, multi_objective)
    if name == "random":
        return s.RandomSampler(seed=cfg.seed)
    if name == "TPE":
        return s.TPESampler(seed=cfg.seed, multivariate=cfg.optuna_TPE_multivariate)
    if name == "CMA":
        return s.CmaEsSampler(
            seed=cfg.seed,
            consider_pruned_trials=cfg.optuna_CMA_consider_pruned_trials,
            restart_strategy=cfg.optuna_CMA_restart_strategy,
            inc_popsize=cfg.optuna_CMA_inc_popsize,
        )
    if name == "NSGAII":
        return s.NSGAIISampler(seed=cfg.seed)
    if name == "MOTPE":
        return s.MOTPESampler(seed=cfg.seed)
    raise ValueError(f"Unknown sampler {name}")


def make_pruner(cfg: Config):
    p = hpo.pruners
    if cfg.optuna_pruner == "median":
        return p.MedianPruner(n_startup_trials=10)
    if cfg.optuna_pruner == "SHA":
        return p.SuccessiveHalvingPruner()
    if cfg.optuna_pruner == "nopruner":
        return p.NopPruner()
    raise ValueError(f"Unknown pruner {cfg.optuna_pruner}")


def is_multi_objective(cfg: Config) -> bool:
    """NSGAII and MOTPE optimize (FID, train_time)."""
    return cfg.optuna_sampler in ("NSGAII", "MOTPE")


class FixedTrial:
    """Replays a frozen trial's params (best-trial mode).

    A missing param raises (Optuna's FixedTrial does too): substituting a bound would
    replay another configuration than the recorded best trial, e.g. for a study created
    before a hyperparameter joined the search space."""

    def __init__(self, params):
        self.params = dict(params)
        self.number = -1

    def _get(self, name):
        if name not in self.params:
            raise KeyError(
                f"replayed trial has no value for {name!r}; the study "
                f"predates this parameter — pass --{name} on the CLI "
                f"(CLI values take precedence over frozen-trial values)"
            )
        return self.params[name]

    def suggest_float(self, name, low, high, **kw):
        return self._get(name)

    suggest_uniform = suggest_float

    def suggest_loguniform(self, name, low, high):
        return self._get(name)

    def suggest_int(self, name, low, high, step=1, **kw):
        return int(self._get(name))

    def suggest_categorical(self, name, choices):
        return self._get(name)

    def report(self, value, step):
        pass

    def should_prune(self):
        return False


def _catchable() -> tuple:
    """The errors that fail one trial and let the study go on: running out of host or
    device memory (the reference's OOM family), nothing else."""
    import torch

    return (MemoryError, torch.cuda.OutOfMemoryError)


def default_objective(trial, cfg: Config, device=None, mesh=None, extractor=None):
    """objective(trial, cfg) -> FID (or (FID, train_time)): one full multi-phase
    training run on `device` (CUDA unless named), or data-parallel over `mesh` (a
    ``parallel.Mesh``, on its device; rank 0's trial is the real one).  ``cfg.horovod``
    needs the mesh (``cli.main`` joins the process group before ``run``).  `extractor`:
    the FID's feature extractor (None: ``make_metrics_callback``'s default)."""
    from saragan_tpu_torch.hpo.suggestions import optuna_override_undefined
    from saragan_tpu_torch.metrics.save_metrics import make_metrics_callback
    from saragan_tpu_torch.parallel import synchronized_trial
    from saragan_tpu_torch.train.trainer import Trainer, TrialPruned as TrainerPruned

    if cfg.horovod and mesh is None:
        raise ValueError("--horovod needs the process group's mesh: join it with "
                         "parallel.init_mesh (cli.main does) and pass mesh=")
    if trial is not None or mesh is not None:
        # lockstep: suggestions and prune decisions come from rank 0, so the override
        # below samples the same parameters on every rank
        trial = synchronized_trial(trial, mesh)
    if mesh is not None:
        device = mesh.device
    if trial is not None:
        cfg = optuna_override_undefined(cfg, trial)
    cfg = cfg.finalize()
    # None means "let the HPO trial pick it"; in a normal run nothing fills these
    for field in ("g_lr", "d_lr", "base_batch_size", "optimizer", "noise_stddev"):
        if getattr(cfg, field) is None:
            raise ValueError(
                f"--{field} is unset (None). Either pass --{field} explicitly or "
                f"run under HPO (--optuna_ntrials N) so the trial samples it."
            )
    if cfg.optuna_distributed:
        cfg.logdir = os.path.join(cfg.logdir or "runs", str(worker_id()))

    def run_once(run_cfg, run_trial):
        # resolved before training: compute_FID without Inception weights fails here
        # (UncalibratedFIDError) unless allow_uncalibrated_fid
        named = {} if extractor is None else {"extractor": extractor}
        metrics_cb = (make_metrics_callback(run_cfg, device=device, **named)
                      if run_cfg.calc_metrics else None)
        parallel = {} if mesh is None else {"mesh": mesh}
        trainer = Trainer(run_cfg, metrics_callback=metrics_cb, trial=run_trial,
                          verbose=(worker_id(mesh) == 0 or run_cfg.optuna_distributed),
                          device=device, **parallel)
        try:
            return trainer.run()
        except TrainerPruned:
            raise hpo.TrialPruned()

    start = time.time()
    k = int(getattr(cfg, "hpo_seeds", 1) or 1)
    if trial is None or k <= 1:
        fid = run_once(cfg, trial)
    else:
        # the same sampled configuration under k seeds, the median to the sampler;
        # pruning rides the first seed's trajectory, later seeds train uninterrupted
        import dataclasses
        import statistics

        vals = []
        for j in range(k):
            run_cfg = dataclasses.replace(
                cfg,
                seed=cfg.seed + 7919 * j,  # prime stride: disjoint streams
                logdir=os.path.join(cfg.logdir or "runs", f"seed{j}"),
            )
            vals.append(run_once(run_cfg, trial if j == 0 else None))
        if any(v is None for v in vals):
            fid = None  # no objective computed (calc_metrics off), as with one seed
        else:
            vals = [float(v) for v in vals]
            fid = statistics.median(vals)
            if hasattr(trial, "set_user_attr"):
                trial.set_user_attr("seed_values", vals)
                trial.set_user_attr("seed_spread", max(vals) - min(vals))
    if is_multi_objective(cfg):
        return fid, time.time() - start
    return fid


def _announced(objective: Callable, cfg: Config, mesh=None) -> Callable:
    """``study.optimize``'s function: `objective(trial, cfg)` after a line (rank 0's only)
    that names the trial and, on a CUDA device, the device memory allocated and the peak
    since the previous such line (the previous trial's)."""
    import torch

    def func(trial):
        line = f"HPO trial {trial.number} starts"
        if torch.cuda.is_initialized():
            line += (f": device memory allocated {torch.cuda.memory_allocated()} B "
                     f"(previous trial's peak {torch.cuda.max_memory_allocated()} B)")
            torch.cuda.reset_peak_memory_stats()
        if mesh is None or mesh.rank == 0:
            print(line, flush=True)
        return objective(trial, cfg)

    return func


def _study_done(study, mesh=None):
    import torch

    if torch.cuda.is_initialized() and (mesh is None or mesh.rank == 0):
        print(f"HPO study done: device memory allocated {torch.cuda.memory_allocated()} B "
              f"(last trial's peak {torch.cuda.max_memory_allocated()} B)", flush=True)
    return study


def run(cfg: Config, objective: Callable = default_objective, mesh=None):
    """Dispatch on run mode; `mesh` (a ``parallel.Mesh``): the intra-trial study runs in
    lockstep over its ranks."""
    multi = is_multi_objective(cfg)
    sampler = make_sampler(cfg, multi)
    pruner = make_pruner(cfg)
    kwargs = dict(directions=["minimize", "minimize"]) if multi else dict(direction="minimize")
    optimize = dict(catch=_catchable(), gc_after_trial=True)

    if cfg.optuna_use_best_trial:
        assert cfg.optuna_storage and cfg.optuna_study_name
        study = hpo.load_study(study_name=cfg.optuna_study_name, storage=cfg.optuna_storage,
                               sampler=sampler, pruner=pruner)
        best = study.best_trial
        print(f"Replaying best trial {best.number} with params {best.params}")
        return objective(FixedTrial(best.params), cfg)

    if cfg.optuna_distributed:
        wid = worker_id()
        storage = cfg.optuna_storage or "sqlite:///optuna_study.db"
        name = cfg.optuna_study_name or "saragan"
        if wid == 0:
            study = hpo.create_study(study_name=name, storage=storage, sampler=sampler,
                                     pruner=pruner, load_if_exists=True, **kwargs)
        else:
            # wait for worker 0 to create the database, then load it staggered by id;
            # the file poll only makes sense for sqlite
            if storage.startswith("sqlite:///"):
                db_path = storage[len("sqlite:///"):]
                while not os.path.exists(db_path):
                    time.sleep(1)
            time.sleep(wid)
            study = hpo.load_study(study_name=name, storage=storage, sampler=sampler,
                                   pruner=pruner)
        n_trials = None
        if cfg.optuna_ntrials is not None:
            # ceil split across the workers; without SARAGAN_NUM_WORKERS each worker
            # would run the whole budget, so warn
            env = os.environ.get("SARAGAN_NUM_WORKERS")
            if env is None and os.environ.get("SARAGAN_WORKER_ID") is not None:
                print("WARNING: SARAGAN_WORKER_ID is set but SARAGAN_NUM_WORKERS "
                      "is not — every worker will run the full --optuna_ntrials "
                      "budget instead of a 1/N share")
            nworkers = int(env or "1")
            n_trials = -(-cfg.optuna_ntrials // max(nworkers, 1))
        study.optimize(_announced(objective, cfg), n_trials=n_trials,
                       timeout=cfg.optuna_walltime, **optimize)
        return _study_done(study)

    if (cfg.optuna_ntrials is not None or cfg.optuna_storage is not None
            or cfg.optuna_walltime is not None):
        coordinator = mesh is None or mesh.rank == 0
        study = hpo.create_study(study_name=cfg.optuna_study_name or "saragan",
                                 storage=cfg.optuna_storage if coordinator else None,
                                 sampler=sampler, pruner=pruner, load_if_exists=True,
                                 **kwargs)
        if mesh is None or mesh.world_size == 1:
            study.optimize(_announced(objective, cfg), n_trials=cfg.optuna_ntrials,
                           timeout=cfg.optuna_walltime, **optimize)
            return _study_done(study)
        # lockstep: rank 0 decides whether another trial starts, every rank follows
        from saragan_tpu_torch.parallel import broadcast_scalar

        start, i = time.time(), 0
        while True:
            more = coordinator and (
                (cfg.optuna_ntrials is None or i < cfg.optuna_ntrials)
                and (cfg.optuna_walltime is None or time.time() - start < cfg.optuna_walltime))
            if not broadcast_scalar(float(more), mesh):
                break
            study.optimize(_announced(objective, cfg, mesh), n_trials=1, **optimize)
            i += 1
        return _study_done(study, mesh)

    # normal run
    return objective(None, cfg)
