"""The port's HPO harness (``saragan_tpu_torch.hpo.harness``), mirroring
``tests/test_harness_modes.py`` case for case with a stub objective (normal run,
intra-trial, inter-trial, best-trial replay, the multi-objective flag and run, the
walltime loop, the k-seed median), plus: the errors a trial may fail with, the refusal of
more than one process, a two-trial ``--optuna_ntrials`` CLI study of the real Trainer on
the CPU, and the trainer's pruning hook with a fake trial (as ``tests/test_trainer.py``'s
``test_metrics_and_pruning_hooks``)."""

import importlib
import os
import statistics
import time

import numpy as np
import pytest
import torch

from saragan_tpu_torch.cli import main as cli_main
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.hpo import create_study, harness, load_study, samplers
from saragan_tpu_torch.hpo.harness import is_multi_objective, run, worker_id
from saragan_tpu_torch.metrics.fid import RandomConvFeatures
from saragan_tpu_torch.train import trainer as trainer_mod
from saragan_tpu_torch.train.trainer import Trainer, TrialPruned

torch.set_num_threads(1)
# the module (the package re-exports its function of the same name)
save_metrics = importlib.import_module("saragan_tpu_torch.metrics.save_metrics")


def stub_objective_factory(calls):
    def objective(trial, cfg):
        value = 100.0
        if trial is not None:
            value = trial.suggest_float("x", 0, 10)
        calls.append((None if trial is None else getattr(trial, "number", -1), value))
        return value

    return objective


def test_normal_run_mode(tmp_path):
    calls = []
    cfg = Config(optuna_ntrials=None, optuna_storage=None)
    result = run(cfg, stub_objective_factory(calls))
    assert result == 100.0
    assert calls == [(None, 100.0)]


def test_intra_trial_mode(tmp_path):
    calls = []
    cfg = Config(optuna_ntrials=5, optuna_storage=f"sqlite:///{tmp_path}/study.db",
                 optuna_study_name="s", optuna_sampler="random", optuna_pruner="nopruner")
    study = run(cfg, stub_objective_factory(calls))
    assert len(calls) == 5
    assert len(study.trials) == 5
    assert study.best_trial.value == min(v for _, v in calls)


def test_inter_trial_mode(tmp_path, monkeypatch):
    monkeypatch.setenv("SARAGAN_WORKER_ID", "0")
    monkeypatch.setenv("SARAGAN_NUM_WORKERS", "2")
    monkeypatch.chdir(tmp_path)
    calls = []
    cfg = Config(optuna_distributed=True, optuna_ntrials=4,  # ceil(4/2) = 2 per worker
                 optuna_storage=f"sqlite:///{tmp_path}/inter.db", optuna_study_name="s",
                 optuna_sampler="random")
    run(cfg, stub_objective_factory(calls))
    assert len(calls) == 2
    assert os.path.isfile(tmp_path / "inter.db")
    assert worker_id() == 0


def test_best_trial_replay(tmp_path):
    storage = f"sqlite:///{tmp_path}/replay.db"
    study = create_study(study_name="s", storage=storage,
                         sampler=samplers.RandomSampler(seed=0))
    study.optimize(lambda t: t.suggest_float("x", 0, 10), n_trials=5)
    best_x = study.best_trial.params["x"]

    calls = []

    def objective(trial, cfg):
        calls.append(trial.suggest_float("x", 0, 10))
        return 0.0

    cfg = Config(optuna_use_best_trial=True, optuna_storage=storage, optuna_study_name="s")
    run(cfg, objective)
    assert calls == [best_x]


def test_multi_objective_flag():
    assert is_multi_objective(Config(optuna_sampler="NSGAII"))
    assert is_multi_objective(Config(optuna_sampler="MOTPE"))
    assert not is_multi_objective(Config(optuna_sampler="TPE"))


def test_multi_objective_run(tmp_path):
    cfg = Config(optuna_sampler="NSGAII", optuna_ntrials=6,
                 optuna_storage=f"sqlite:///{tmp_path}/mo.db", optuna_study_name="mo")

    def objective(trial, c):
        x = trial.suggest_float("x", 0, 1)
        return x, 1 - x  # (FID, train_time)-style pair

    study = run(cfg, objective)
    assert len(study.best_trials) >= 1
    assert all(t.values is not None and len(t.values) == 2 for t in study.best_trials)


def test_walltime_bounded_trial_loop(tmp_path):
    """ntrials None with --optuna_walltime keeps starting trials until the budget."""
    calls = []

    def counting(trial, cfg):
        calls.append(trial)
        time.sleep(0.02)
        return trial.suggest_float("x", 0, 10) if trial is not None else 100.0

    cfg = Config(optuna_ntrials=None, optuna_walltime=3.0,
                 optuna_storage=f"sqlite:///{tmp_path}/wt.db", optuna_study_name="wt",
                 optuna_sampler="random", optuna_pruner="nopruner")
    t0 = time.time()
    study = run(cfg, counting)
    elapsed = time.time() - t0
    assert len(calls) >= 2
    assert elapsed < 30.0
    assert all(t is not None for t in calls)
    assert len(study.trials) == len(calls)


def test_k_seed_objective_reports_median(tmp_path, monkeypatch):
    """hpo_seeds=3: default_objective trains each trial's config under 3 seeds, hands the
    sampler the median, stores the per-seed values in user_attrs, gives only the first
    seed the live trial and each seed its own logdir."""
    ran = []

    class StubTrainer:
        def __init__(self, cfg, metrics_callback=None, trial=None, verbose=False,
                     device=None):
            self.cfg, self.trial = cfg, trial

        def run(self):
            ran.append((self.cfg.seed, self.cfg.logdir, self.trial is not None))
            return float(self.cfg.seed % 7919) / 100.0 + self.cfg.g_lr

    monkeypatch.setattr(trainer_mod, "Trainer", StubTrainer)
    cfg = Config(optuna_ntrials=2, optuna_storage=f"sqlite:///{tmp_path}/ks.db",
                 optuna_study_name="ks", optuna_sampler="random", optuna_pruner="nopruner",
                 hpo_seeds=3, seed=42, g_lr=1e-3, d_lr=1e-3, base_batch_size=4,
                 noise_stddev=0.0, logdir=str(tmp_path / "runs"))
    study = harness.run(cfg)

    assert len(ran) == 6  # 2 trials x 3 seeds
    for runs in (ran[:3], ran[3:]):
        assert [r[0] for r in runs] == [42, 42 + 7919, 42 + 2 * 7919]
        assert [r[2] for r in runs] == [True, False, False]
        assert len({r[1] for r in runs}) == 3
    for t in study.trials:
        vals = t.user_attrs["seed_values"]
        assert len(vals) == 3
        assert t.value == statistics.median(vals)
        assert t.user_attrs["seed_spread"] == max(vals) - min(vals)


@pytest.mark.parametrize("error,caught", [(MemoryError, True),
                                          (torch.cuda.OutOfMemoryError, True),
                                          (RuntimeError, False)],
                         ids=["MemoryError", "cuda-OOM", "RuntimeError"])
def test_only_out_of_memory_fails_a_trial(tmp_path, error, caught):
    """An out-of-memory error fails its trial and the study goes on; any other error (a
    kernel that does not build or launch raises RuntimeError) ends the run, its trial
    marked FAIL."""
    def objective(trial, cfg):
        if trial.number == 0:
            raise error("boom")
        return trial.suggest_float("x", 0, 1)

    cfg = Config(optuna_ntrials=3, optuna_storage=f"sqlite:///{tmp_path}/e.db",
                 optuna_study_name="e", optuna_sampler="random")
    if caught:
        study = run(cfg, objective)
        assert [t.state for t in study.trials] == ["FAIL", "COMPLETE", "COMPLETE"]
    else:
        with pytest.raises(error):
            run(cfg, objective)
        study = load_study("e", f"sqlite:///{tmp_path}/e.db")
        assert [t.state for t in study.trials] == ["FAIL"]


def test_more_than_one_process_raises():
    """Trials across processes are ported (tests/test_torch_multiprocess.py runs them in
    lockstep, with the spatial axes too); what still raises is ``--horovod`` without the
    joined group's mesh and a layout data x space x space2 other than the world, before
    any training."""
    from saragan_tpu_torch.parallel import init_mesh

    with pytest.raises(ValueError, match="mesh"):
        harness.default_objective(None, Config(horovod=True), device="cpu")
    with pytest.raises(ValueError, match="num_space_shards 2 x"):
        init_mesh("cpu", num_space=2)
    with pytest.raises(ValueError, match="num_space2_shards 2 does not make the world size 1"):
        init_mesh("cpu", num_space2=2)
    mesh = init_mesh("cpu", verbose=False)  # no launcher: a group of one
    try:
        assert (mesh.world_size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        with pytest.raises(ValueError, match="num_data_shards 2"):
            init_mesh("cpu", num_data=2)
    finally:
        mesh.close()


def _make_data(root, n=12):
    rng = np.random.default_rng(0)
    for size in (4, 8):
        d = os.path.join(root, f"{size}x{size}")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            np.save(os.path.join(d, f"{i:04d}.npy"),
                    rng.normal(size=(size,) * 3).astype(np.float32))


def test_cli_study_of_the_real_trainer(tmp_path, capsys, monkeypatch):
    """Two trials through ``--optuna_ntrials`` on the CPU, with the optimizer and its
    hyperparameters left to the trials (one phase, 4 + 4 images, scored by an FID over
    32 random features so the 2048-wide matrix root stays out of the test); both COMPLETE
    with a finite value, each trial's params cover the drawn names, and a best-trial
    replay runs its params."""
    _make_data(tmp_path / "data")
    make_cb = save_metrics.make_metrics_callback
    monkeypatch.setattr(save_metrics, "make_metrics_callback", lambda cfg, device=None: make_cb(
        cfg, extractor=RandomConvFeatures(out_dim=32, device="cpu"), device=device))
    storage = f"sqlite:///{tmp_path}/s.db"
    argv = ["pgan", str(tmp_path / "data"), "--start_shape", "(1, 4, 4, 4)",
            "--final_shape", "(1, 16, 16, 16)", "--starting_phase", "2", "--ending_phase", "2",
            "--latent_dim", "16", "--network_size", "xs", "--base_batch_size", "4",
            "--mixing_nimg", "4", "--stabilizing_nimg", "4", "--noise_stddev", "0",
            "--loss_fn", "wgan", "--disable_grad_histograms", "--optimizer", "None",
            "--adam_beta1", "None", "--adam_beta2", "None", "--rho", "None",
            "--momentum", "None", "--logdir", str(tmp_path / "run"), "--device", "cpu",
            "--optuna_storage", storage, "--optuna_study_name", "cli", "--seed", "4",
            "--calc_metrics", "--compute_FID", "--allow_uncalibrated_fid"]
    study = cli_main(argv + ["--optuna_ntrials", "2"])
    trials = load_study("cli", storage).trials
    assert [t.state for t in trials] == ["COMPLETE", "COMPLETE"]
    assert all(np.isfinite(t.value) for t in trials)
    drawn = {"generator_LR", "discriminator_LR", "optimizer", "adam_beta1", "adam_beta2",
             "adadelta_rho", "SGD_momentum", "g_lr_sched_inc", "d_lr_sched_dec"}
    assert all(drawn <= set(t.params) for t in trials) and len(study.trials) == 2
    assert (tmp_path / "run" / "model_2.npz").is_file()
    capsys.readouterr()
    cli_main(argv + ["--optuna_use_best_trial"])
    assert "Replaying best trial" in capsys.readouterr().out


def test_trainer_reports_fid_and_prunes(tmp_path):
    """The trainer reports the metric pass's FID to the trial; it prunes only once the
    phase is past ``optuna_warmup_steps``; an uncalibrated FID is never reported."""
    _make_data(tmp_path / "data")
    calls = []

    def metrics_cb(trainer, sampler, dataset, step, suffix):
        fake = sampler(torch.Generator().manual_seed(0), 2)
        calls.append((step, suffix, fake.shape))
        return {"FID": 123.0}

    class FakeTrial:
        def __init__(self):
            self.reports = []

        def report(self, v, s):
            self.reports.append((v, s))

        def should_prune(self):
            return True  # always asks to prune...

    def cfg(**kw):
        return Config(architecture="pgan", dataset_path=str(tmp_path / "data"),
                      start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)",
                      starting_phase=1, ending_phase=2, latent_dim=16, base_batch_size=4,
                      mixing_nimg=4, stabilizing_nimg=4, noise_stddev=0.0, loss_fn="wgan",
                      calc_metrics=True, metrics_every_nsteps=4, grad_histograms=False,
                      logdir=str(tmp_path / kw.pop("logdir")), **kw).finalize()

    trial = FakeTrial()
    tr = Trainer(cfg(optuna_warmup_steps=10_000, logdir="a"), verbose=False,
                 metrics_callback=metrics_cb, trial=trial, device="cpu")
    fid = tr.run()  # ...but the warmup is longer than a phase: never prunes
    assert fid == 123.0
    assert trial.reports and all(v == 123.0 for v, _ in trial.reports)
    assert {"", "_EMA", "_validation"} <= {c[1] for c in calls}

    with pytest.raises(TrialPruned):  # with warmup 0 pruning fires
        Trainer(cfg(optuna_warmup_steps=0, logdir="b"), verbose=False,
                metrics_callback=metrics_cb, trial=FakeTrial(), device="cpu").run()

    metrics_cb.fid_calibrated = False  # random-feature FID: never to the pruner
    quiet = FakeTrial()
    Trainer(cfg(optuna_warmup_steps=0, logdir="c"), verbose=False,
            metrics_callback=metrics_cb, trial=quiet, device="cpu").run()
    assert quiet.reports == []
