"""The port's HPO engine and search space against the JAX package's: the same seed and
objective give the same params draw for draw for every sampler (Random, TPE, TPE
multivariate, CMA-ES with and without ipop restarts, NSGA-II, MOTPE), the pruners take
the same decisions on the same reports, a study written by one package loads in the
other, and ``optuna_override_undefined`` fills the same Config fields from the same
FixedTrial and the same seeded trials.  Exact equality throughout: both engines run the
same Python and numpy arithmetic."""

import dataclasses
import math

import pytest
import torch

from saragan_tpu import hpo as jax_hpo
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.hpo import harness as jax_harness
from saragan_tpu.hpo.suggestions import optuna_override_undefined as jax_override
from saragan_tpu_torch import hpo
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.hpo import engine, harness
from saragan_tpu_torch.hpo.suggestions import optuna_override_undefined

torch.set_num_threads(1)

SAMPLERS = {
    "random": lambda s: s.RandomSampler(seed=3),
    "TPE": lambda s: s.TPESampler(seed=3),
    "TPE-multivariate": lambda s: s.TPESampler(seed=3, multivariate=True),
    "CMA": lambda s: s.CmaEsSampler(seed=3),
    "CMA-ipop": lambda s: s.CmaEsSampler(seed=3, restart_strategy="ipop", inc_popsize=2,
                                         consider_pruned_trials=True),
    "NSGAII": lambda s: s.NSGAIISampler(seed=3),
    "MOTPE": lambda s: s.MOTPESampler(seed=3),
}
MULTI = ("NSGAII", "MOTPE")


def _objective(multi):
    def objective(t):
        x = t.suggest_float("x", -3, 3)
        lr = t.suggest_loguniform("lr", 1e-4, 1e-1)
        k = t.suggest_int("k", 1, 7, 2)
        b = t.suggest_int("b", 1, 6)
        opt = t.suggest_categorical("opt", ["Adam", "SGD", "Adadelta"])
        q = t.suggest_float("q", 0.0, 1.0, step=0.25)
        f = (x - 1) ** 2 + (math.log10(lr) + 2) ** 2 + 0.1 * k + 0.05 * b + q
        f += {"Adam": 0.0, "SGD": 0.3, "Adadelta": 0.6}[opt]
        return (f, (x + 1) ** 2 + b) if multi else f

    return objective


def _history(study):
    return [(t.number, t.state, t.params, t.values) for t in study.trials]


def _run(pkg, name, n_trials, tmp_path=None, storage_name=None):
    multi = name in MULTI
    kwargs = dict(directions=["minimize", "minimize"]) if multi else {}
    storage = f"sqlite:///{tmp_path}/{storage_name}.db" if storage_name else None
    study = pkg.create_study(study_name="s", storage=storage,
                             sampler=SAMPLERS[name](pkg.samplers),
                             pruner=pkg.pruners.NopPruner(), **kwargs)
    study.optimize(_objective(multi), n_trials=n_trials)
    return study


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_draws_match_reference(name):
    """40 trials (past every sampler's startup and a CMA generation or two)."""
    ours, ref = _history(_run(hpo, name, 40)), _history(_run(jax_hpo, name, 40))
    assert ours == ref
    assert len({tuple(sorted(p.items())) for _, _, p, _ in ours}) > 30  # really sampling


@pytest.mark.parametrize("name", ["TPE", "CMA"])
def test_sampler_draws_match_reference_through_sqlite(name, tmp_path):
    """The same through SQLite storage, and each package's database loads in the other
    with the same trials."""
    ours = _run(hpo, name, 15, tmp_path, "ours")
    ref = _run(jax_hpo, name, 15, tmp_path, "ref")
    assert _history(ours) == _history(ref)
    cross = hpo.load_study("s", f"sqlite:///{tmp_path}/ref.db")
    back = jax_hpo.load_study("s", f"sqlite:///{tmp_path}/ours.db")
    assert _history(cross) == _history(back) == _history(ref)


PRUNERS = {
    "median": lambda p: p.MedianPruner(n_startup_trials=3, n_warmup_steps=1),
    "SHA": lambda p: p.SuccessiveHalvingPruner(),
    "nopruner": lambda p: p.NopPruner(),
}


@pytest.mark.parametrize("name", list(PRUNERS))
def test_pruner_decisions_match_reference(name):
    def run(pkg):
        decisions = []

        def objective(t):
            x = t.suggest_float("x", 0, 1)
            for step in range(6):
                t.report(x / (step + 1), step)
                prune = t.should_prune()
                decisions.append((t.number, step, prune))
                if prune:
                    raise pkg.TrialPruned()
            return x

        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0),
                                 pruner=PRUNERS[name](pkg.pruners))
        study.optimize(objective, n_trials=25)
        return decisions, [(t.state, t.value, t.intermediate_values) for t in study.trials]

    ours, ref = run(hpo), run(jax_hpo)
    assert ours == ref
    assert any(p for _, _, p in ours[0]) == (name != "nopruner")


def _nas_config(cls, **kw):
    return cls(
        base_batch_size=None, g_lr=None, d_lr=None, optimizer=None, d_optimizer=None,
        adam_beta1=None, adam_beta2=None, d_adam_beta2=None, rho=None, d_rho=None,
        momentum=None, mixing_nimg=64, stabilizing_nimg=64,
        kernel_spec=[[[], [None, 3, None]], [[3, None, 3], [None, None, None]]],
        filter_spec=[[None, 16], [None, None]], conv_kernel_size=[None, 3, None], **kw)


_FIELDS = sorted({f.name for f in dataclasses.fields(Config)}
                 & {f.name for f in dataclasses.fields(JaxConfig)})
VARIANTS = {
    "shared": dict(),
    "different": dict(d_use_different_optimizer=True, d_use_different_beta2=True,
                      d_use_different_rho=True),
    "square_kernels": dict(optuna_square_kernels=True, g_lr_increase="linear",
                           g_lr_rise_niter=8),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_space_matches_reference(variant, seed):
    """One seeded trial of each engine fills the same fields with the same values, in the
    same order of draws (the params dicts compare with their order)."""
    kw = VARIANTS[variant]
    jtrial = jax_hpo.create_study(sampler=jax_hpo.samplers.RandomSampler(seed=seed)).ask()
    trial = hpo.create_study(sampler=hpo.samplers.RandomSampler(seed=seed)).ask()
    ref = jax_override(_nas_config(JaxConfig, **kw), jtrial)
    ours = optuna_override_undefined(_nas_config(Config, **kw), trial)
    assert list(trial.params.items()) == list(jtrial.params.items())
    assert {f: getattr(ours, f) for f in _FIELDS} == {f: getattr(ref, f) for f in _FIELDS}
    assert ours.optimizer in ("Adam", "SGD", "Adadelta") and ours.g_lr is not None


def test_search_space_replays_a_fixed_trial_as_the_reference():
    params = hpo.create_study(sampler=hpo.samplers.RandomSampler(seed=5)).ask()
    optuna_override_undefined(_nas_config(Config), params)
    ref = jax_override(_nas_config(JaxConfig), jax_harness.FixedTrial(params.params))
    ours = optuna_override_undefined(_nas_config(Config), harness.FixedTrial(params.params))
    assert {f: getattr(ours, f) for f in _FIELDS} == {f: getattr(ref, f) for f in _FIELDS}
    with pytest.raises(KeyError, match="predates"):
        optuna_override_undefined(_nas_config(Config), harness.FixedTrial({}))


def test_engine_is_the_one_in_use_and_matches_the_reference_api():
    assert not hpo.USING_REAL_OPTUNA and hpo.create_study is engine.create_study
    assert hpo.get_predefined_lr_schedules() == jax_hpo.get_predefined_lr_schedules()
    names = {n for n in dir(jax_hpo.engine) if not n.startswith("__")}
    assert names <= {n for n in dir(engine) if not n.startswith("__")}
