"""Hyperparameter optimization (counterpart of ``saragan_tpu/hpo``).

The reference drives its studies through Optuna.  When an ``optuna`` package is
importable it is used, as the reference does; otherwise the port's own engine
(``hpo.engine``: numpy and sqlite3, draw for draw the reference's engine) provides the
same study, trial, sampler and pruner API with SQLite storage that several worker
processes can share.
"""

try:  # pragma: no cover - depends on the environment
    import optuna as _optuna

    create_study = _optuna.create_study
    load_study = _optuna.load_study
    TrialPruned = _optuna.TrialPruned
    samplers = _optuna.samplers
    pruners = _optuna.pruners
    USING_REAL_OPTUNA = True
except ImportError:
    from saragan_tpu_torch.hpo.engine import (  # noqa: F401
        TrialPruned,
        create_study,
        load_study,
        pruners,
        samplers,
    )

    USING_REAL_OPTUNA = False

from saragan_tpu_torch.hpo.suggestions import (  # noqa: F401
    get_predefined_lr_schedules,
    optuna_override_undefined,
)
