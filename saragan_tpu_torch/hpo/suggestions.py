"""The search space (the port's own copy of ``saragan_tpu/hpo/suggestions.py``).

`optuna_override_undefined(cfg, trial)` fills every field of the port's ``Config`` left
`None` with a trial suggestion, with the reference's parameter names, ranges and order
of draws: batch-size exponent 2^[1,6], G lr log-uniform [1e-2, 1e-1], D lr log-uniform
[1e-3, 5e-2], 9 predefined LR schedules, the optimizer and its betas / rho / momentum,
and the NAS spaces over per-layer kernel shapes (odd 1-7, optionally cubic) and filter
counts (powers of two with per-phase caps).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def get_predefined_lr_schedules():
    """The nine (schedule, fraction of the phase) pairs a trial picks from."""
    return [
        {"lr_sched": None, "lr_fract": 0.5},
        {"lr_sched": "linear", "lr_fract": 0.125},
        {"lr_sched": "linear", "lr_fract": 0.25},
        {"lr_sched": "linear", "lr_fract": 0.375},
        {"lr_sched": "linear", "lr_fract": 0.5},
        {"lr_sched": "exponential", "lr_fract": 0.125},
        {"lr_sched": "exponential", "lr_fract": 0.25},
        {"lr_sched": "exponential", "lr_fract": 0.375},
        {"lr_sched": "exponential", "lr_fract": 0.5},
    ]


# filter-count exponents per phase
MAX_FILTER_COUNTS = [9, 8, 7, 7, 6, 5, 4]


def optuna_override_undefined(cfg, trial, verbose: bool = False):
    """Fill None-valued Config fields from the trial. Returns a new Config."""
    args = dataclasses.replace(cfg)

    def log(name, source):
        if verbose:
            print(f"args.{name} = {getattr(args, name)} (from: {source})")

    if not args.base_batch_size:
        args.base_batch_size = 2 ** trial.suggest_int("base_batch_size_exponent", 1, 6)
        log("base_batch_size", "optuna trial")
    else:
        log("base_batch_size", "command line argument")

    if not args.g_lr:
        args.g_lr = trial.suggest_loguniform("generator_LR", 1e-2, 1e-1)
        log("g_lr", "optuna trial")
    if not args.d_lr:
        args.d_lr = trial.suggest_loguniform("discriminator_LR", 1e-3, 5e-2)
        log("d_lr", "optuna trial")

    lr_schedule = get_predefined_lr_schedules()
    phase_len = args.mixing_nimg + args.stabilizing_nimg

    def pick_schedule(kind_attr, niter_attr, param_name):
        if getattr(args, kind_attr) is None and getattr(args, niter_attr) is None:
            idx = trial.suggest_categorical(param_name, [0, 1, 2, 3, 4, 5, 6, 7, 8])
            setattr(args, kind_attr, lr_schedule[idx]["lr_sched"])
            setattr(
                args, niter_attr,
                int(np.ceil(lr_schedule[idx]["lr_fract"] * phase_len).astype(np.int32)),
            )
            log(kind_attr, "optuna trial")
        elif getattr(args, kind_attr) is not None and getattr(args, niter_attr) is None:
            raise NotImplementedError(
                f"if you specify {kind_attr} on the command line, {niter_attr} also has to be specified."
            )

    pick_schedule("g_lr_increase", "g_lr_rise_niter", "g_lr_sched_inc")
    pick_schedule("g_lr_decrease", "g_lr_decay_niter", "g_lr_sched_dec")
    pick_schedule("d_lr_increase", "d_lr_rise_niter", "d_lr_sched_inc")
    pick_schedule("d_lr_decrease", "d_lr_decay_niter", "d_lr_sched_dec")

    if args.optimizer is None:
        args.optimizer = trial.suggest_categorical("optimizer", ["Adam", "SGD", "Adadelta"])
        log("optimizer", "optuna trial")
        if not args.d_use_different_optimizer:
            args.d_optimizer = args.optimizer
    if args.d_optimizer is None and args.d_use_different_optimizer:
        args.d_optimizer = trial.suggest_categorical(
            "d_optimizer", ["Adam", "SGD", "Momentum", "Adadelta"]
        )

    def pick_pair(attr, d_attr, use_diff, name, d_name, low, high):
        if getattr(args, attr) is None:
            setattr(args, attr, trial.suggest_float(name, low, high))
            log(attr, "optuna trial")
            if not getattr(args, use_diff):
                setattr(args, d_attr, getattr(args, attr))
        if getattr(args, d_attr) is None and getattr(args, use_diff):
            setattr(args, d_attr, trial.suggest_float(d_name, low, high))

    pick_pair("adam_beta1", "d_adam_beta1", "d_use_different_beta1", "adam_beta1", "d_adam_beta1", 0, 0.4)
    pick_pair("adam_beta2", "d_adam_beta2", "d_use_different_beta2", "adam_beta2", "d_adam_beta2", 0.75, 1)
    pick_pair("rho", "d_rho", "d_use_different_rho", "adadelta_rho", "d_adadelta_rho", 0, 1)
    pick_pair("momentum", "d_momentum", "d_use_different_momentum", "SGD_momentum", "d_SGD_momentum", 0, 1)

    # legacy conv_kernel_size odd-size NAS
    cks = list(args.conv_kernel_size) if args.conv_kernel_size else []
    for i in range(len(cks)):
        if cks[i] is None:
            cks[i] = trial.suggest_int(f"Kernel_size_{i}", 1, 9, 2)
    args.conv_kernel_size = cks

    # filter_spec NAS: powers of two capped per phase
    if args.filter_spec is not None:
        fs = [list(p) for p in args.filter_spec]
        for phase_i in range(len(fs)):
            for conv_j in range(len(fs[phase_i])):
                if fs[phase_i][conv_j] is None or fs[phase_i][conv_j] == "None":
                    cap = MAX_FILTER_COUNTS[min(phase_i, len(MAX_FILTER_COUNTS) - 1)]
                    fs[phase_i][conv_j] = 2 ** trial.suggest_int(
                        f"Filter_count_exponent_{phase_i}_{conv_j}", 2, cap
                    )
        args.filter_spec = fs

    # kernel_spec NAS: odd 1..7, optionally cubic
    if args.kernel_spec is not None:
        ks = [[list(k) for k in p] for p in args.kernel_spec]
        for phase_i in range(len(ks)):
            for conv_j in range(len(ks[phase_i])):
                for kernel_k in range(len(ks[phase_i][conv_j])):
                    if ks[phase_i][conv_j][kernel_k] in (None, "None"):
                        if args.optuna_square_kernels and kernel_k > 0:
                            ks[phase_i][conv_j][kernel_k] = ks[phase_i][conv_j][0]
                        else:
                            ks[phase_i][conv_j][kernel_k] = trial.suggest_int(
                                f"Kernel_size_{phase_i}_{conv_j}_{kernel_k}", 1, 7, 2
                            )
        args.kernel_spec = ks

    return args
