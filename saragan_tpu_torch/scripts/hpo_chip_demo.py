"""The HPO harness on real training trials (counterpart of ``scripts/hpo_chip_demo.py``):
trials of 3-D pgan, phases 1 -> 3 (4³ -> 16³) on the cubic blob volumes, each sampling
both learning rates (left None) and scored by the run-internal proxy FID (random
features, uncalibrated; comparable within one study).  Samplers: TPE (default), CMA, and
the multi-objective NSGAII and MOTPE, which score (FID, train time) and report the Pareto
front.  Mode ``nas`` searches per-layer kernel shapes and filter counts with the learning
rates pinned; ``hpo_seeds`` k > 1 trains every trial under k seeds and optimises the
median, reporting whether the ranking survives reseeding.

Gates: single-objective, the best trial beats the median; multi-objective, a front of
finite values that holds the best-FID trial and leaves out a dominated trial; ``nas``,
every trial sampled the architectural knobs and more than one architecture was tried; at
most one trial failed.

Run::

    python -m saragan_tpu_torch.scripts.hpo_chip_demo <outdir> [ntrials=8] [sampler=TPE]
        [mode=lr] [hpo_seeds=1] [--smoke] [--device cpu]

The study lives in ``<outdir>/study.db``; exits non-zero when a gate fails (under
``--smoke``, phases 1 -> 2 on toy budgets, the comparisons are not gated).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import time

import numpy as np

from saragan_tpu_torch import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.hpo import harness
from saragan_tpu_torch.metrics.fid import RandomConvFeatures
from saragan_tpu_torch.scripts import _evidence as ev


def demo_config(outdir: str, dataroot: str, ntrials: int, sampler: str, mode: str,
                hpo_seeds: int, smoke: bool, mean: float, std: float) -> Config:
    """The JAX driver's ``Config`` (``hpo_chip_demo.py:58-133``)."""
    cfg = Config(
        architecture="pgan",
        dataset_path=dataroot,
        start_shape="(1, 4, 4, 4)",
        final_shape="(1, 32, 32, 32)",  # phases 1-3 -> 4, 8, 16
        starting_phase=1,
        ending_phase=2 if smoke else 3,
        latent_dim=64,
        network_size="xs",
        base_batch_size=8 if smoke else 64,
        max_global_batch_size=8 if smoke else 64,
        mixing_nimg=8 if smoke else 2048,
        stabilizing_nimg=8 if smoke else 4096,
        loss_fn="wgan",
        gp_weight=10.0,
        noise_stddev=0.0,
        adam_beta1=0.0,
        adam_beta2=0.9,
        g_lr=None,  # sampled by the trial
        d_lr=None,
        ema_beta=0.99,
        data_mean=mean,
        data_stddev=std,
        calc_metrics=True,
        compute_FID=True,
        allow_uncalibrated_fid=True,  # run-internal objective only
        num_metric_samples=8 if smoke else 32,
        metrics_batch_size=8 if smoke else 32,
        metrics_every_nsteps=10**9,  # end-of-phase metrics only
        summary_small_every_nsteps=4096,
        grad_histograms=False,
        summary_large_every_nsteps=10**9,
        checkpoint_every_nsteps=10**9,
        compute_dtype="bfloat16",
        fused_transitions=True,
        use_pallas_fusion=True,
        optuna_ntrials=ntrials,
        optuna_storage=f"sqlite:///{outdir}/study.db",
        optuna_study_name="chip_demo",
        optuna_sampler=sampler,
        optuna_pruner="nopruner",
        hpo_seeds=hpo_seeds,
        logdir=os.path.join(outdir, "logs"),
    )
    if hpo_seeds > 1 and not smoke:
        # k trainings per trial: half the per-leg budget
        cfg = dataclasses.replace(cfg, mixing_nimg=1024, stabilizing_nimg=2048)
    if mode == "nas":
        # None entries in the specs are what the NAS suggestions fill; the learning rates
        # and their schedules pinned flat, so that only the architecture varies
        cfg = dataclasses.replace(
            cfg, g_lr=0.0545, d_lr=0.0141,
            g_lr_rise_niter=1, g_lr_decay_niter=1, d_lr_rise_niter=1, d_lr_decay_niter=1,
            optuna_square_kernels=True,
            kernel_spec=[[[], [None, None, None]],
                         [[None, None, None], [None, None, None]],
                         [[None, None, None], [None, None, None]]],
            filter_spec=[[None, None], [None, None], [None, None]],
            optuna_study_name="chip_demo_nas")
    return cfg


def check(cond, msg, failures):
    if not cond:
        failures.append(msg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("outdir")
    p.add_argument("ntrials", nargs="?", type=int, default=8)
    p.add_argument("sampler", nargs="?", default="TPE")
    p.add_argument("mode", nargs="?", default="lr", choices=["lr", "nas"])
    p.add_argument("hpo_seeds", nargs="?", type=int, default=1)
    args = ev.add_common(p, seed=None).parse_args(argv)
    device = resolve_device(args.device)
    dataroot = os.path.join(args.outdir, "data")
    os.makedirs(args.outdir, exist_ok=True)
    print("Building synthetic blob pyramid ...", flush=True)
    mean, std = ev.build_dataset(dataroot, n=32 if args.smoke else 256,
                                 master=8 if args.smoke else 16)
    cfg = demo_config(args.outdir, dataroot, args.ntrials, args.sampler, args.mode,
                      args.hpo_seeds, args.smoke, mean, std)
    # the harness's default extractor (2048-d random features, seed 1234) but on a toy budget
    extractor = (RandomConvFeatures(out_dim=ev.SMOKE_FEATURE_DIM, device=device)
                 if args.smoke else None)
    objective = functools.partial(harness.default_objective, device=device,
                                  extractor=extractor)
    t0 = time.time()
    study = harness.run(cfg, objective=objective)
    wall = time.time() - t0
    failures = []

    if harness.is_multi_objective(cfg):
        done = [t for t in study.trials if t.state == "COMPLETE" and t.values]
        front = study.best_trials
        front_nums = {t.number for t in front}
        print(f"{len(done)}/{args.ntrials} trials complete in {wall:.0f}s")
        for t in done:
            tag = "FRONT" if t.number in front_nums else "     "
            print(f"  {tag} trial {t.number}: FID {t.values[0]:.3f}  "
                  f"train_s {t.values[1]:.1f}  params {t.params}")
        check(len(done) >= args.ntrials - 1, "trials failed", failures)
        check(front and all(np.isfinite(v) for t in front for v in t.values),
              "the front is empty or not finite", failures)
        if done and front:
            check(min(t.values[0] for t in front) == min(t.values[0] for t in done),
                  "the front lacks the best-FID trial", failures)
        if not args.smoke:
            check(len(front) < len(done), "no trial was dominated: the front is vacuous",
                  failures)
        ok_line = f"HPO MULTI-OBJECTIVE DEMO OK: front {len(front)}/{len(done)}"
    else:
        done = [t for t in study.trials if t.state == "COMPLETE" and t.value is not None]
        values = sorted(float(t.value) for t in done)
        print(f"{len(done)}/{args.ntrials} trials complete in {wall:.0f}s")
        if values:
            print(f"proxy-FID best {values[0]:.3f}  median {np.median(values):.3f}  "
                  f"worst {values[-1]:.3f}")
            print(f"best params: {study.best_trial.params}")
        check(len(done) >= args.ntrials - 1, "trials failed", failures)
        if args.hpo_seeds > 1:
            rows = []
            for t in done:
                sv = t.user_attrs.get("seed_values")
                check(sv and len(sv) == args.hpo_seeds,
                      f"trial {t.number} lacks its seed values", failures)
                if sv:
                    rows.append((t.number, float(t.value), sv))
                    print(f"  trial {t.number}: median {t.value:.3f}  seeds "
                          f"{[round(v, 2) for v in sv]}  spread {max(sv) - min(sv):.3f}")
            if rows:
                by_median = sorted(rows, key=lambda r: r[1])
                winner = by_median[0][0]
                per_seed = [min(rows, key=lambda r: r[2][j])[0] for j in range(args.hpo_seeds)]
                spreads = [max(sv) - min(sv) for _, _, sv in rows]
                gaps = [b[1] - a[1] for a, b in zip(by_median, by_median[1:])]
                survives = all(w == winner for w in per_seed)
                print(f"median-ranking winner: trial {winner}; per-seed winners: {per_seed} "
                      f"-> ranking {'SURVIVES' if survives else 'DOES NOT SURVIVE'} reseeding")
                print(f"median per-trial seed spread {np.median(spreads):.3f} vs median "
                      f"between-trial gap {np.median(gaps) if gaps else 0:.3f}")
        if args.mode == "nas":
            archs = set()
            for t in done:
                keys = [k for k in t.params if k.startswith(("Kernel_size_", "Filter_count_"))]
                check(keys, f"trial {t.number} sampled no NAS parameters", failures)
                archs.add(tuple(sorted((k, t.params[k]) for k in keys)))
            if not args.smoke:
                check(len(archs) > 1, "the NAS sweep explored a single architecture", failures)
        if not args.smoke and values:
            check(values[0] < np.median(values), "the sampler found nothing better than the "
                  "median", failures)
        ok_line = "HPO NAS DEMO OK" if args.mode == "nas" else "HPO DEMO OK"
    if failures:
        print("GATE FAILED (hpo): " + "; ".join(failures), flush=True)
        return 1
    print(ok_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
