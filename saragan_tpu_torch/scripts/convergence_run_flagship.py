"""The flagship-aspect convergence run (counterpart of
``scripts/convergence_run_flagship.py``): the reference's anisotropic geometry, depth =
width / 4 at every phase, from start shape (1, 1, 4, 4): phase p trains
(2^(p-1), 4·2^(p-1), 4·2^(p-1)) volumes of the synthetic blob field through the plain
``Trainer`` with pgan ``xs``, WGAN-GP simultaneous, EMA, the mixing fade, phase chaining
by name, bf16 and the fused bias + leaky ReLU + pixel norm kernel:

  phases 1..6  (1,4,4) .. (32,128,128)  one process, 12 288 images a phase
  phase 7      (64,256,256)             own leg, chained from model_6, half the budget
  phase 8      (128,512,512)            own leg through ``single_chip_big_volume``

Each level of the pyramid is the same analytic field evaluated on that level's grid
(``_evidence.make_blob_volume_aniso``), so resolutions agree as the reference's Lanczos
pyramid does.  The proxy FID is ``RandomConvFeatures(seed=7)``: uncalibrated, comparable
within one run only (the port's weights come from torch's generator, not JAX's).

Run::

    python -m saragan_tpu_torch.scripts.convergence_run_flagship <outdir> [ending_phase=6]
        [starting_phase=1] [phase8_nimg=512] [continue_from] [--seed 42] [--smoke]
        [--device cpu] [--compare_with <earlier trajectory_p1-6.json>]

e.g. ``out 6`` (phases 1..6), ``out 7 7`` (the phase-7 leg, chained from
``out/logs/model_6``), ``out 8 8`` (the phase-8 leg), ``out 8 8 512 out/logs/model_8``
(a phase-8 continuation).  A leg may start at any phase: it chains from
``<outdir>/logs/model_<start-1>``.  Writes ``<outdir>/trajectory_p<a>-<b>.json`` after
every metric pass and exits non-zero when the leg's gate fails: the seed-band gate for a
schedule, fade recovery for the phase-7 leg, a finite reading for the phase-8 leg, or
(``--compare_with``) a reading that differs from an earlier run's of the same seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from saragan_tpu_torch import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.metrics.fid import RandomConvFeatures
from saragan_tpu_torch.metrics.save_metrics import make_metrics_callback
from saragan_tpu_torch.scripts import _evidence as ev


def flagship_config(dataroot: str, logdir: str, starting_phase: int, ending_phase: int,
                    seed: int, smoke: bool, mean: float, std: float,
                    phase8_nimg: int = 512, continue_from=None) -> Config:
    """The JAX driver's ``Config`` (``convergence_run_flagship.py:124-179``) plus the
    fused kernel (the same function as the unfused ops)."""
    phase8_leg = starting_phase >= 8
    big_phase = starting_phase >= 7
    return Config(
        architecture="pgan",
        dataset_path=dataroot,
        start_shape="(1, 1, 4, 4)",
        # phases 1..8 -> HW 4..512 (the final shape one doubling past phase 8)
        final_shape="(1, 256, 1024, 1024)",
        starting_phase=starting_phase,
        ending_phase=ending_phase,
        continue_path=continue_from or (
            os.path.join(logdir, f"model_{starting_phase - 1}") if starting_phase > 1 else None),
        latent_dim=64,
        network_size="xs",
        base_batch_size=8 if smoke else 64,
        max_global_batch_size=8 if smoke else 64,
        mixing_nimg=0 if phase8_leg else (16 if smoke else (2048 if big_phase else 4096)),
        stabilizing_nimg=(phase8_nimg if phase8_leg
                          else (32 if smoke else (4096 if big_phase else 8192))),
        loss_fn="wgan",
        gp_weight=10.0,
        noise_stddev=0.0,
        adam_beta1=0.0,
        adam_beta2=0.9,
        g_lr=7.5e-4,
        d_lr=7.5e-4,
        ema_beta=0.99,
        data_mean=mean,
        data_stddev=std,
        calc_metrics=True,
        compute_FID=True,
        compute_swds=not phase8_leg,
        compute_mses=True,
        num_metric_samples=8 if (phase8_leg or smoke) else (16 if big_phase else 32),
        metrics_batch_size=2 if phase8_leg else (8 if smoke else (4 if big_phase else 32)),
        metrics_every_nsteps=(10**9 if phase8_leg
                              else (16 if smoke else (2048 if big_phase else 6144))),
        summary_small_every_nsteps=10**9 if big_phase else 2048,
        grad_histograms=False,
        summary_large_every_nsteps=10**9,
        checkpoint_every_nsteps=10**9,
        compute_dtype="bfloat16",
        transfer_dtype="auto",
        use_pallas_fusion=True,
        single_chip_big_volume=phase8_leg,
        seed=seed,
        logdir=logdir,
    ).finalize()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("outdir")
    p.add_argument("ending_phase", nargs="?", type=int, default=6)
    p.add_argument("starting_phase", nargs="?", type=int, default=1)
    p.add_argument("phase8_nimg", nargs="?", type=int, default=512)
    p.add_argument("continue_from", nargs="?", default=None)
    p.add_argument("--compare_with", default=None,
                   help="a trajectory file of an earlier run of the same seed: every reading "
                        "of the phases both hold must be bit-equal")
    args = ev.add_common(p).parse_args(argv)
    device = resolve_device(args.device)
    start, end = args.starting_phase, args.ending_phase
    dataroot = os.path.join(args.outdir, "data")
    os.makedirs(args.outdir, exist_ok=True)
    n_vols = 24 if args.smoke else 256

    print("Building anisotropic blob pyramid ...", flush=True)
    # only the levels this leg trains on
    for ph in range(start, min(end, 7) + 1):
        ev.build_level(dataroot, 4 * 2 ** (ph - 1), n=n_vols)
    if end >= 8:
        ev.build_level(dataroot, 512, n=12 if args.smoke else 48)
    mean, std = ev.aniso_stats()
    print(f"data mean {mean:.4f} std {std:.4f}", flush=True)

    cfg = flagship_config(dataroot, os.path.join(args.outdir, "logs"), start, end, args.seed,
                          args.smoke, mean, std, args.phase8_nimg, args.continue_from)
    tag = f"p{start}-{end}" + ("-cont" if args.continue_from else "")
    extractor = RandomConvFeatures(seed=7, out_dim=ev.feature_dim(args), device=device)
    rec, wall = ev.train(cfg, make_metrics_callback(cfg, extractor=extractor),
                         os.path.join(args.outdir, f"trajectory_{tag}.json"), device)

    if start >= 8:
        verdict, ok_line = ev.finite_gate(rec.trajectory, start), "PHASE8 LEG OK"
    elif start >= 7 and not args.smoke:
        verdict, ok_line = ev.recovery_gate(rec.trajectory, start), "BIG-PHASE LEG OK"
    else:
        verdict, ok_line = ev.band_gate(rec.trajectory), "CONVERGENCE FLAGSHIP OK"
    rc = ev.conclude(rec, wall, verdict, ok_line, args.smoke, "FLAGSHIP SMOKE OK",
                     seed=args.seed)
    if args.compare_with:
        with open(args.compare_with) as f:
            earlier = json.load(f)["trajectory"]
        diffs = ev.trajectory_differences(rec.trajectory, earlier)
        if diffs:
            print(f"DETERMINISM FAILED against {args.compare_with}: {diffs}", flush=True)
            return 1
        print(f"DETERMINISM OK: every reading of phases {start}-{end} bit-equal to "
              f"{args.compare_with}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
