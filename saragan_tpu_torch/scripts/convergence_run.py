"""The cubic convergence-to-quality run (counterpart of ``scripts/convergence_run.py``):
any family through phases 1 -> 4 (4³ -> 32³, or further) on the synthetic blob volumes
(1-3 gaussian ellipsoids on a smooth background, ``_evidence.make_blob_volume``) with the
reference's recipe: WGAN-GP simultaneous, EMA, the mixing fade, phase chaining by name,
bf16.  The proxy FID (``RandomConvFeatures(seed=7)``, uncalibrated, comparable within the
run only) and SWD at every metric pass; the gate is the seed-band gate plus "the last
phase improves".

stylegan2 has no progressive alpha (the reference's main.py:413-414): its run is one phase
from scratch at the ending phase's resolution; every other family trains the schedule.

Run::

    python -m saragan_tpu_torch.scripts.convergence_run <outdir> [ending_phase=4]
        [starting_phase=1] [arch=pgan] [--seed 42] [--smoke] [--device cpu]

A run from ``starting_phase`` above 1 chains from ``<outdir>/logs/model_<start-1>``.
Writes ``<outdir>/trajectory.json`` after every metric pass; exits non-zero when the gate
fails.
"""

from __future__ import annotations

import argparse
import os
import sys

from saragan_tpu_torch import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.metrics.fid import RandomConvFeatures
from saragan_tpu_torch.metrics.save_metrics import make_metrics_callback
from saragan_tpu_torch.scripts import _evidence as ev


def cubic_config(arch: str, dataroot: str, logdir: str, starting_phase: int,
                 ending_phase: int, seed: int, smoke: bool, mean: float, std: float) -> Config:
    """The JAX driver's ``Config`` (``convergence_run.py:113-163``), with the fused kernel
    for pgan (the same function as its unfused ops)."""
    master = 4 * 2 ** (ending_phase - 1)
    return Config(
        architecture=arch,
        dataset_path=dataroot,
        start_shape="(1, 4, 4, 4)",
        # phases 1..ending_phase -> 4..master (the final shape one above the master)
        final_shape=f"(1, {2 * master}, {2 * master}, {2 * master})",
        starting_phase=starting_phase,
        ending_phase=ending_phase,
        continue_path=(os.path.join(logdir, f"model_{starting_phase - 1}")
                       if starting_phase > 1 and arch != "stylegan2" else None),
        latent_dim=64,
        network_size="xs",
        base_batch_size=8 if smoke else 64,
        max_global_batch_size=8 if smoke else 64,
        mixing_nimg=16 if smoke else 4096,
        stabilizing_nimg=16 if smoke else 8192,
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
        compute_swds=True,
        compute_mses=True,
        num_metric_samples=8 if smoke else 32,
        metrics_batch_size=8 if smoke else 32,
        metrics_every_nsteps=16 if smoke else 6144,
        summary_small_every_nsteps=2048,
        grad_histograms=False,
        summary_large_every_nsteps=10**9,
        checkpoint_every_nsteps=10**9,
        compute_dtype="bfloat16",
        transfer_dtype="auto",
        fused_transitions=True,
        use_pallas_fusion=arch == "pgan",
        seed=seed,
        logdir=logdir,
    ).finalize()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("outdir")
    p.add_argument("ending_phase", nargs="?", type=int, default=4)
    p.add_argument("starting_phase", nargs="?", type=int, default=1)
    p.add_argument("arch", nargs="?", default="pgan")
    args = ev.add_common(p).parse_args(argv)
    device = resolve_device(args.device)
    start, end = args.starting_phase, args.ending_phase
    if args.arch == "stylegan2":
        start = end  # one phase from scratch at the target resolution
    master = 4 * 2 ** (end - 1)
    os.makedirs(args.outdir, exist_ok=True)
    dataroot = os.path.join(args.outdir, "data")
    mean, std = ev.cubic_dataset(dataroot, master, n=48 if args.smoke else 384)
    print(f"data mean {mean:.4f} std {std:.4f}", flush=True)

    cfg = cubic_config(args.arch, dataroot, os.path.join(args.outdir, "logs"), start, end,
                       args.seed, args.smoke, mean, std)
    extractor = RandomConvFeatures(seed=7, out_dim=ev.feature_dim(args), device=device)
    rec, wall = ev.train(cfg, make_metrics_callback(cfg, extractor=extractor),
                         os.path.join(args.outdir, "trajectory.json"), device)
    verdict = ev.band_gate(rec.trajectory, require_final_improved=True)
    return ev.conclude(rec, wall, verdict, "CONVERGENCE OK", args.smoke,
                       f"CONVERGENCE SMOKE OK ({args.arch}; no convergence gate on a toy "
                       f"budget)", arch=args.arch, seed=args.seed)


if __name__ == "__main__":
    sys.exit(main())
