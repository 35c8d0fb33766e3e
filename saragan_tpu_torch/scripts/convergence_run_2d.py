"""The 2-D convergence-to-quality run (counterpart of ``scripts/convergence_run_2d.py``):
2-D pgan through the JPEG class-folder pipeline (decode, resize per phase) and the same
phase driver, phases 1 -> 4 (4² -> 32²) on synthetic blob JPEGs
(``_evidence.make_blob_image``, 64² grayscale saved as RGB) with the full recipe
(WGAN-GP simultaneous, EMA, the mixing fade, phase chaining, bf16, the fused kernel).

The metric is the proxy FID (``RandomConvFeatures(seed=7)``, uncalibrated, comparable
within the run only) of each NCHW batch taken as a depth-1 NCDHW volume (the FID pipeline
is per z-slice, so a depth-1 volume is the 2-D metric), plus MSE; SWD is 3-D only, as in
the reference.  The gate holds each regressing phase to its measured 2-D cap.

Run::

    python -m saragan_tpu_torch.scripts.convergence_run_2d <outdir> [ending_phase=4]
        [mixing_nimg=4096] [stabilizing_nimg=8192] [--seed 42] [--smoke] [--device cpu]

Writes ``<outdir>/trajectory_2d.json`` after every metric pass; exits non-zero when the
gate fails.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from saragan_tpu_torch import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.metrics.fid import (RandomConvFeatures, frechet_distance,
                                           volume_batch_activations)
from saragan_tpu_torch.metrics.skim import get_mean_squared_error
from saragan_tpu_torch.scripts import _evidence as ev


def config_2d(dataroot: str, logdir: str, ending_phase: int, mixing_nimg: int,
              stabilizing_nimg: int, seed: int) -> Config:
    """The JAX driver's ``Config`` (``convergence_run_2d.py:83-130``) with the fused
    kernel."""
    n_phases = ending_phase
    return Config(
        architecture="pgan",
        dataset_path=dataroot,
        dataset="imagenet",
        start_shape="(1, 4, 4)",  # grayscale: the adapter decodes L-mode
        final_shape=f"(1, {4 * 2 ** n_phases}, {4 * 2 ** n_phases})",
        starting_phase=1,
        ending_phase=ending_phase,
        latent_dim=64,
        base_batch_size=64,
        max_global_batch_size=64,
        mixing_nimg=mixing_nimg,
        stabilizing_nimg=stabilizing_nimg,
        kernel_spec=[[[], [3, 3]]] + [[[3, 3], [3, 3]]] * (n_phases - 1),
        filter_spec=[[32, 32]] * n_phases,
        conv_kernel_size=(3, 3),
        loss_fn="wgan",
        gp_weight=10.0,
        noise_stddev=0.0,
        adam_beta1=0.0,
        adam_beta2=0.9,
        g_lr=1e-3,
        d_lr=1e-3,
        ema_beta=0.99,
        # the JPEG pipeline already yields [-1, 1]
        data_mean=0.0,
        data_stddev=1.0,
        calc_metrics=True,
        metrics_every_nsteps=min(6144, mixing_nimg + stabilizing_nimg),
        summary_small_every_nsteps=2048,
        summary_large_every_nsteps=10**9,
        checkpoint_every_nsteps=10**9,
        compute_dtype="bfloat16",
        transfer_dtype="auto",
        fused_transitions=True,
        use_pallas_fusion=True,
        seed=seed,
        logdir=logdir,
    ).finalize()


def metrics_2d(extractor, n: int):
    """The 2-D metric pass: `n` real images against `n` fakes drawn from a generator
    seeded by the step, FID over depth-1 volumes and MSE."""

    def callback(trainer, sampler, dataset, step, suffix):
        rng = np.random.default_rng(step + 1)
        real = np.asarray(dataset.batch(n), np.float32)
        gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
        fake = np.asarray(sampler(gen, n), np.float32)
        # NCHW -> depth-1 NCDHW: the FID pipeline is per z-slice already
        ar, af = volume_batch_activations(real[:, :, None], fake[:, :, None],
                                          extractor=extractor, verbose=False)
        return {"FID": float(frechet_distance(ar, af)),
                "MSE": float(get_mean_squared_error(real, fake))}

    return callback


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("outdir")
    p.add_argument("ending_phase", nargs="?", type=int, default=4)
    p.add_argument("mixing_nimg", nargs="?", type=int, default=None)
    p.add_argument("stabilizing_nimg", nargs="?", type=int, default=None)
    args = ev.add_common(p).parse_args(argv)
    device = resolve_device(args.device)
    mixing = args.mixing_nimg or (64 if args.smoke else 4096)
    stabilizing = args.stabilizing_nimg or (64 if args.smoke else 8192)
    dataroot = os.path.join(args.outdir, "data")
    os.makedirs(args.outdir, exist_ok=True)
    if not os.path.isdir(os.path.join(dataroot, "train", "n001")):
        print(f"Building synthetic blob JPEGs ({ev.MASTER_2D}x{ev.MASTER_2D}) ...", flush=True)
        ev.build_dataset_2d(dataroot, n=40 if args.smoke else 400)
    else:
        print("Reusing existing blob JPEGs", flush=True)

    cfg = config_2d(dataroot, os.path.join(args.outdir, "logs"), args.ending_phase, mixing,
                    stabilizing, args.seed)
    extractor = RandomConvFeatures(seed=7, out_dim=ev.feature_dim(args), device=device)
    rec, wall = ev.train(cfg, metrics_2d(extractor, 8 if args.smoke else 64),
                         os.path.join(args.outdir, "trajectory_2d.json"), device)
    return ev.conclude(rec, wall, ev.caps_gate_2d(rec.trajectory), "CONVERGENCE 2D OK",
                       args.smoke, "CONVERGENCE 2D SMOKE OK", ev.LAST_SUFFIXES_2D,
                       seed=args.seed)


if __name__ == "__main__":
    sys.exit(main())
