"""Training dynamics across the model zoo (counterpart of
``scripts/family_chip_smoke.py``): the five families other than pgan (pgan2, pgandeep,
stylegan, stylegan2, surfgan), one single-phase WGAN-GP run each at phase 3 (16³) on the
cubic blob volumes of ``convergence_run``.  The gate: each family's generator moves its
sample moments toward the data's (|mean| + |std - 1| in normalised units, first pass
against the better of the two end-of-phase passes) and its losses stay finite.  A dynamics
check, not a quality benchmark.

Run::

    python -m saragan_tpu_torch.scripts.family_chip_smoke <outdir> [families...]
        [--mixing_nimg 2048] [--stabilizing_nimg 30720] [--seed 42] [--smoke]
        [--device cpu]

Writes ``<outdir>/family_smoke.json`` after each family; exits non-zero when the gate
fails (under ``--smoke``, phase 1 on toy budgets, only finiteness is enforced).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from saragan_tpu_torch import resolve_device
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.scripts import _evidence as ev
from saragan_tpu_torch.train.trainer import Trainer

FAMILIES = ["pgan2", "pgandeep", "stylegan", "stylegan2", "surfgan"]
PHASE, MASTER = 3, 16  # 16³ volumes
SMOKE_PHASE, SMOKE_MASTER = 1, 4


def family_config(arch: str, dataroot: str, logdir: str, phase: int, master: int,
                  mixing: int, stabilizing: int, seed: int, smoke: bool, mean: float,
                  std: float) -> Config:
    """The JAX driver's ``Config`` (``family_chip_smoke.py:56-90``)."""
    return Config(
        architecture=arch,
        dataset_path=dataroot,
        start_shape="(1, 4, 4, 4)",
        final_shape=f"(1, {2 * master}, {2 * master}, {2 * master})",
        starting_phase=phase,
        ending_phase=phase,
        latent_dim=64,
        network_size="xs",
        base_batch_size=8 if smoke else 64,
        max_global_batch_size=8 if smoke else 64,
        mixing_nimg=mixing,
        stabilizing_nimg=stabilizing,
        loss_fn="wgan",
        gp_weight=10.0,
        noise_stddev=0.0,
        adam_beta1=0.0,
        adam_beta2=0.9,
        g_lr=5e-4,
        d_lr=5e-4,
        ema_beta=0.99,
        data_mean=mean,
        data_stddev=std,
        calc_metrics=True,
        metrics_every_nsteps=16 if smoke else 8192,
        num_metric_samples=8 if smoke else 32,
        metrics_batch_size=8 if smoke else 32,
        summary_small_every_nsteps=4096,
        summary_large_every_nsteps=10**9,
        checkpoint_every_nsteps=10**9,
        compute_dtype="bfloat16",
        transfer_dtype="auto",
        seed=seed,
        logdir=logdir,
    ).finalize()


def run_family(arch: str, cfg: Config, device, n_samples: int) -> dict:
    moments = []

    def moment_cb(trainer, sampler, dataset, step, suffix):
        # normalised units: the data is ~N(0, 1) after (x - mean) / std
        vols = np.asarray(sampler(torch.Generator().manual_seed(step + 1), n_samples))
        err = abs(float(vols.mean())) + abs(float(vols.std()) - 1.0)
        moments.append({"step": int(step), "suffix": suffix, "moment_err": err})
        print(f"[{arch}] step {step}{suffix or ''}: moment_err {err:.4f}", flush=True)
        return {}

    moment_cb.fid_calibrated = False
    t0 = time.time()
    Trainer(cfg, metrics_callback=moment_cb, verbose=True, prefetch=True, device=device).run()
    wall = time.time() - t0
    with open(os.path.join(cfg.logdir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = [e["value"] for e in events if e["tag"] in ("Loss/d_loss", "Loss/g_loss")]
    errs = [m["moment_err"] for m in moments]
    first, last = errs[0], min(errs[-2:]) if len(errs) > 1 else errs[-1]
    entry = {
        "arch": arch,
        "wall_s": round(wall, 1),
        "steps_img": cfg.mixing_nimg + cfg.stabilizing_nimg,
        "first_moment_err": round(first, 4),
        "last_moment_err": round(last, 4),
        "improved": bool(last < first),
        "losses_finite": bool(losses) and all(math.isfinite(v) for v in losses),
        "n_losses": len(losses),
        "trajectory": moments,
    }
    print(f"[{arch}] moment_err {first:.4f} -> {last:.4f} "
          f"({'improved' if entry['improved'] else 'NOT improved'}), losses "
          f"{'finite' if entry['losses_finite'] else 'NOT finite'}, {wall:.0f}s", flush=True)
    return entry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("outdir")
    p.add_argument("families", nargs="*")
    p.add_argument("--mixing_nimg", type=int, default=None)
    p.add_argument("--stabilizing_nimg", type=int, default=None)
    args = ev.add_common(p).parse_args(argv)
    device = resolve_device(args.device)
    families = args.families or FAMILIES
    phase, master = (SMOKE_PHASE, SMOKE_MASTER) if args.smoke else (PHASE, MASTER)
    mixing = args.mixing_nimg or (16 if args.smoke else 2048)
    stabilizing = args.stabilizing_nimg or (16 if args.smoke else 30720)
    dataroot = os.path.join(args.outdir, "data")
    os.makedirs(args.outdir, exist_ok=True)
    mean, std = ev.cubic_dataset(dataroot, master, n=48 if args.smoke else 384)
    print(f"data mean {mean:.4f} std {std:.4f}", flush=True)

    results = []
    for arch in families:
        cfg = family_config(arch, dataroot, os.path.join(args.outdir, f"logs_{arch}"), phase,
                            master, mixing, stabilizing, args.seed, args.smoke, mean, std)
        results.append(run_family(arch, cfg, device, 8 if args.smoke else 32))
        with open(os.path.join(args.outdir, "family_smoke.json"), "w") as f:
            json.dump(results, f, indent=1)

    improved = sum(r["improved"] for r in results)
    finite = sum(r["losses_finite"] for r in results)
    print(f"\n{improved}/{len(results)} families improved moment error, {finite}/"
          f"{len(results)} with finite losses", flush=True)
    for r in results:
        print(f"  {r['arch']:10s} {r['first_moment_err']:.4f} -> "
              f"{r['last_moment_err']:.4f}  ({r['wall_s']:.0f}s)", flush=True)
    if finite < len(results):
        print("GATE FAILED (family): non-finite losses", flush=True)
        return 1
    if args.smoke:
        print("FAMILY SMOKE WIRING OK (moments not gated on a toy budget)", flush=True)
        return 0
    if improved < len(results):
        print("GATE FAILED (family): some families did not improve", flush=True)
        return 1
    print("FAMILY SMOKE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
