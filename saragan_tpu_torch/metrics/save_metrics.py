"""The metric pass (counterpart of ``saragan_tpu/metrics/save_metrics.py``).

Draws real batches from the dataset and fake batches from the caller's sampler until
``num_metric_samples`` samples are consumed, computes the enabled metrics per batch (FID
from activations pooled over all batches), averages, writes the scalars under the
reference's tag names (``fid``, ``PSNR``, ``ssim``, ``MSE``, ``NRMSE``, ``swd_<lod>`` /
``swd_mean``, each with the caller's suffix) and returns the metrics dict (keys ``FID``,
``psnr``, ``ssim``, ``mse``, ``nrmse``, ``swd``).

The sampler's contract is ``sample_fn(generator, n)`` with a ``torch.Generator``: the
fakes of a pass come from one generator seeded with ``global_step + 1`` (the reference
splits ``PRNGKey(global_step + 1)``), so the two packages' fakes differ; tests hand both
the same arrays through a stub sampler.  The feature extractor runs on its device; the
metric arithmetic is numpy and scipy on the host, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from saragan_tpu_torch.config import parse_tuple
from saragan_tpu_torch.data.normalize import normalize_numpy
from saragan_tpu_torch.metrics.fid import (calculate_fid_given_batch_volumes,
                                           default_extractor, frechet_distance,
                                           volume_batch_activations)
from saragan_tpu_torch.metrics.skim import (get_mean_squared_error, get_normalized_root_mse,
                                            get_psnr, get_ssim)
from saragan_tpu_torch.metrics.swd import get_swd_for_volumes


def save_metrics(
    writer,
    sample_fn: Callable[[torch.Generator, int], np.ndarray],
    npy_data,
    batch_size: int,
    global_size: int,
    global_step: int,
    imagesize_xy: int,
    compute_metrics: Dict[str, bool],
    num_metric_samples: int,
    data_mean: Optional[float],
    data_stddev: Optional[float],
    verbose: bool = False,
    suffix: str = "",
    extractor=None,
    generator: Optional[torch.Generator] = None,
    fid_mode: str = "pooled",
    allow_uncalibrated_fid: bool = False,
    inception_weights: Optional[str] = None,
) -> Dict[str, float]:
    """sample_fn(generator, n) -> (n, C, ...) generated batch (host numpy).

    fid_mode: "pooled" (default) pools the activations of every metric batch into one
    set and computes one Frechet distance over all ``num_metric_samples`` (FID is biased
    at small sample counts); "per_batch" averages one FID per batch, the reference's
    literal loop (save_metrics.py:156-213)."""
    compute_metrics = dict(compute_metrics)
    # size gates (reference save_metrics.py:77-79)
    compute_metrics["compute_swds"] = imagesize_xy >= 16 and compute_metrics.get(
        "compute_swds", False)
    min_dim = min(npy_data.shape[1:]) if hasattr(npy_data, "shape") else imagesize_xy
    compute_metrics["compute_ssims"] = min_dim >= 16 and compute_metrics.get(
        "compute_ssims", False)

    if generator is None:
        generator = torch.Generator().manual_seed(global_step + 1)

    fids_local, swds_local, psnrs_local, mses_local, nrmses_local, ssims_local = (
        [], [], [], [], [], [])
    acts_real_pool, acts_fake_pool = [], []
    metrics: Dict[str, float] = {}

    if compute_metrics.get("compute_FID") and extractor is None:
        # a direct call honours the same opt-in flags as make_metrics_callback
        extractor = default_extractor(allow_uncalibrated=allow_uncalibrated_fid,
                                      npz_path=inception_weights)

    # the counter advances by the samples consumed: every batch is visible to this
    # process, so num_metric_samples means what it says whatever global_size is
    counter = 0
    while counter < num_metric_samples:
        n = max(min(batch_size, num_metric_samples - counter), 1)
        real_batch = normalize_numpy(npy_data.batch(n), data_mean, data_stddev).astype(
            np.float32)
        fake_batch = np.asarray(sample_fn(generator, real_batch.shape[0]), np.float32)

        if compute_metrics.get("compute_FID"):
            if fid_mode == "pooled":
                ar, af = volume_batch_activations(real_batch, fake_batch, extractor=extractor,
                                                  verbose=verbose)
                acts_real_pool.append(ar)
                acts_fake_pool.append(af)
            else:
                fids_local.append(calculate_fid_given_batch_volumes(
                    real_batch, fake_batch, extractor=extractor, verbose=verbose))
        if compute_metrics.get("compute_swds"):
            swds = get_swd_for_volumes(real_batch, fake_batch)
            if swds is not None:
                swds_local.append(swds)
        if compute_metrics.get("compute_psnrs"):
            psnrs_local.append(get_psnr(real_batch, fake_batch))
        if compute_metrics.get("compute_ssims"):
            ssims_local.append(np.mean(get_ssim(real_batch, fake_batch)))
        if compute_metrics.get("compute_mses"):
            mses_local.append(get_mean_squared_error(real_batch, fake_batch))
        if compute_metrics.get("compute_nrmses"):
            nrmses_local.append(get_normalized_root_mse(real_batch, fake_batch))

        counter += real_batch.shape[0]

    scalars: Dict[str, float] = {}
    if compute_metrics.get("compute_FID") and acts_real_pool:
        fids_local = [frechet_distance(np.concatenate(acts_real_pool, axis=0),
                                       np.concatenate(acts_fake_pool, axis=0))]
    if compute_metrics.get("compute_FID") and fids_local:
        fid = float(np.mean(fids_local))
        metrics["FID"] = fid
        scalars["fid" + suffix] = fid
        if verbose:
            print(f"FID: {fid:.4f}")
    if compute_metrics.get("compute_psnrs") and psnrs_local:
        psnr = float(np.mean(psnrs_local))
        metrics["psnr"] = psnr
        scalars["PSNR" + suffix] = psnr
        if verbose:
            print(f"PSNR: {psnr:.4f}")
    if compute_metrics.get("compute_ssims") and ssims_local:
        ssim = float(np.mean(ssims_local))
        metrics["ssim"] = ssim
        scalars["ssim" + suffix] = ssim
        if verbose:
            print(f"SSIM: {ssim}")
    if compute_metrics.get("compute_mses") and mses_local:
        mse = float(np.mean(mses_local))
        metrics["mse"] = mse
        scalars["MSE" + suffix] = mse
        if verbose:
            print(f"MSE: {mse:.4f}")
    if compute_metrics.get("compute_nrmses") and nrmses_local:
        nrmse = float(np.mean(nrmses_local))
        metrics["nrmse"] = nrmse
        scalars["NRMSE" + suffix] = nrmse
        if verbose:
            print(f"Normalized Root MSE: {nrmse:.4f}")
    if compute_metrics.get("compute_swds") and swds_local:
        swds = np.array(swds_local).mean(axis=0)
        metrics["swd"] = swds
        if verbose:
            print(f"SWDS: {swds}")
        for i in range(len(swds) - 1):
            lod = 16 * 2**i
            scalars[f"swd_{lod}" + suffix] = float(swds[i])
        scalars["swd_mean" + suffix] = float(swds[-1])

    if writer is not None and scalars:
        writer.scalars(scalars, global_step)

    return metrics


def metric_flags(cfg) -> Dict[str, bool]:
    """The ``compute_*`` switches of a Config, as ``save_metrics`` takes them."""
    return {k: getattr(cfg, k) for k in ("compute_FID", "compute_swds", "compute_ssims",
                                         "compute_psnrs", "compute_mses", "compute_nrmses")}


def make_metrics_callback(cfg, extractor=None, device=None):
    """``save_metrics`` as the ``Trainer``'s metrics callback:
    ``callback(trainer, sampler, dataset, step, suffix) -> metrics``, with
    ``sampler(generator, n)``.

    With ``cfg.compute_FID`` the extractor is resolved here, once, on `device` (CUDA
    unless named): a run without Inception weights fails at start, unless
    ``cfg.allow_uncalibrated_fid`` opts in to the random features.  The callback carries
    ``fid_calibrated`` so that an HPO pruner can be kept from uncalibrated values."""
    if extractor is None and cfg.compute_FID:
        extractor = default_extractor(allow_uncalibrated=cfg.allow_uncalibrated_fid,
                                      npz_path=cfg.inception_weights, device=device)

    compute = metric_flags(cfg)

    def callback(trainer, sampler, dataset, step, suffix):
        phase = trainer.phase
        imagesize_xy = parse_tuple(cfg.start_shape)[-1] * 2 ** (phase - 1)
        num = cfg.num_metric_samples
        if not num:
            bs = cfg.batch_size_for_phase(phase, trainer.global_size)
            num = bs * trainer.global_size if bs > 1 else 2 * trainer.global_size
        return save_metrics(
            trainer.writer if trainer.verbose else None, sampler, dataset,
            cfg.metrics_batch_size, trainer.global_size, step, imagesize_xy, compute, num,
            cfg.data_mean, cfg.data_stddev, verbose=trainer.verbose, suffix=suffix,
            extractor=extractor)

    callback.fid_calibrated = getattr(extractor, "calibrated", True)
    return callback
