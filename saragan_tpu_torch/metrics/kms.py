"""Kolmogorov-Smirnov intensity-distribution distance (own copy of
``saragan_tpu/metrics/kms.py``, numpy only).

Port of the PyTorch prototype's `kolmogorov_smirnov_distance`
(reference `pgan_pytorch/metrics/kms.py:4-25`, called from
`pgan_pytorch/train.py:13` as `kms(real, fake, -1024, (-1024, 2048))` —
CT Hounsfield units).  The reference semantics, preserved exactly:

- images map to integer HU via ``(x * intercept) + intercept`` and clip
  to ``clip_range`` (reference ``:7-10``);
- the channel axis (axis 1) is MEAN-reduced before histogramming
  (``:12-13``);
- one density histogram PER SAMPLE with ``clip_range[1]-clip_range[0]``
  bins over each sample's own min..max (numpy's default range —
  ``:18-19``), averaged over the batch (``:21-22``);
- the returned scalar is ``max |real_dist - fake_dist|`` of the averaged
  DENSITIES (``:24``) — the reference compares PDFs, not CDFs, so this
  is a total-variation-flavored statistic it *calls* KS.  The textbook
  KS statistic (max CDF gap, histogrammed over the FIXED ``clip_range``
  support so scale/location shifts register) is available via
  ``cumulative=True``.

Reference quirk kept: the fake batch is reshaped with the REAL batch
size (``fake_images.reshape(real_images.shape[0], -1)`` — ``:16``), so
mismatched batch sizes raise, exactly as upstream would.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def kolmogorov_smirnov_distance(
    real_images: np.ndarray,
    fake_images: np.ndarray,
    intercept: float = -1024,
    clip_range: Tuple[int, int] = (-1024, 2048),
    cumulative: bool = False,
) -> float:
    """Max-abs difference of batch-averaged per-sample intensity
    histograms (densities by default; CDFs when ``cumulative=True``).

    Inputs are NC(D)HW arrays in the std-normal domain the trainers use;
    ``intercept`` maps them back to integer HU as the reference does.
    """
    real = ((np.asarray(real_images) * intercept) + intercept).astype(int)
    fake = ((np.asarray(fake_images) * intercept) + intercept).astype(int)
    real = real.clip(*clip_range)
    fake = fake.clip(*clip_range)

    real = real.mean(1)
    fake = fake.mean(1)

    real = real.reshape(real.shape[0], -1)
    fake = fake.reshape(real.shape[0], -1)  # reference quirk: real's batch

    nbins = int(clip_range[1]) - int(clip_range[0])

    if cumulative:
        # textbook KS needs a COMMON support: the reference's per-sample-
        # range bins (below) are scale/location invariant and can read ~0
        # for grossly different distributions.  Histogram every sample over
        # the fixed clip_range, weight samples equally, and take the max
        # gap between the averaged CDFs.
        rng = (int(clip_range[0]), int(clip_range[1]))

        def cdf(batch: np.ndarray) -> np.ndarray:
            counts = np.stack(
                [np.histogram(batch[i], bins=nbins, range=rng)[0] for i in range(batch.shape[0])]
            ).astype(np.float64)
            counts /= counts.sum(axis=1, keepdims=True)  # each sample sums to 1
            return np.cumsum(counts.mean(0))

        return float(np.abs(cdf(real) - cdf(fake)).max())

    real_hists = np.stack(
        [np.histogram(real[i], bins=nbins, density=True)[0] for i in range(real.shape[0])]
    )
    fake_hists = np.stack(
        [np.histogram(fake[i], bins=nbins, density=True)[0] for i in range(fake.shape[0])]
    )

    real_dist = real_hists.mean(0)
    fake_dist = fake_hists.mean(0)

    return float(np.abs(real_dist - fake_dist).max())
