"""SSIM / PSNR / MSE / NRMSE (own copy of ``saragan_tpu/metrics/skim.py``, numpy and
scipy only).

The reference wraps skimage (metrics/skim_metrics.py:8-44) and vendors
skimage's SSIM (metrics/ssim.py).  skimage is not a dependency, so these
are self-contained scipy/numpy implementations matching the vendored
algorithm exactly: gaussian-weighted SSIM (sigma=1.5, truncate=3.5, 11-tap,
K1=0.01, K2=0.03, sample covariance, border crop of the filter radius),
multichannel as mean over per-channel SSIM, NRMSE with min-max
normalization, PSNR with the CT HU data_range=3072 default.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, uniform_filter


def _crop(ar, crop_width):
    slices = tuple(slice(crop_width, s - crop_width) for s in ar.shape)
    return ar[slices]


def structural_similarity(
    im1,
    im2,
    *,
    win_size=None,
    data_range=None,
    multichannel=False,
    gaussian_weights=False,
    K1=0.01,
    K2=0.03,
    sigma=1.5,
    use_sample_covariance=True,
):
    """Vendored-skimage-equivalent SSIM (reference metrics/ssim.py:12-250)."""
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    assert im1.shape == im2.shape, (im1.shape, im2.shape)

    if multichannel:
        nch = im1.shape[-1]
        vals = [
            structural_similarity(
                im1[..., ch],
                im2[..., ch],
                win_size=win_size,
                data_range=data_range,
                gaussian_weights=gaussian_weights,
                K1=K1,
                K2=K2,
                sigma=sigma,
                use_sample_covariance=use_sample_covariance,
            )
            for ch in range(nch)
        ]
        return float(np.mean(vals))

    truncate = 3.5
    if win_size is None:
        if gaussian_weights:
            r = int(truncate * sigma + 0.5)
            win_size = 2 * r + 1
        else:
            win_size = 7
    if np.any((np.asarray(im1.shape) - win_size) < 0):
        raise ValueError("win_size exceeds image extent.")
    if win_size % 2 != 1:
        raise ValueError("Window size must be odd.")
    if data_range is None:
        raise ValueError("data_range must be specified (no dtype inference here).")

    ndim = im1.ndim
    if gaussian_weights:
        filter_func = gaussian_filter
        filter_args = {"sigma": sigma, "truncate": truncate}
    else:
        filter_func = uniform_filter
        filter_args = {"size": win_size}

    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)

    NP = win_size**ndim
    cov_norm = NP / (NP - 1) if use_sample_covariance else 1.0

    ux = filter_func(im1, **filter_args)
    uy = filter_func(im2, **filter_args)
    uxx = filter_func(im1 * im1, **filter_args)
    uyy = filter_func(im2 * im2, **filter_args)
    uxy = filter_func(im1 * im2, **filter_args)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = data_range
    C1 = (K1 * R) ** 2
    C2 = (K2 * R) ** 2
    A1, A2, B1, B2 = (
        2 * ux * uy + C1,
        2 * vxy + C2,
        ux**2 + uy**2 + C1,
        vx + vy + C2,
    )
    S = (A1 * A2) / (B1 * B2)
    pad = (win_size - 1) // 2
    return float(_crop(S, pad).mean())


def get_mean_squared_error(real, fake):
    """reference skim_metrics.py:8-9."""
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    return float(np.mean((real - fake) ** 2))


def get_normalized_root_mse(real, fake):
    """min-max normalized RMSE (reference skim_metrics.py:12-13)."""
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    rmse = np.sqrt(np.mean((real - fake) ** 2))
    denom = real.max() - real.min()
    return float(rmse / denom)


def get_psnr(real, fake, data_range=3072):
    """PSNR with CT HU data range (reference skim_metrics.py:16-17);
    identical inputs give inf (skimage semantics), not a ZeroDivisionError."""
    mse = get_mean_squared_error(real, fake)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10((data_range**2) / mse))


def get_ssim(real, fake, data_range=3):
    """Per-volume NDHWC multichannel gaussian SSIM list (reference
    skim_metrics.py:20-44): inputs NCDHW, transposed to channels-last."""
    real = np.asarray(real)
    fake = np.asarray(fake)
    # channels-last: 5D NCDHW volumes or 4D NCHW images (2D pipeline)
    perm = [0, 2, 3, 4, 1] if real.ndim == 5 else [0, 2, 3, 1]
    real = np.transpose(real, perm)
    fake = np.transpose(fake, perm)
    if real.shape[0] == 1 and real.ndim == 5:
        # reference quirk (skim_metrics.py:23-26): a singleton 3D batch is
        # stripped and the zip below then iterates the DEPTH axis — D
        # per-slice 2D SSIMs, not one 3D SSIM.  3D-only: the reference is a
        # 3D pipeline; stripping a (1,H,W,C) 2D image would iterate ROWS.
        real = real[0, ...]
        fake = fake[0, ...]
    return [
        structural_similarity(
            im1, im2, data_range=data_range, multichannel=True, gaussian_weights=True
        )
        for im1, im2 in zip(real, fake)
    ]
