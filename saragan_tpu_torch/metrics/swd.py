"""Sliced Wasserstein Distance on a 3D Laplacian pyramid (own copy of
``saragan_tpu/metrics/swd.py``, numpy and scipy only).

Port of reference metrics/swd.py:5-124 (numerics preserved): 5x5x5 binomial
([1,4,6,4,1]^x3) pyramid filters, 512 random (2,8,8)-neighbourhood
descriptors per volume, per-LOD channel standardization, 8 repeats x 512
random projections, sorted-projection L1.  Host-side numpy, as in the JAX
package: the metric is evaluation-only, O(batch) work, and sort-heavy.
The reference uses the global numpy RNG; we accept a seedable Generator
(default: fresh `np.random.default_rng(seed)`) for reproducible evals.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.ndimage

_f = np.array([1, 4, 6, 4, 1], dtype=np.float32)
_f3 = _f[:, None, None] * _f[None, None, :] * _f[None, :, None]
_GAUSSIAN_FILTER = (_f3 / _f3.sum()).reshape(5, 5, 5)


def get_descriptors_for_minibatch(minibatch, nhood_size, nhoods_per_image, rng):
    """Random neighbourhood crops (reference swd.py:13-27)."""
    S = minibatch.shape  # (N, C, D, H, W)
    assert len(S) == 5
    N = nhoods_per_image * S[0]
    D, H, W = nhood_size[0] // 2, nhood_size[1] // 2, nhood_size[2] // 2
    nhood, chan, d, x, y = np.ogrid[0:N, 0 : S[1], -D : D + 1, -H : H + 1, -W : W + 1]
    img = nhood // nhoods_per_image
    d = d + rng.integers(D, S[2] - D, size=(N, 1, 1, 1, 1))
    x = x + rng.integers(W, S[4] - W, size=(N, 1, 1, 1, 1))
    y = y + rng.integers(H, S[3] - H, size=(N, 1, 1, 1, 1))
    idx = (((img * S[1] + chan) * S[2] + d) * S[3] + y) * S[4] + x
    return minibatch.flat[idx]


def finalize_descriptors(desc):
    """reference swd.py:32-40."""
    if isinstance(desc, list):
        desc = np.concatenate(desc, axis=0)
    assert desc.ndim == 5
    if desc.shape[1] > 1:
        desc -= np.mean(desc, axis=(0, 2, 3, 4), keepdims=True)
        desc /= np.std(desc, axis=(0, 2, 3, 4), keepdims=True)
    return desc.reshape(desc.shape[0], -1)


def sliced_wasserstein(a, b, dir_repeats, dirs_per_repeat, rng):
    """reference swd.py:45-59."""
    assert a.ndim == 2 and a.shape[1] == b.shape[1]
    results = []
    for _ in range(dir_repeats):
        dirs = rng.standard_normal((a.shape[1], dirs_per_repeat))
        dirs /= np.sqrt(np.sum(np.square(dirs), axis=0, keepdims=True))
        dirs = dirs.astype(np.float32)
        # sort each projection contiguously: (desc, dirs).T -> row-wise sort
        # (same sorted pairs as the reference's axis=0 column sort of the
        # untransposed array; ~4x faster for strided (8192, 512) layouts).
        # The mean accumulates in f64 so the value is layout-independent —
        # the reference's all-f32 mean carries ~1e-3 summation-order noise.
        projA = np.sort(np.ascontiguousarray(np.matmul(a, dirs).T), axis=1)
        projB = np.sort(np.ascontiguousarray(np.matmul(b, dirs).T), axis=1)
        results.append(np.mean(np.abs(projA - projB), dtype=np.float64))
    return np.mean(results)


def _binomial_blur(x, gain=1.0):
    """Separable [1,4,6,4,1]^3 blur — numerically the dense 5x5x5 convolution
    the reference applies (the filter is an outer product, and 'mirror'
    boundary handling factorizes per axis), at 15 taps instead of 125."""
    f = _f / _f.sum()
    out = x
    for axis in (2, 3, 4):
        out = scipy.ndimage.convolve1d(out, f, axis=axis, mode="mirror")
    return out * gain if gain != 1.0 else out


def _pyr_down_dense(minibatch):
    """Reference-literal dense-kernel form (swd.py:62-66) — oracle for the
    separable fast path."""
    return scipy.ndimage.convolve(
        minibatch, _GAUSSIAN_FILTER[np.newaxis, np.newaxis, ...], mode="mirror"
    )[:, :, ::2, ::2, ::2]


def pyr_down(minibatch):
    assert minibatch.ndim == 5
    return _binomial_blur(minibatch)[:, :, ::2, ::2, ::2]


def pyr_up(minibatch):
    assert minibatch.ndim == 5
    S = minibatch.shape
    res = np.zeros((S[0], S[1], S[2] * 2, S[3] * 2, S[4] * 2), minibatch.dtype)
    res[:, :, ::2, ::2, ::2] = minibatch
    return _binomial_blur(res, gain=8.0)


def generate_laplacian_pyramid(minibatch, num_levels):
    # Deliberate divergence from reference swd.py:78: `np.float32(minibatch)`
    # ALIASES an already-f32 input, so the in-place `pyramid[-2] -=` below
    # mutated the caller's batch — in the reference, every metric computed
    # after SWD on the same arrays (PSNR/SSIM/MSE/NRMSE,
    # save_metrics.py:159-196) silently ran on Laplacian residuals.  The
    # copy makes this function pure.
    pyramid = [np.array(minibatch, np.float32, copy=True)]
    for _ in range(1, num_levels):
        pyramid.append(pyr_down(pyramid[-1]))
        pyramid[-2] -= pyr_up(pyramid[-1])
    return pyramid


def reconstruct_laplacian_pyramid(pyramid):
    minibatch = pyramid[-1]
    for level in pyramid[-2::-1]:
        minibatch = pyr_up(minibatch) + level
    return minibatch


def get_swd_for_volumes(
    images1,
    images2,
    nhood_size=(2, 8, 8),
    nhoods_per_image=512,
    dir_repeats=8,
    dirs_per_repeat=512,
    rng: Optional[np.random.Generator] = None,
) -> Optional[List[float]]:
    """Per-LOD SWD + mean (reference swd.py:96-124). Returns None if the
    resolution is below 16 (no LODs)."""
    if rng is None:
        rng = np.random.default_rng(0)
    resolutions = []
    res = images1.shape[-1]
    while res >= 16:
        resolutions.append(res)
        res //= 2
    if not resolutions:
        print("No descriptors, probably resolution is too small. Returning None")
        return None

    descriptors_real = [
        get_descriptors_for_minibatch(level, nhood_size, nhoods_per_image, rng)
        for level in generate_laplacian_pyramid(images1, len(resolutions))
    ]
    descriptors_fake = [
        get_descriptors_for_minibatch(level, nhood_size, nhoods_per_image, rng)
        for level in generate_laplacian_pyramid(images2, len(resolutions))
    ]
    descriptors_real = [finalize_descriptors(d) for d in descriptors_real]
    descriptors_fake = [finalize_descriptors(d) for d in descriptors_fake]

    dist = [
        sliced_wasserstein(dr, df, dir_repeats, dirs_per_repeat, rng)
        for dr, df in zip(descriptors_real, descriptors_fake)
    ]
    return dist + [np.mean(dist)]
