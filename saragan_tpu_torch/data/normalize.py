"""Input normalization (own copy of ``saragan_tpu/data/normalize.py:10-44``)."""

from __future__ import annotations

import numpy as np


def stdnormal_to_8bit_numpy(normalized_input):
    """Map standard-normal data to [0, 255] ints: 0 -> 128, +-2 SD -> 0 / 256, then clip
    (the FID preprocessing of the reference's dataset.py:15-26)."""
    image_8bit = np.clip((64 * normalized_input + 128), 0, 255)
    return image_8bit.astype(int)


def _check(mean, stddev):
    if mean is None and stddev is not None:
        raise ValueError("data_stddev was defined, but data_mean was not. Either define "
                         "both to apply input normalization, or define neither")
    if mean is not None and stddev is None:
        raise ValueError("data_mean was defined, but data_stddev was not. Either define "
                         "both to apply input normalization, or define neither")


def normalize_numpy(unnormalized_input, mean, stddev):
    """(x - mean) / stddev, or identity when both are None."""
    if mean is None and stddev is None:
        return unnormalized_input
    _check(mean, stddev)
    return (unnormalized_input - mean) / stddev


def invert_normalize_numpy(normalized_input, mean, stddev):
    """x * stddev + mean, or identity when both are None."""
    if mean is None and stddev is None:
        return normalized_input
    _check(mean, stddev)
    return (normalized_input * stddev) + mean
