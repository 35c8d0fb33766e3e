"""Frechet Inception Distance (counterpart of ``saragan_tpu/metrics/fid.py``).

* Preprocessing as the reference's fid_new.py:330-458: NCDHW -> NDHWC, grayscale repeated
  to 3 channels, each volume evaluated z-slice by z-slice after the std-normal -> 8-bit
  mapping, the activations of all slices pooled before one Frechet distance.
* ``frechet_distance``: numpy and scipy on the host, the reference's "stable version"
  (``sqrtm`` with an eps-diagonal retry, the imaginary part stripped), copied.

Feature extractors, run on the device they are given (CUDA unless the caller names the
CPU) under the serving numerics (deterministic cuDNN, no TF32):

* ``InceptionFeatures(npz_path)``: pytorch-fid's Inception pool3 over a converted weights
  npz (``inception.py``).  Without the file it raises: nothing is downloaded.
* ``RandomConvFeatures``: the hermetic fallback, a fixed-seed random conv network.  Its
  FID orders distributions within a run but is not comparable to Inception FID.  Its
  default weights come from the port's own ``torch.Generator`` (the JAX package's come
  from threefry), so the two packages' uncalibrated values differ; ``from_numpy`` takes
  the JAX package's weights instead.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.data.normalize import stdnormal_to_8bit_numpy
from saragan_tpu_torch.metrics.inception import InceptionPool3Features, load_inception_npz
from saragan_tpu_torch.train.step import _train_numerics

# -----------------------------------------------------------------------------
# Frechet distance (reference fid_new.py:115-166)
# -----------------------------------------------------------------------------


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"mean or covariance shapes differ: {mu1.shape} {mu2.shape}, "
                         f"{sigma1.shape} {sigma2.shape}")

    diff = mu1 - mu2

    def _sqrtm(a):
        out = linalg.sqrtm(a)  # scipy >= 1.18 drops the (result, errest) tuple
        return out[0] if isinstance(out, tuple) else out

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        warnings.warn(
            f"fid calculation produces singular product; adding {eps} to diagonal of cov estimates"
        )
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def frechet_distance(act1: np.ndarray, act2: np.ndarray) -> float:
    """FID from two (N, dim) activation sets."""
    mu1, mu2 = act1.mean(axis=0), act2.mean(axis=0)
    s1 = np.cov(act1, rowvar=False)
    s2 = np.cov(act2, rowvar=False)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


# -----------------------------------------------------------------------------
# Feature extractors
# -----------------------------------------------------------------------------

_RANDOM_DIMS = (3, 32, 64, 128, 256)


def _same_pad(size: int, k: int = 3, s: int = 2):
    """XLA's "SAME" padding (low, high) of one dimension: (0, 1) at an even size for a
    3-tap stride-2 conv, where ``padding=1`` would pad (1, 1)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class RandomConvFeatures:
    """Deterministic random-weight conv embedder (2048-d).

    Input: (N, H, W, 3) in [0, 255].  He-scaled fixed-seed weights; four 3x3 stride-2
    "SAME" convs with leaky ReLU 0.2 to /16 resolution, global mean and max pooling, a
    random projection.  ``params`` (the JAX package's layout: HWIO ``w0`` .. ``w3`` and
    ``proj`` (512, out_dim)) replaces the seeded weights."""

    #: random features are run-internally consistent but NOT numerically comparable to
    #: Inception FID: never report them as "FID" externally
    calibrated = False

    def __init__(self, seed: int = 1234, out_dim: int = 2048,
                 params: Optional[Dict[str, np.ndarray]] = None, device=None):
        self.seed = seed
        self.out_dim = out_dim
        self.device = resolve_device(device)
        if params is None:
            g = torch.Generator().manual_seed(seed)
            params = {}
            for i in range(4):
                fan_in = 9 * _RANDOM_DIMS[i]
                params[f"w{i}"] = (torch.randn((3, 3, _RANDOM_DIMS[i], _RANDOM_DIMS[i + 1]),
                                               generator=g) * np.sqrt(2.0 / fan_in)).numpy()
            params["proj"] = (torch.randn((2 * _RANDOM_DIMS[-1], out_dim), generator=g)
                              / np.sqrt(2 * _RANDOM_DIMS[-1])).numpy()
        self.params = params
        # HWIO -> OIHW, once, on the device
        self._w = [torch.tensor(np.asarray(params[f"w{i}"], np.float32))
                   .permute(3, 2, 0, 1).contiguous().to(self.device) for i in range(4)]
        self._proj = torch.tensor(np.asarray(params["proj"], np.float32), device=self.device)

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray], device=None) -> "RandomConvFeatures":
        """The extractor with the JAX package's weights (``RandomConvFeatures._params``
        there, as numpy arrays)."""
        return cls(out_dim=int(np.shape(params["proj"])[1]), params=params, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [0, 255] on the device -> (N, out_dim)."""
        x = x.to(torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0
        for w in self._w:
            (h0, h1), (w0, w1) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.conv2d(F.pad(x, (w0, w1, h0, h1)), w, stride=2)
            x = torch.where(x >= 0, x, 0.2 * x)
        feat = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)
        return feat @ self._proj

    def extract(self, images: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), _train_numerics():
            x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
            return self.forward(x).float().cpu().numpy()


class InceptionFeatures:
    """Inception pool3 features from a converted weights npz (``inception.py``), at
    `npz_path` or ``$SARAGAN_INCEPTION_NPZ``; raises ``FileNotFoundError`` without one."""

    calibrated = True

    def __init__(self, npz_path: Optional[str] = None, device=None):
        self.npz_path = npz_path or os.environ.get("SARAGAN_INCEPTION_NPZ")
        if not self.npz_path or not os.path.isfile(self.npz_path):
            raise FileNotFoundError(
                "Inception weights npz not found. Provide npz_path or set "
                "SARAGAN_INCEPTION_NPZ; falling back to RandomConvFeatures gives "
                "run-internal (not cross-paper-comparable) FID values.")
        self._impl = InceptionPool3Features(load_inception_npz(self.npz_path), device=device)

    def extract(self, images: np.ndarray) -> np.ndarray:
        return self._impl.extract(images)


class UncalibratedFIDError(RuntimeError):
    """Raised when FID is requested but no Inception weights are available."""


def default_extractor(allow_uncalibrated: bool = False, npz_path: Optional[str] = None,
                      device=None):
    """The Inception pool3 extractor, or a hard error without weights.

    Only with ``allow_uncalibrated=True`` (``--allow_uncalibrated_fid``, or
    ``SARAGAN_ALLOW_UNCALIBRATED_FID=1``) does this fall back to ``RandomConvFeatures``,
    whose values are run-internal only."""
    try:
        return InceptionFeatures(npz_path, device=device)
    except FileNotFoundError as e:
        if allow_uncalibrated or os.environ.get("SARAGAN_ALLOW_UNCALIBRATED_FID"):
            warnings.warn(
                "FID requested without Inception weights: falling back to "
                "RandomConvFeatures. Values are run-internal only and are NOT "
                "comparable to published FID numbers.")
            return RandomConvFeatures(device=device)
        raise UncalibratedFIDError(
            "compute_FID requires converted Inception weights (set "
            "SARAGAN_INCEPTION_NPZ or --inception_weights; converter: "
            "saragan_tpu_torch.metrics.inception.convert_torch_state_dict). "
            "Pass --allow_uncalibrated_fid to knowingly use random-feature "
            "FID for run-internal comparison only.") from e


# -----------------------------------------------------------------------------
# Volume -> activations -> FID (reference fid_new.py:250-280, 330-458)
# -----------------------------------------------------------------------------


def get_activations_from_volume(volume_dhwc: np.ndarray, extractor, batch_size: int = 64):
    """Per-z-slice activations of one volume (D, H, W, C=3), std-normal input mapped to
    8-bit (reference fid_new.py:250-280)."""
    n_imgs = len(volume_dhwc)
    batch_size = min(batch_size, n_imgs)
    preds = []
    for start in range(0, n_imgs, batch_size):
        batch = stdnormal_to_8bit_numpy(volume_dhwc[start: start + batch_size])
        preds.append(extractor.extract(batch.astype(np.float32)))
    return np.concatenate(preds, axis=0)


def volume_batch_activations(volumes_batch_real: np.ndarray, volumes_batch_fake: np.ndarray,
                             extractor=None, data_format: str = "NCDHW",
                             verbose: bool = True):
    """Pooled per-z-slice activations of a (real, fake) volume batch: (acts_real,
    acts_fake), each (num_volumes * depth, feat_dim).  Apart from
    ``calculate_fid_given_batch_volumes`` so that a caller can pool the activations of
    several batches before one Frechet distance."""
    if volumes_batch_real.shape != volumes_batch_fake.shape:
        raise ValueError(
            "ERROR: unequal shape for batches of real images (%s) and fake images (%s)"
            % (volumes_batch_real.shape, volumes_batch_fake.shape))
    if volumes_batch_real.ndim != 5:
        raise ValueError(
            "ERROR: volumes_batch_real.ndim (%s) is not equal to 5." % volumes_batch_real.ndim)
    if extractor is None:
        extractor = default_extractor()

    if data_format == "NCDHW":
        volumes_batch_real = np.transpose(volumes_batch_real, [0, 2, 3, 4, 1])
        volumes_batch_fake = np.transpose(volumes_batch_fake, [0, 2, 3, 4, 1])
    if volumes_batch_real.shape[-1] == 1:
        volumes_batch_real = np.repeat(volumes_batch_real, 3, axis=-1)
        volumes_batch_fake = np.repeat(volumes_batch_fake, 3, axis=-1)

    batch_size = min(64, volumes_batch_fake.shape[1])

    acts_real, acts_fake = [], []
    for i in range(len(volumes_batch_fake)):
        amax = np.amax(np.abs(volumes_batch_real[i]))
        if (amax > 8 or amax < 0.1) and verbose:
            print("WARNING: it looks like your real input images are unnormalized. This may "
                  "result in inaccurate FID calculations: the feature network assumes inputs "
                  "in the range [0,255] and this code assumes a standard normalized input in "
                  "order to map to this range.")
        acts_real.append(get_activations_from_volume(volumes_batch_real[i], extractor,
                                                     batch_size))
        acts_fake.append(get_activations_from_volume(volumes_batch_fake[i], extractor,
                                                     batch_size))
    # all z-slices of all volumes pooled into one activation set (fid_new.py:419-427)
    return np.concatenate(acts_real, axis=0), np.concatenate(acts_fake, axis=0)


def calculate_fid_given_batch_volumes(volumes_batch_real: np.ndarray,
                                      volumes_batch_fake: np.ndarray, extractor=None,
                                      data_format: str = "NCDHW",
                                      verbose: bool = True) -> float:
    acts_real, acts_fake = volume_batch_activations(volumes_batch_real, volumes_batch_fake,
                                                    extractor, data_format, verbose)
    return frechet_distance(acts_real, acts_fake)
