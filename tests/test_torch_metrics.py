"""The port's metrics against the JAX package's, on the CPU.

* kms, skim, swd, the Frechet distance and the 8-bit mapping are numpy/scipy copies:
  bit-equal on the same arrays (the same ``np.random.default_rng`` included);
* ``RandomConvFeatures`` with the JAX package's weights carried across: within
  1e-4 * max|features| (f32 convs summed in other orders), at even and odd slice sizes
  (XLA's "SAME" pads (0, 1) at an even size);
* ``calculate_fid_given_batch_volumes``: both packages, the same extractor weights,
  rtol 1e-3 (the features' f32 differences pass through a matrix square root);
* ``save_metrics`` with a stub sampler and one numpy extractor shared by both: the same
  tags and values (rtol 1e-5); ``make_metrics_callback``'s FID resolution.
"""

import math

import numpy as np
import pytest
import torch

from saragan_tpu.data.normalize import stdnormal_to_8bit_numpy as jax_8bit
from saragan_tpu.metrics import fid as jfid
from saragan_tpu.metrics import kms as jkms
from saragan_tpu.metrics.save_metrics import make_metrics_callback as jax_metrics_callback
from saragan_tpu.metrics.save_metrics import save_metrics as jax_save_metrics
from saragan_tpu.metrics import skim as jskim
from saragan_tpu.metrics import swd as jswd
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.data.normalize import stdnormal_to_8bit_numpy
from saragan_tpu_torch.metrics import fid as tfid
from saragan_tpu_torch.metrics import kms as tkms
from saragan_tpu_torch.metrics.save_metrics import make_metrics_callback, save_metrics
from saragan_tpu_torch.metrics import skim as tskim
from saragan_tpu_torch.metrics import swd as tswd

torch.set_num_threads(1)


def _vols(seed, shape=(2, 1, 8, 16, 16), scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


# ---------------------------------------------------------------------------
# numpy and scipy copies: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cumulative", [False, True])
def test_kms_bit_equal(cumulative):
    real, fake = _vols(0, (3, 1, 4, 8, 8)), _vols(1, (3, 1, 4, 8, 8), 1.3, 0.2)
    ours = tkms.kolmogorov_smirnov_distance(real, fake, cumulative=cumulative)
    assert ours == jkms.kolmogorov_smirnov_distance(real, fake, cumulative=cumulative)
    assert ours > 0


@pytest.mark.parametrize("shape", [(2, 1, 16, 16, 16), (1, 1, 16, 20, 24), (2, 1, 16, 16)])
def test_skim_bit_equal(shape):
    real, fake = _vols(2, shape), _vols(3, shape, 0.8)
    assert tskim.get_ssim(real, fake) == jskim.get_ssim(real, fake)
    for name in ("get_psnr", "get_mean_squared_error", "get_normalized_root_mse"):
        assert getattr(tskim, name)(real, fake) == getattr(jskim, name)(real, fake), name
    a, b = real[0, 0], fake[0, 0]
    for kw in (dict(data_range=3.0), dict(data_range=3.0, gaussian_weights=True)):
        assert (tskim.structural_similarity(a, b, **kw)
                == jskim.structural_similarity(a, b, **kw))
    assert tskim.get_psnr(real, real) == math.inf


def test_swd_bit_equal_with_the_same_generator():
    real, fake = _vols(4, (2, 1, 8, 32, 32)), _vols(5, (2, 1, 8, 32, 32), 1.2)
    ours = tswd.get_swd_for_volumes(real, fake)  # default_rng(0) in both
    ref = jswd.get_swd_for_volumes(real, fake)
    assert len(ours) == 3 and ours == ref
    ours = tswd.get_swd_for_volumes(real, fake, rng=np.random.default_rng(9))
    assert ours == jswd.get_swd_for_volumes(real, fake, rng=np.random.default_rng(9))
    pyr = tswd.generate_laplacian_pyramid(real, 2)
    assert all(np.array_equal(a, b) for a, b in
               zip(pyr, jswd.generate_laplacian_pyramid(real, 2)))
    assert tswd.get_swd_for_volumes(real[..., :8, :8], fake[..., :8, :8]) is None


def test_frechet_distance_and_8bit_mapping_bit_equal():
    a = np.random.default_rng(6).normal(size=(40, 12))
    b = np.random.default_rng(7).normal(size=(40, 12)) * 1.1 + 0.3
    assert tfid.frechet_distance(a, b) == jfid.frechet_distance(a, b)
    mu, s = a.mean(0), np.cov(a, rowvar=False)
    assert (tfid.calculate_frechet_distance(mu, s, mu + 1, s * 2)
            == jfid.calculate_frechet_distance(mu, s, mu + 1, s * 2))
    x = _vols(8, (4, 5, 6)) * 3
    assert np.array_equal(stdnormal_to_8bit_numpy(x), jax_8bit(x))
    with pytest.raises(ValueError, match="shapes differ"):
        tfid.calculate_frechet_distance(mu, s, mu[:3], s)


# ---------------------------------------------------------------------------
# feature extractors and FID across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_random_features():
    """The JAX package's random-conv extractor (64-d, so that the FID's matrix square
    root stays small) and its weights as numpy."""
    ex = jfid.RandomConvFeatures(seed=5, out_dim=64)
    ex._build()
    return ex, {k: np.asarray(v) for k, v in ex._params.items()}


@pytest.mark.parametrize("hw", [(16, 16), (15, 17), (32, 24)])
def test_random_conv_features_with_the_jax_weights(jax_random_features, hw):
    jex, params = jax_random_features
    imgs = np.random.default_rng(sum(hw)).uniform(0, 255, (3, *hw, 3)).astype(np.float32)
    ours = tfid.RandomConvFeatures.from_numpy(params, device="cpu").extract(imgs)
    ref = jex.extract(imgs)
    assert ours.shape == ref.shape == (3, 64)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_same_padding_matches_xla():
    assert [tfid._same_pad(n) for n in (16, 15, 8, 1, 2)] == [(0, 1), (1, 1), (0, 1),
                                                              (1, 1), (0, 1)]


def test_fid_of_volume_batches_across_packages(jax_random_features):
    jex, params = jax_random_features
    real, fake = _vols(10, (3, 1, 8, 16, 16)), _vols(11, (3, 1, 8, 16, 16), 1.5, 0.5)
    tex = tfid.RandomConvFeatures.from_numpy(params, device="cpu")
    ours = tfid.calculate_fid_given_batch_volumes(real, fake, tex, verbose=False)
    ref = jfid.calculate_fid_given_batch_volumes(real, fake, jex, verbose=False)
    np.testing.assert_allclose(ours, ref, rtol=1e-3)
    same = tfid.calculate_fid_given_batch_volumes(real, real, tex, verbose=False)
    assert abs(same) <= 1e-2 * ours
    with pytest.raises(ValueError, match="unequal shape"):
        tfid.volume_batch_activations(real, fake[:2], tex)


def test_default_random_features_follow_the_reference_distribution():
    """The port's seeded weights: the JAX package's shapes and He scaling, its own bits."""
    ours = tfid.RandomConvFeatures(device="cpu").params
    ex = jfid.RandomConvFeatures()
    ex._build()
    for k, v in ex._params.items():
        assert ours[k].shape == v.shape, k
        np.testing.assert_allclose(ours[k].std(), np.asarray(v).std(), rtol=0.1)
        assert not np.array_equal(ours[k], np.asarray(v))


# ---------------------------------------------------------------------------
# save_metrics and the trainer's callback
# ---------------------------------------------------------------------------


class _Data:
    """A dataset stub: the same batches, in order, for whichever package draws them."""

    def __init__(self, vols):
        self.vols, self.i = vols, 0
        self.shape = vols.shape[1:]

    def batch(self, n):
        out = self.vols[self.i:self.i + n]
        self.i += n
        return out


class _Writer:
    def __init__(self):
        self.out = {}

    def scalars(self, values, step):
        self.out.update({(k, step): v for k, v in values.items()})


class _ProjectionFeatures:
    """A numpy extractor, one object for both packages: the orchestration is under test."""

    def __init__(self):
        self.w = np.random.default_rng(0).normal(size=(16 * 16 * 3, 24)) / 30

    def extract(self, images):
        return images.reshape(len(images), -1) @ self.w


@pytest.mark.parametrize("fid_mode", ["pooled", "per_batch"])
def test_save_metrics_same_tags_and_values(fid_mode):
    real = _vols(12, (6, 1, 16, 16, 16))
    fakes = _vols(13, (6, 1, 16, 16, 16), 1.4)
    compute = dict(compute_FID=True, compute_swds=True, compute_ssims=True,
                   compute_psnrs=True, compute_mses=True, compute_nrmses=True)
    extractor = _ProjectionFeatures()
    out = {}
    for name, fn in (("jax", jax_save_metrics), ("torch", save_metrics)):
        served = iter(range(0, 6, 4))
        drawn = []

        def sample(key, n, served=served, drawn=drawn):
            drawn.append(key)
            i = next(served)
            return fakes[i:i + n]

        writer = _Writer()
        metrics = fn(writer, sample, _Data(real), 4, 1, 7, 16, compute, 6,
                                   0.5, 2.0, suffix="_EMA", extractor=extractor,
                                   fid_mode=fid_mode)
        out[name] = (writer.out, metrics, drawn)
    (jw, jm, _), (tw, tm, drawn) = out["jax"], out["torch"]
    assert sorted(tw) == sorted(jw) == sorted((k + "_EMA", 7) for k in (
        "fid", "PSNR", "ssim", "MSE", "NRMSE", "swd_16", "swd_mean"))
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-5, err_msg=str(k))
    assert sorted(tm) == sorted(jm)
    # one generator for the pass, seeded with global_step + 1, handed to every draw
    assert len(drawn) == 2 and drawn[0] is drawn[1] and drawn[0].initial_seed() == 8


def test_metrics_callback_resolves_fid_at_setup(monkeypatch, tmp_path):
    monkeypatch.delenv("SARAGAN_INCEPTION_NPZ", raising=False)
    monkeypatch.delenv("SARAGAN_ALLOW_UNCALIBRATED_FID", raising=False)
    cfg = Config(compute_FID=True).finalize()
    with pytest.raises(tfid.UncalibratedFIDError, match="allow_uncalibrated_fid"):
        make_metrics_callback(cfg, device="cpu")
    cb = make_metrics_callback(Config(compute_FID=True, allow_uncalibrated_fid=True)
                                     .finalize(), device="cpu")
    assert cb.fid_calibrated is False
    assert make_metrics_callback(Config().finalize(), device="cpu").fid_calibrated
    from saragan_tpu_torch.metrics import inception

    npz = inception.save_inception_npz(inception.random_inception_params(1),
                                       str(tmp_path / "inception.npz"))
    cb = make_metrics_callback(Config(compute_FID=True, inception_weights=npz)
                                     .finalize(), device="cpu")
    assert cb.fid_calibrated is True
    # the JAX package's callback agrees on both flags
    assert jax_metrics_callback(type("C", (), dict(
        compute_FID=True, allow_uncalibrated_fid=True, inception_weights=None,
        compute_swds=False, compute_ssims=False, compute_psnrs=False, compute_mses=False,
        compute_nrmses=False))()).fid_calibrated is False


def test_sampler_contract_is_a_torch_generator():
    """The reference splits PRNGKey(global_step + 1) per batch; the port hands one
    torch.Generator seeded with global_step + 1 to every draw of the pass."""
    seen = []
    real = _vols(14, (3, 1, 4, 4, 4))

    def sample(gen, n):
        seen.append(torch.randn(2, generator=gen))
        return real[:n]

    save_metrics(None, sample, _Data(real), 2, 1, 41, 4, dict(compute_mses=True), 3,
                       None, None)
    g = torch.Generator().manual_seed(42)
    assert [torch.equal(s, torch.randn(2, generator=g)) for s in seen] == [True, True]
