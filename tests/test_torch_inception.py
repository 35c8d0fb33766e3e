"""The port's FID Inception (pytorch-fid's InceptionV3 to pool3) against the JAX
package's, on the CPU, with the same random parameters (no weights can be downloaded):
rtol/atol 2e-3 on the pool3 features as ``tests/test_inception.py`` holds the JAX network
to an independent torch one (f32 convs summed in other orders through 94 layers);
``preprocess`` (bilinear, antialias off) within 1e-6 at a 64-px and a 400-px slice (an
upscale and a downscale); the parameter table, the npz and state-dict round trips and the
extractor's resolution.

The JAX network is compiled once for the module, at one image of 299 px."""

import jax
import numpy as np
import pytest
import torch

from saragan_tpu.metrics import inception as ji
from saragan_tpu_torch.metrics import fid as tfid
from saragan_tpu_torch.metrics import inception as ti

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return ji.random_inception_params(seed=3)


@pytest.fixture(scope="module")
def jax_pool3():
    return jax.jit(ji.inception_pool3)


@pytest.fixture(scope="module")
def port_net(params):
    return ti.InceptionPool3(params).eval()


def _images(seed, size):
    return np.random.default_rng(seed).uniform(0, 255, (1, size, size, 3)).astype(np.float32)


def test_param_table_equals_the_reference():
    assert ti.inception_param_shapes() == ji.inception_param_shapes()
    assert len(ti.inception_param_shapes()) == 94 * 5


@pytest.mark.parametrize("size", [64, 400])
def test_preprocess_matches_the_reference(size):
    x = _images(size, size)
    ours = ti.preprocess(torch.from_numpy(x)).numpy()
    ref = np.asarray(ji.preprocess(x))
    assert ours.shape == ref.shape == (1, 3, 299, 299)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [64, 400])
def test_pool3_features_match_the_reference(params, jax_pool3, port_net, size):
    """The extractor's whole chain (preprocess, then pool3) against the JAX network on the
    JAX preprocess of the same slice."""
    x = _images(size + 1, size)
    ref = np.asarray(jax_pool3(params, ji.preprocess(x)))
    ours = ti.InceptionPool3Features(params, device="cpu").extract(x)
    assert ours.shape == ref.shape == (1, 2048) and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)
    with torch.inference_mode():
        direct = port_net(ti.preprocess(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(direct, ours)
    np.testing.assert_allclose(ti.inception_pool3(params, ti.preprocess(torch.from_numpy(x)))
                               .detach().numpy(), ours, rtol=0, atol=0)


def test_random_params_follow_the_reference_distribution():
    ours, ref = ti.random_inception_params(4), ji.random_inception_params(4)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    for suffix in ("bn.weight", "running_var", "running_mean", "conv.weight"):
        a = np.concatenate([v.ravel() for k, v in ours.items() if k.endswith(suffix)])
        b = np.concatenate([v.ravel() for k, v in ref.items() if k.endswith(suffix)])
        np.testing.assert_allclose([a.mean(), a.std()], [b.mean(), b.std()], atol=2e-3,
                                   rtol=2e-2, err_msg=suffix)
    assert not np.array_equal(ours["Conv2d_1a_3x3.conv.weight"],
                              ref["Conv2d_1a_3x3.conv.weight"])


def test_npz_and_state_dict_round_trips(tmp_path, monkeypatch):
    p = ti.random_inception_params(5)
    npz = ti.save_inception_npz(p, str(tmp_path / "inception.npz"))
    back = ti.load_inception_npz(npz)
    assert all(np.array_equal(back[k], p[k]) for k in p)
    assert all(np.array_equal(ji.load_inception_npz(npz)[k], p[k]) for k in p)  # one file
    pth = tmp_path / "pt_inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in p.items()}, pth)
    conv = ti.convert_torch_state_dict(str(pth))
    assert all(np.array_equal(conv[k], p[k]) for k in p)
    torch.save({k: torch.from_numpy(v) for k, v in list(p.items())[1:]}, pth)
    with pytest.raises(KeyError, match="missing"):
        ti.convert_torch_state_dict(str(pth))
    with pytest.raises(KeyError, match="lack"):
        ti.InceptionPool3({})
    monkeypatch.delenv("SARAGAN_INCEPTION_NPZ", raising=False)
    ex = tfid.default_extractor(npz_path=npz, device="cpu")
    assert isinstance(ex, tfid.InceptionFeatures) and ex.calibrated
    monkeypatch.setenv("SARAGAN_INCEPTION_NPZ", npz)
    assert isinstance(tfid.default_extractor(device="cpu"), tfid.InceptionFeatures)
    with pytest.raises(FileNotFoundError):
        tfid.InceptionFeatures(str(tmp_path / "absent.npz"), device="cpu")
