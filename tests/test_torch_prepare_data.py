"""The port's data preparation (``saragan_tpu_torch/tools/prepare_data.py``) against the
JAX package's, on the CPU (the torch stages run on any device; the card's run is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances, stated beforehand:
- ``block_reduce_lanczos`` and ``build_pyramid`` (lanczos): one float32 ulp of the
  reference's level after the cast to float32 (both sum the same float64 products, in
  another order);
- ``block_reduce_absmax``: exact (a selection, numpy's first-index tie-breaking);
- ``block_reduce_mean``: the reference sums in float32, the port in float64, so the
  reference's own rounding bound, k^3 * 2^-24 * max|x|;
- ``resample_volume``: one float32 ulp of the reference (both interpolate in float64 at
  the same coordinates); in HU/1024 units that is at most 2^-22 (2.4e-7) for the
  normalized range [-1, 2];
- ``clip_pad_normalize``, the TFRecord codec, the converters: exact, byte for byte.
``create_dataset`` with 1 and 2 worker processes writes the reference's tree of files,
each level within the pyramid's tolerance."""

import gzip
import os

import numpy as np
import pytest
import torch

from saragan_tpu.tools import dicom as ref_dicom
from saragan_tpu.tools import prepare_data as ref
from saragan_tpu_torch.tools import prepare_data as prep

torch.set_num_threads(1)


def _ulp_check(port, want, maxulp=1):
    np.testing.assert_array_max_ulp(np.asarray(port, np.float32), np.asarray(want, np.float32),
                                    maxulp)


def _volume(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, size=shape)).astype(np.float32)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("method", ["lanczos", "average", "absmax"])
def test_block_reducers_match_reference(method, k):
    x = _volume((16, 16, 32), seed=k)
    port = prep._REDUCERS[method](torch.from_numpy(x), k).numpy()
    want = {"lanczos": ref.block_reduce_lanczos, "average": ref.block_reduce_mean,
            "absmax": ref.block_reduce_absmax}[method](x, k)
    assert port.shape == want.shape
    if method == "lanczos":
        assert port.dtype == want.dtype == np.float64
        _ulp_check(port, want)
    elif method == "absmax":
        np.testing.assert_array_equal(port, want)
    else:
        np.testing.assert_allclose(port, want, rtol=0, atol=k ** 3 * 2.0 ** -24 * np.abs(x).max())


def test_absmax_keeps_the_first_of_equal_magnitudes():
    x = np.zeros((4, 4, 4), np.float32)
    x[0, 0, 1], x[1, 1, 1] = 3.0, -3.0  # block (0,0,0): +3 comes first in block order
    x[2, 3, 2], x[3, 2, 3] = -2.0, 2.0  # block (1,1,1): -2 comes first
    x[0, 2, 2], x[1, 3, 3] = -5.0, 5.0
    want = ref.block_reduce_absmax(x, 2)
    np.testing.assert_array_equal(prep.block_reduce_absmax(torch.from_numpy(x), 2).numpy(), want)
    assert want[0, 0, 0] == 3.0 and want[1, 1, 1] == -2.0 and want[0, 1, 1] == -5.0


@pytest.mark.parametrize("method", ["lanczos", "average", "absmax"])
def test_build_pyramid_matches_reference(method):
    x = _volume((16, 32, 32), seed=1)
    port = prep.build_pyramid(x, num_levels=5, method=method, device="cpu")
    want = ref.build_pyramid(x, num_levels=5, method=method)
    assert [tuple(p.shape) for p in port] == [w.shape for w in want]
    np.testing.assert_array_equal(port[0].numpy(), want[0])
    for i, (p, w) in enumerate(zip(port[1:], want[1:]), start=1):
        if method == "average":
            np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                       atol=8 ** i * 2.0 ** -24 * np.abs(x).max())
        else:
            _ulp_check(p.numpy(), w)


@pytest.mark.parametrize("shape,spacing,new", [
    ((20, 24, 28), (2.5, 0.703125, 0.703125), (3.0, 1.0, 1.0)),  # LIDC-like: shrink
    ((9, 13, 7), (1.0, 1.7, 0.5), (3.0, 1.0, 1.0)),  # mixed up and down
    ((4, 8, 8), (2.0, 1.0, 1.0), (1.0, 1.0, 1.0)),  # doubles z
    ((5, 3, 6), (0.6, 1.0, 1.0), (3.0, 1.0, 1.0)),  # an axis down to one sample
])
def test_resample_volume_matches_scipy_zoom(shape, spacing, new):
    x = _volume(shape, seed=2, scale=800.0)
    want = ref.resample_volume(x, spacing, new)
    port = prep.resample_volume(x, spacing, new, device="cpu")
    assert port.dtype == torch.float32 and tuple(port.shape) == want.shape
    _ulp_check(port.numpy(), want)


@pytest.mark.parametrize("shape,dtype", [
    ((100, 400, 380), np.float32),  # small: centre-padded in y/x, front-padded in z
    ((150, 600, 600), np.float32),  # oversize: cropped, the last 128 slices kept
    ((130, 512, 500), np.int16),  # an integer volume: float64 like numpy's division
])
def test_clip_pad_normalize_matches_reference(shape, dtype):
    x = (np.random.default_rng(3).normal(0, 1500, size=shape)).astype(dtype)
    want = ref.clip_pad_normalize(x)
    port = prep.clip_pad_normalize(x, device="cpu").numpy()
    assert port.dtype == want.dtype and port.shape == want.shape == (128, 512, 512)
    np.testing.assert_array_equal(port, want)


# ---------------------------------------------------------------- host codecs


def test_tfrecords_are_byte_identical_and_read_across(tmp_path):
    vols = [_volume((2, 4, 4), seed=i) for i in range(3)]
    assert prep.write_tfrecords(vols, str(tmp_path / "port.tfrecord")) == 3
    ref.write_tfrecords(vols, str(tmp_path / "ref.tfrecord"))
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "ref.tfrecord").read_bytes()
    for a, b in zip(prep.read_tfrecords(str(tmp_path / "ref.tfrecord"), (2, 4, 4), verify_crc=True),
                    vols):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(prep.decode_float_example(ref.encode_float_example(vols[0])),
                                  vols[0].ravel())
    raw = bytearray((tmp_path / "port.tfrecord").read_bytes())
    raw[20] ^= 0xFF
    (tmp_path / "bad.tfrecord").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        prep.read_tfrecords(str(tmp_path / "bad.tfrecord"), verify_crc=True)


def test_converters_match_reference(tmp_path):
    """TFRecords -> npy, the npy pyramid -> .pt (int16), NRRD, HDF5 packing."""
    rec = tmp_path / "recs"
    rec.mkdir()
    vols = [np.full((2, 2, 2), i + 0.7, np.float32) for i in range(4)]
    ref.write_tfrecords(vols[:2], str(rec / "a.tfrecord"))
    ref.write_tfrecords(vols[2:], str(rec / "b.tfrecord"))
    assert prep.convert_tfrecords_to_npy(str(rec), str(tmp_path / "npy" / "2x2"), (2, 2, 2)) == 4
    ref.convert_tfrecords_to_npy(str(rec), str(tmp_path / "ref_npy" / "2x2"), (2, 2, 2))
    for i in range(4):
        name = f"2x2/{i:04d}.npy"
        assert (tmp_path / "npy" / name).read_bytes() == (tmp_path / "ref_npy" / name).read_bytes()
    assert prep.convert_npy_to_pt(str(tmp_path / "npy"), str(tmp_path / "pt"), sizes=(2,)) == 4
    ref.convert_npy_to_pt(str(tmp_path / "npy"), str(tmp_path / "ref_pt"), sizes=(2,))
    for i in range(4):
        a = torch.load(tmp_path / "pt" / "2x2" / f"{i:04d}.pt")
        assert a.dtype == torch.int16 and torch.equal(
            a, torch.load(tmp_path / "ref_pt" / "2x2" / f"{i:04d}.pt"))

    arr = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    header = b"NRRD0004\ntype: short\ndimension: 3\nsizes: 4 3 2\nencoding: gzip\n\n"
    (tmp_path / "t.nrrd").write_bytes(header + gzip.compress(arr.tobytes()))
    out, hdr = prep.read_nrrd(str(tmp_path / "t.nrrd"))
    want, want_hdr = ref.read_nrrd(str(tmp_path / "t.nrrd"))
    np.testing.assert_array_equal(out, want)
    assert hdr == want_hdr

    h5py = pytest.importorskip("h5py")
    prep.pack_npy_to_hdf5(str(tmp_path / "npy" / "2x2"), str(tmp_path / "port.h5"))
    ref.pack_npy_to_hdf5(str(tmp_path / "npy" / "2x2"), str(tmp_path / "ref.h5"))
    with h5py.File(tmp_path / "port.h5") as a, h5py.File(tmp_path / "ref.h5") as b:
        np.testing.assert_array_equal(a["volumes"][()], b["volumes"][()])


# ---------------------------------------------------------------- create_dataset


@pytest.fixture(scope="module")
def inputs_and_reference(tmp_path_factory):
    """Two inputs, a DICOM series (int16 with slope/intercept, resampled) and an .npy
    volume, and the tree the reference's create_dataset writes from them."""
    root = tmp_path_factory.mktemp("prep")
    series = root / "in" / "case0"
    series.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(10):
        px = rng.integers(-1000, 2500, size=(24, 20)).astype(np.int16)
        ref_dicom.write_ct_slice(str(series / f"s{i:02d}.dcm"), px, instance_number=i + 1,
                                 z_position=2.5 * i, pixel_spacing=(0.703125, 0.703125),
                                 slice_thickness=2.5, rescale_slope=1.0,
                                 rescale_intercept=-1024.0)
    np.save(root / "in" / "case1.npy", _volume((16, 64, 64), seed=5, scale=500.0))
    inputs = [str(series), str(root / "in" / "case1.npy")]
    ref.create_dataset(inputs, str(root / "ref"), num_workers=1)
    return inputs, root / "ref"


@pytest.mark.parametrize("num_workers", [1, 2])
def test_create_dataset_writes_the_reference_tree(tmp_path, inputs_and_reference, num_workers):
    inputs, want_root = inputs_and_reference
    assert prep.create_dataset(inputs, str(tmp_path), num_workers=num_workers,
                               device="cpu") == [0, 1]
    levels = sorted(os.listdir(want_root))
    assert sorted(os.listdir(tmp_path)) == levels and len(levels) == 8
    for level in levels:
        assert sorted(os.listdir(tmp_path / level)) == ["0000.npy", "0001.npy"]
        for name in ("0000.npy", "0001.npy"):
            got, want = np.load(tmp_path / level / name), np.load(want_root / level / name)
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
            _ulp_check(got, want)
