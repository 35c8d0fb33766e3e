"""The port's pure-Python DICOM reader and writer (``saragan_tpu_torch/tools/dicom.py``)
against the JAX package's: series written by either package's ``write_ct_slice`` are
byte-identical and read identically in both (explicit and implicit VR), and the
reference's edge cases (``tests/test_dicom.py``: rescale, signed pixels, SQ and UN
sequences, the InstanceNumber fallback, mixed series, junk and truncated files, compressed
and encapsulated data, bare datasets, the prepare_data fallback, metadata) give the same
results on the port's copy."""

import os
import struct

import numpy as np
import pytest
import torch

from saragan_tpu.tools import dicom as ref
from saragan_tpu.tools import prepare_data as ref_prep
from saragan_tpu_torch.tools import dicom
from saragan_tpu_torch.tools import prepare_data
from saragan_tpu_torch.tools.dicom import DicomError, read_file, read_series, write_ct_slice

torch.set_num_threads(1)

PACKAGES = {"port": dicom, "reference": ref}


def _make_series(tmpdir, writer=dicom, n=4, explicit=True, shuffle_names=False, **kw):
    rng = np.random.default_rng(0)
    vols = []
    for i in range(n):
        px = rng.integers(0, 3000, size=(8, 10), dtype=np.int64).astype(np.uint16)
        vols.append(px)
        # shuffled file names must NOT determine the stacking order
        name = f"{'zyx'[i % 3]}{n - i:02d}.dcm" if shuffle_names else f"s{i:02d}.dcm"
        writer.write_ct_slice(
            os.path.join(tmpdir, name), px,
            instance_number=i + 1, z_position=2.5 * i,
            pixel_spacing=(0.703125, 0.703125), slice_thickness=2.5,
            explicit=explicit, **kw,
        )
    return np.stack(vols)


@pytest.mark.parametrize("explicit", [True, False], ids=["explicitVR", "implicitVR"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_series_read_identically_in_both_packages(tmp_path, writer, explicit):
    stored = _make_series(str(tmp_path), PACKAGES[writer], n=5, explicit=explicit,
                          shuffle_names=True)
    vol, spacing = read_series(str(tmp_path))
    ref_vol, ref_spacing = ref.read_series(str(tmp_path))
    np.testing.assert_array_equal(vol, ref_vol)
    np.testing.assert_allclose(vol, stored.astype(np.float32) - 1024.0)
    assert vol.dtype == np.float32 and vol.shape == (5, 8, 10)
    assert spacing == ref_spacing == (2.5, 0.703125, 0.703125)


@pytest.mark.parametrize("kw", [
    dict(explicit=True), dict(explicit=False), dict(extra_sequence=True),
    dict(extra_sequence=True, explicit=False),
    dict(extra_sequence=True, sequence_vr=b"UN", undefined_item=True),
    dict(include_position=False, rescale_slope=2.5, rescale_intercept=-100.0),
], ids=["explicit", "implicit", "sq", "sq_implicit", "un_sequence", "no_position_rescale"])
def test_writers_are_byte_identical(tmp_path, kw):
    px = np.arange(-6, 6, dtype=np.int16).reshape(3, 4)
    a = write_ct_slice(str(tmp_path / "port.dcm"), px, instance_number=7, z_position=-3.75, **kw)
    b = ref.write_ct_slice(str(tmp_path / "ref.dcm"), px, instance_number=7, z_position=-3.75,
                           **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_rescale_slope_intercept(tmp_path):
    px = np.arange(20, dtype=np.int16).reshape(4, 5)
    write_ct_slice(str(tmp_path / "a.dcm"), px, rescale_slope=2.0, rescale_intercept=-100.0)
    vol, _ = read_series(str(tmp_path))
    np.testing.assert_allclose(vol[0], px.astype(np.float32) * 2.0 - 100.0)


def test_signed_pixel_representation(tmp_path):
    px = np.array([[-1024, -1, 0, 1, 2047]], dtype=np.int16)
    write_ct_slice(str(tmp_path / "a.dcm"), px, rescale_slope=1.0, rescale_intercept=0.0)
    s = read_file(str(tmp_path / "a.dcm"))
    np.testing.assert_array_equal(s.pixel_array(), px)
    np.testing.assert_allclose(s.hounsfield(), px.astype(np.float32))


@pytest.mark.parametrize("explicit", [True, False], ids=["explicitVR", "implicitVR"])
@pytest.mark.parametrize("sequence", ["SQ", "UN"])
def test_undefined_length_sequences_are_skipped(tmp_path, explicit, sequence):
    """An undefined-length SQ before PixelData, and an anonymizer-style UN element whose
    contents are Implicit VR whatever the file's syntax (PS3.5 §6.2.2, CP-246), must not
    desynchronize the element walk."""
    px = np.full((3, 3), 7, dtype=np.uint16)
    kw = dict(sequence_vr=b"UN", undefined_item=True) if sequence == "UN" else {}
    write_ct_slice(str(tmp_path / "a.dcm"), px, explicit=explicit, extra_sequence=True, **kw)
    for pkg in PACKAGES.values():
        s = pkg.read_file(str(tmp_path / "a.dcm"))
        np.testing.assert_array_equal(s.pixel_array(), px)
        assert s.modality == "CT"


def test_sort_falls_back_to_instance_number(tmp_path):
    for i, inst in enumerate([3, 1, 2]):
        px = np.full((2, 2), inst * 100, dtype=np.uint16)
        write_ct_slice(str(tmp_path / f"f{i}.dcm"), px, instance_number=inst,
                       include_position=False)
    vol, spacing = read_series(str(tmp_path))
    assert [int(v) for v in vol[:, 0, 0] + 1024] == [100, 200, 300]
    assert spacing[0] == 1.0  # no z positions at all -> the SliceThickness fallback


def test_largest_series_wins(tmp_path):
    for i in range(3):
        write_ct_slice(str(tmp_path / f"a{i}.dcm"), np.full((2, 2), i, np.uint16),
                       series_uid="1.2.3.4", instance_number=i + 1, z_position=float(i))
    write_ct_slice(str(tmp_path / "b0.dcm"), np.full((4, 4), 9, np.uint16),
                   series_uid="9.9.9.9", instance_number=1)
    assert read_series(str(tmp_path))[0].shape == (3, 2, 2)


def test_junk_and_truncated_files(tmp_path):
    """A junk .dcm beside good slices is skipped; a truncated slice is skipped with a
    warning that counts it; a directory where nothing reads raises."""
    _make_series(str(tmp_path), n=3)
    (tmp_path / "zz.dcm").write_bytes(b"\x00" * 200)  # unparseable
    assert read_series(str(tmp_path))[0].shape[0] == 3
    good = (tmp_path / "s00.dcm").read_bytes()
    (tmp_path / "trunc.dcm").write_bytes(good[: len(good) - 40])  # cut PixelData
    with pytest.warns(RuntimeWarning, match="1 unreadable"):
        vol, _ = read_series(str(tmp_path))
    assert vol.shape[0] == 3
    bad = tmp_path / "allbad"
    bad.mkdir()
    (bad / "x.dcm").write_bytes(b"\x00" * 200)
    with pytest.raises(DicomError):
        read_series(str(bad))


def test_compressed_and_encapsulated_rejected(tmp_path):
    p = str(tmp_path / "a.dcm")
    write_ct_slice(p, np.zeros((2, 2), np.uint16))
    data = open(p, "rb").read()
    rle = b"1.2.840.10008.1.2.5\x00"
    old = dicom.EXPLICIT_VR_LE.encode() + b"\x00"
    assert old in data and len(rle) == len(old)
    open(p, "wb").write(data.replace(old, rle))
    with pytest.raises(DicomError, match="compressed"):
        read_file(p)

    q = str(tmp_path / "b.dcm")
    write_ct_slice(q, np.zeros((2, 2), np.uint16))
    data = bytearray(open(q, "rb").read())
    idx = data.rfind(struct.pack("<HH", 0x7FE0, 0x0010))
    data[idx + 8:idx + 12] = struct.pack("<I", 0xFFFFFFFF)
    open(q, "wb").write(bytes(data))
    with pytest.raises(DicomError, match="encapsulated"):
        read_file(q)


@pytest.mark.parametrize("explicit", [True, False], ids=["explicitVR", "implicitVR"])
def test_bare_dataset_without_preamble(tmp_path, explicit):
    p = str(tmp_path / "x.dcm")
    write_ct_slice(p, np.full((2, 3), 42, np.uint16), explicit=explicit)
    data = open(p, "rb").read()
    bare = str(tmp_path / "bare.dcm")
    open(bare, "wb").write(data[data.find(struct.pack("<HH", 0x0008, 0x0060)):])
    for pkg in PACKAGES.values():
        np.testing.assert_array_equal(pkg.read_file(bare).pixel_array(),
                                      np.full((2, 3), 42, np.uint16))


def test_prepare_data_fallback_and_metadata(tmp_path):
    """The port's read_dicom_series reaches its own reader (no SimpleITK or pydicom) and
    agrees with the reference's; the resample on it and the metadata CSV match too."""
    series = tmp_path / "case1"
    series.mkdir()
    _make_series(str(series), n=6)
    vol, spacing = prepare_data.read_dicom_series(str(series))
    ref_vol, ref_spacing = ref_prep.read_dicom_series(str(series))
    np.testing.assert_array_equal(vol, ref_vol)
    assert spacing == ref_spacing == (2.5, 0.703125, 0.703125)
    resampled = prepare_data.resample_volume(vol, spacing, (3.0, 1.0, 1.0), device="cpu")
    np.testing.assert_array_max_ulp(resampled.numpy(), ref_prep.resample_volume(vol, spacing), 1)
    assert prepare_data.extract_metadata(str(tmp_path), str(tmp_path / "port.csv")) == 1
    ref_prep.extract_metadata(str(tmp_path), str(tmp_path / "ref.csv"))
    assert open(tmp_path / "port.csv").read() == open(tmp_path / "ref.csv").read()
