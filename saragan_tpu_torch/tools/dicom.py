"""Pure-Python DICOM reader and writer for CT series ingestion (counterpart of
``saragan_tpu/tools/dicom.py``, a copy: the port imports nothing of the JAX package).

The reference ingests LIDC-IDRI DICOM series through SimpleITK
(`data_scripts/process_lidc_idri_data.py:48-119`: ImageSeriesReader ->
GetArrayFromImage -> HU volume + spacing) and reads per-slice metadata via
pydicom (`data_scripts/extract_metadata.py`).  Neither library is needed here:
this module implements the subset of the DICOM file format that CT series
actually use, from the public standard (PS3.10 file format, PS3.5 encoding):

* Part-10 files (128-byte preamble + ``DICM`` + explicit-VR meta group)
  and bare datasets (no preamble — auto-detected).
* Transfer syntaxes **Implicit VR Little Endian** (1.2.840.10008.1.2) and
  **Explicit VR Little Endian** (1.2.840.10008.1.2.1) — the uncompressed
  encodings LIDC-IDRI CT uses.  Compressed/encapsulated syntaxes raise a
  clear error (convert offline, as the reference's cluster recipe did).
* Sequences (SQ) with defined or undefined length are skipped structurally
  (item/delimiter walking) — series assembly needs only top-level elements.
* Pixel decoding: 16/8-bit, signed/unsigned, MONOCHROME, with
  RescaleSlope/Intercept applied -> float32 HU.

``read_series(dir)`` mirrors the SimpleITK call: stacks the largest series
in the directory sorted by ImagePositionPatient z (InstanceNumber
fallback) and returns ``((D, H, W) float32 HU, (z, y, x) spacing)``.

A minimal writer (`write_ct_slice`) produces valid explicit/implicit-VR
files, byte for byte those of the JAX package's writer, so the reader is
round-trip testable without any external corpus.  Everything here runs on
the host: a file format, no tensor and no device.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# Transfer syntax UIDs (PS3.6 registry)
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"  # retired; rejected explicitly

# Tags this module extracts (group, element)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_MODALITY = (0x0008, 0x0060)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_INSTANCE_NUMBER = (0x0020, 0x0013)
TAG_IMAGE_POSITION = (0x0020, 0x0032)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_SLICE_LOCATION = (0x0020, 0x1041)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

# VRs whose explicit-VR encoding carries a 2-byte reserved field and a
# 4-byte length (PS3.5 table 7.1-1); everything else uses a 2-byte length.
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}
_KNOWN_VRS = _LONG_VRS | {
    b"AE", b"AS", b"AT", b"CS", b"DA", b"DS", b"DT", b"FL", b"FD", b"IS",
    b"LO", b"LT", b"PN", b"SH", b"SL", b"SS", b"ST", b"TM", b"UI", b"UL", b"US",
}
_UNDEFINED = 0xFFFFFFFF


class DicomError(ValueError):
    pass


def _element_header(buf: bytes, pos: int, explicit: bool):
    """Decode one element header -> (tag, vr, length, value_offset).

    Delimiter tags (group FFFE) never carry a VR, even in explicit-VR
    datasets (PS3.5 §7.5)."""
    group, elem = struct.unpack_from("<HH", buf, pos)
    tag = (group, elem)
    if group == 0xFFFE:
        (length,) = struct.unpack_from("<I", buf, pos + 4)
        return tag, b"", length, pos + 8
    if explicit:
        vr = buf[pos + 4:pos + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", buf, pos + 8)
            return tag, vr, length, pos + 12
        if vr in _KNOWN_VRS:
            (length,) = struct.unpack_from("<H", buf, pos + 6)
            return tag, vr, length, pos + 8
        raise DicomError(f"unknown VR {vr!r} at tag ({group:04x},{elem:04x})")
    (length,) = struct.unpack_from("<I", buf, pos + 4)
    return tag, b"", length, pos + 8


def _skip_sequence(buf: bytes, pos: int, explicit: bool) -> int:
    """Skip an SQ/UN value of undefined length starting at `pos`; returns
    the offset just past the sequence delimitation item (PS3.5 §7.5).
    Item datasets are parsed with full VR awareness so nested sequences
    and explicit-VR long headers cannot desynchronize the walk.  The
    caller passes ``explicit=False`` for UN values: PS3.5 §6.2.2 (CP-246)
    mandates that undefined-length UN contents are always Implicit VR,
    even inside an Explicit VR dataset."""
    n = len(buf)
    while pos + 8 <= n:
        tag, _, length, vpos = _element_header(buf, pos, explicit)
        if tag == (0xFFFE, 0xE0DD):  # sequence delimitation
            return vpos
        if tag != (0xFFFE, 0xE000):
            raise DicomError(f"malformed sequence item tag ({tag[0]:04x},{tag[1]:04x})")
        if length != _UNDEFINED:
            pos = vpos + length
            continue
        # undefined-length item: walk its dataset until item delimitation
        pos = vpos
        while pos + 8 <= n:
            itag, ivr, ilen, ivpos = _element_header(buf, pos, explicit)
            if itag == (0xFFFE, 0xE00D):  # item delimitation
                pos = ivpos
                break
            if ilen == _UNDEFINED:
                pos = _skip_sequence(buf, ivpos, explicit and ivr != b"UN")
            else:
                pos = ivpos + ilen
        else:
            raise DicomError("unterminated item (no FFFE,E00D delimiter)")
    raise DicomError("unterminated sequence (no FFFE,E0DD delimiter)")


def _parse_dataset(buf: bytes, explicit: bool,
                   stop_at_pixels: bool = True) -> Dict[Tuple[int, int], Tuple[bytes, bytes]]:
    """Parse a little-endian dataset -> {tag: (vr, raw value bytes)}.

    Implicit VR stores vr=b'' (the caller decodes by tag semantics).
    SQ values are skipped and recorded as empty."""
    out: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    pos = 0
    n = len(buf)
    while pos + 8 <= n:
        tag, vr, length, pos = _element_header(buf, pos, explicit)
        if length == _UNDEFINED:
            if tag == TAG_PIXEL_DATA:
                raise DicomError(
                    "encapsulated (compressed) PixelData — only uncompressed "
                    "Implicit/Explicit VR Little Endian is supported; "
                    "transcode the series offline (e.g. dcmdjpeg/gdcmconv)"
                )
            # CP-246: undefined-length UN contents are Implicit VR always
            pos = _skip_sequence(buf, pos, explicit and vr != b"UN")
            out[tag] = (vr, b"")
            continue
        if vr == b"SQ":
            pos += length  # defined-length sequence: skip whole value
            out[tag] = (vr, b"")
            continue
        if pos + length > n:
            raise DicomError(f"element ({tag[0]:04x},{tag[1]:04x}) overruns file")
        out[tag] = (vr, buf[pos:pos + length])
        pos += length
        if stop_at_pixels and tag == TAG_PIXEL_DATA:
            break
    return out


def _ascii(v: bytes) -> str:
    return v.decode("ascii", "ignore").strip("\x00 ").strip()


def _numbers(v: bytes) -> List[float]:
    s = _ascii(v)
    return [float(x) for x in s.split("\\") if x.strip()] if s else []


def _uint16(v: bytes) -> int:
    return struct.unpack("<H", v[:2])[0]


class SliceFile:
    """One parsed single-frame CT slice."""

    def __init__(self, path: str, elements: Dict[Tuple[int, int], Tuple[bytes, bytes]]):
        self.path = path
        self.elements = elements

    def _get(self, tag, default=None):
        e = self.elements.get(tag)
        return e[1] if e is not None else default

    @property
    def series_uid(self) -> str:
        return _ascii(self._get(TAG_SERIES_UID, b""))

    @property
    def modality(self) -> str:
        return _ascii(self._get(TAG_MODALITY, b""))

    @property
    def instance_number(self) -> Optional[int]:
        v = self._get(TAG_INSTANCE_NUMBER)
        nums = _numbers(v) if v else []
        return int(nums[0]) if nums else None

    @property
    def z_position(self) -> Optional[float]:
        v = self._get(TAG_IMAGE_POSITION)
        nums = _numbers(v) if v else []
        if len(nums) >= 3:
            return nums[2]
        v = self._get(TAG_SLICE_LOCATION)
        nums = _numbers(v) if v else []
        return nums[0] if nums else None

    @property
    def pixel_spacing(self) -> Tuple[float, float]:
        nums = _numbers(self._get(TAG_PIXEL_SPACING, b"1\\1"))
        return (nums[0], nums[1]) if len(nums) >= 2 else (1.0, 1.0)

    @property
    def slice_thickness(self) -> Optional[float]:
        v = self._get(TAG_SLICE_THICKNESS)
        nums = _numbers(v) if v else []
        return nums[0] if nums else None

    def pixel_array(self) -> np.ndarray:
        """Raw stored values as a (Rows, Cols) int array (no rescale)."""
        raw = self._get(TAG_PIXEL_DATA)
        if raw is None:
            raise DicomError(f"{self.path}: no PixelData")
        rows = _uint16(self._get(TAG_ROWS, b"\x00\x00"))
        cols = _uint16(self._get(TAG_COLS, b"\x00\x00"))
        bits = _uint16(self._get(TAG_BITS_ALLOCATED, b"\x10\x00"))
        signed = _uint16(self._get(TAG_PIXEL_REPRESENTATION, b"\x00\x00")) == 1
        if bits == 16:
            dtype = np.int16 if signed else np.uint16
        elif bits == 8:
            dtype = np.int8 if signed else np.uint8
        else:
            raise DicomError(f"{self.path}: unsupported BitsAllocated={bits}")
        need = rows * cols * (bits // 8)
        if len(raw) < need:
            raise DicomError(f"{self.path}: PixelData short ({len(raw)} < {need})")
        return np.frombuffer(raw[:need], dtype="<" + np.dtype(dtype).str[1:]).reshape(rows, cols)

    def hounsfield(self) -> np.ndarray:
        """Stored values -> float32 HU via RescaleSlope/Intercept
        (reference applies these implicitly through sitk; pydicom path
        `prepare_data.read_dicom_series` does it explicitly)."""
        slope_v = self._get(TAG_RESCALE_SLOPE)
        inter_v = self._get(TAG_RESCALE_INTERCEPT)
        slope = _numbers(slope_v)[0] if slope_v and _numbers(slope_v) else 1.0
        inter = _numbers(inter_v)[0] if inter_v and _numbers(inter_v) else 0.0
        return self.pixel_array().astype(np.float32) * np.float32(slope) + np.float32(inter)


def read_file(path: str) -> SliceFile:
    """Parse one DICOM file (part-10 or bare dataset)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) > 132 and data[128:132] == b"DICM":
        # meta group: always explicit VR LE; (0002,0000) UL group length
        pos = 132
        group, elem = struct.unpack_from("<HH", data, pos)
        vr = data[pos + 4:pos + 6]
        if (group, elem) != (0x0002, 0x0000) or vr != b"UL":
            raise DicomError(f"{path}: missing FileMetaInformationGroupLength")
        (meta_len,) = struct.unpack_from("<I", data, pos + 8)
        meta = _parse_dataset(data[pos + 12:pos + 12 + meta_len], explicit=True,
                              stop_at_pixels=False)
        ts = _ascii(meta.get(TAG_TRANSFER_SYNTAX, (b"", b""))[1]) or IMPLICIT_VR_LE
        body = data[pos + 12 + meta_len:]
    else:
        body, ts = data, ""
    if not ts:
        # bare dataset: detect explicit VR by a plausible VR code at +4
        ts = EXPLICIT_VR_LE if body[4:6] in _KNOWN_VRS else IMPLICIT_VR_LE
    if ts == EXPLICIT_VR_BE:
        raise DicomError(f"{path}: big-endian transfer syntax is retired/unsupported")
    if ts not in (IMPLICIT_VR_LE, EXPLICIT_VR_LE):
        raise DicomError(
            f"{path}: compressed transfer syntax {ts} — transcode to "
            "Implicit/Explicit VR Little Endian offline"
        )
    try:
        return SliceFile(path, _parse_dataset(body, explicit=(ts == EXPLICIT_VR_LE)))
    except struct.error as e:
        # truncated mid-header: a real (partial) DICOM file, not junk —
        # surface it as a DicomError so read_series can report the drop
        raise DicomError(f"{path}: truncated dataset ({e})") from e


def read_series(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Directory of slice files -> ((D, H, W) float32 HU, (z, y, x) spacing).

    Mirrors sitk.ImageSeriesReader semantics (reference
    process_lidc_idri_data.py:48-119): the largest SeriesInstanceUID group
    wins, slices sort by ImagePositionPatient z (InstanceNumber fallback),
    z-spacing is the median inter-slice distance (SliceThickness fallback).
    """
    files = sorted(glob.glob(os.path.join(path, "*.dcm")))
    if not files:  # LIDC uses .dcm, but series may be extensionless
        files = sorted(
            p for p in glob.glob(os.path.join(path, "*")) if os.path.isfile(p)
        )
    slices = []
    errors: List[DicomError] = []
    for p in files:
        try:
            s = read_file(p)
        except DicomError as e:
            errors.append(e)  # junk file in a good series: skip, remember
            continue
        except Exception:
            continue  # non-DICOM file in the directory
        if TAG_PIXEL_DATA in s.elements:
            slices.append(s)
    if not slices:
        if errors:
            raise errors[0]  # e.g. every slice is a compressed syntax
        raise DicomError(f"no readable DICOM slices under {path}")
    if errors:
        # partially corrupt series: DO NOT fail (a junk file next to good
        # slices is common), but never drop slices silently — a missing
        # mid-stack slice trains on anatomically discontinuous data
        import warnings

        warnings.warn(
            f"{len(errors)} unreadable DICOM file(s) skipped under {path} "
            f"({len(slices)} slices kept); first error: {errors[0]}",
            RuntimeWarning,
            stacklevel=2,
        )
    by_series: Dict[str, List[SliceFile]] = {}
    for s in slices:
        by_series.setdefault(s.series_uid, []).append(s)
    series = max(by_series.values(), key=len)
    if all(s.z_position is not None for s in series):
        series.sort(key=lambda s: s.z_position)
    else:
        series.sort(key=lambda s: (s.instance_number is None, s.instance_number or 0))
    vol = np.stack([s.hounsfield() for s in series])
    zs = [s.z_position for s in series if s.z_position is not None]
    if len(zs) >= 2:
        dz = float(np.median(np.abs(np.diff(np.asarray(zs, np.float64)))))
    else:
        dz = series[0].slice_thickness or 1.0
    dy, dx = series[0].pixel_spacing
    return vol.astype(np.float32), (float(dz), float(dy), float(dx))


# ---------------------------------------------------------------------------
# Minimal writer (round-trip oracle for tests / synthetic-series demos)
# ---------------------------------------------------------------------------


def _encode_element(tag: Tuple[int, int], vr: bytes, value: bytes,
                    explicit: bool) -> bytes:
    if len(value) % 2:  # DICOM values are even-length padded
        # string VRs pad with space; UI and binary VRs pad with NUL (PS3.5 §6.2)
        _STR_VRS = (b"AE", b"AS", b"CS", b"DA", b"DS", b"DT", b"IS", b"LO",
                    b"LT", b"PN", b"SH", b"ST", b"TM", b"UT")
        value += b" " if vr in _STR_VRS else b"\x00"
    head = struct.pack("<HH", *tag)
    if explicit:
        if vr in _LONG_VRS:
            return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + vr + struct.pack("<H", len(value)) + value
    return head + struct.pack("<I", len(value)) + value


def write_ct_slice(
    path: str,
    pixels: np.ndarray,
    *,
    series_uid: str = "1.2.826.0.1.3680043.2.1125.1",
    instance_number: int = 1,
    z_position: float = 0.0,
    pixel_spacing: Tuple[float, float] = (1.0, 1.0),
    slice_thickness: float = 1.0,
    rescale_slope: float = 1.0,
    rescale_intercept: float = -1024.0,
    explicit: bool = True,
    extra_sequence: bool = False,
    sequence_vr: bytes = b"SQ",
    undefined_item: bool = False,
    include_position: bool = True,
) -> str:
    """Write one valid single-frame CT slice (part-10, LE).  `pixels` is
    (Rows, Cols) int16/uint16/int8/uint8 *stored* values.  When
    `extra_sequence` is set, an undefined-length sequence with a nested
    item is embedded before PixelData to exercise the reader's sequence
    walking; `sequence_vr=b"UN"` writes it as an anonymizer-style UN
    private element whose contents are Implicit VR per PS3.5 §6.2.2
    (CP-246).  `include_position=False` omits ImagePositionPatient so the
    InstanceNumber sort fallback can be exercised."""
    pixels = np.ascontiguousarray(pixels)
    assert pixels.ndim == 2 and pixels.dtype in (np.int16, np.uint16, np.int8, np.uint8)
    bits = pixels.dtype.itemsize * 8
    signed = pixels.dtype in (np.int16, np.int8)
    ts = EXPLICIT_VR_LE if explicit else IMPLICIT_VR_LE

    def ds(x) -> bytes:
        return f"{x:g}".encode()

    body = b""
    e = lambda tag, vr, val: _encode_element(tag, vr, val, explicit)  # noqa: E731
    body += e(TAG_MODALITY, b"CS", b"CT")
    body += e(TAG_SLICE_THICKNESS, b"DS", ds(slice_thickness))
    body += e(TAG_SERIES_UID, b"UI", series_uid.encode())
    body += e(TAG_INSTANCE_NUMBER, b"IS", str(instance_number).encode())
    if include_position:
        body += e(TAG_IMAGE_POSITION, b"DS", b"0\\0\\" + ds(z_position))
    if extra_sequence:
        # (0008,1140) ReferencedImageSequence, undefined length, one item.
        # CP-246: a UN sequence's contents are Implicit VR regardless of
        # the file's transfer syntax.
        inner_explicit = explicit and sequence_vr != b"UN"
        inner = _encode_element((0x0008, 0x1150), b"UI", b"1.2.3", inner_explicit)
        if undefined_item:
            # undefined-length item: contents walked element-by-element,
            # terminated by an item delimitation tag (PS3.5 §7.5.1)
            item = (struct.pack("<HHI", 0xFFFE, 0xE000, _UNDEFINED) + inner
                    + struct.pack("<HHI", 0xFFFE, 0xE00D, 0))
        else:
            item = struct.pack("<HHI", 0xFFFE, 0xE000, len(inner)) + inner
        seq_val = item + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
        head = struct.pack("<HH", 0x0008, 0x1140)
        if explicit:
            head += sequence_vr + b"\x00\x00" + struct.pack("<I", _UNDEFINED)
        else:
            head += struct.pack("<I", _UNDEFINED)
        body += head + seq_val
    body += e(TAG_ROWS, b"US", struct.pack("<H", pixels.shape[0]))
    body += e(TAG_COLS, b"US", struct.pack("<H", pixels.shape[1]))
    body += e(TAG_PIXEL_SPACING, b"DS", ds(pixel_spacing[0]) + b"\\" + ds(pixel_spacing[1]))
    body += e(TAG_BITS_ALLOCATED, b"US", struct.pack("<H", bits))
    body += e(TAG_PIXEL_REPRESENTATION, b"US", struct.pack("<H", int(signed)))
    body += e(TAG_RESCALE_INTERCEPT, b"DS", ds(rescale_intercept))
    body += e(TAG_RESCALE_SLOPE, b"DS", ds(rescale_slope))
    body += e(TAG_PIXEL_DATA, b"OW", pixels.astype(pixels.dtype.newbyteorder("<")).tobytes())

    meta = b""
    meta += _encode_element((0x0002, 0x0002), b"UI", b"1.2.840.10008.5.1.4.1.1.2", True)
    meta += _encode_element((0x0002, 0x0003), b"UI",
                            f"{series_uid}.{instance_number}".encode(), True)
    meta += _encode_element(TAG_TRANSFER_SYNTAX, b"UI", ts.encode(), True)
    header = (b"\x00" * 128 + b"DICM"
              + _encode_element((0x0002, 0x0000), b"UL", struct.pack("<I", len(meta)), True)
              + meta)
    with open(path, "wb") as f:
        f.write(header + body)
    return path
