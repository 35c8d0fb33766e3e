"""Offline data preparation (counterpart of ``saragan_tpu/tools/prepare_data.py``, the
rebuild of the reference's data_scripts/).

LIDC-IDRI CT pipeline (reference data_scripts/process_lidc_idri_data.py):
DICOM series -> resample to (1, 1, 3)mm spacing -> clip HU to
[-1024, 2048] -> pad/crop to (128, 512, 512) -> divide by 1024 ->
Lanczos-3 block-reduce pyramid {512, 256, ..., 4} -> per-resolution
`{S}x{S}/NNNN.npy` files, the layout the port's trainer reads
(``data/dataset.py::get_numpy_dataset``), and optional HDF5 packing
(reference SURFGAN_3D/scripts/convert_npy_to_hdf5.py).

The numeric stages (``resample_volume``, ``clip_pad_normalize``, the three block
reducers and ``build_pyramid``) run in torch on a device, the CUDA device unless the
caller names another.  They give the JAX package's numpy/scipy results:

* ``resample_volume`` is ``scipy.ndimage.zoom(order=1, mode="constant")``, whose output
  index i samples input coordinate i * (in - 1) / (out - 1) with out = round(in *
  factor) per axis: trilinear interpolation with aligned corners, computed in float64 as
  scipy computes it and cast to float32;
* the pyramid is computed in float64 through the same block view (reshape, permute,
  weighted sum) and written as float32, so each ``lanczos`` level is within one float32
  ulp of the reference's; ``average`` is a float64 mean too, where the reference takes
  a float32 numpy mean, so it is the more precise of the two and not bit-comparable
  (they differ by up to the float32 sum's error, k^3 * 2^-24 * max|x|); ``absmax``
  keeps numpy's first-index tie-breaking.

Readers and writers stay on the host: DICOM (SimpleITK or pydicom when installed, else
the port's pure-Python ``tools/dicom.py``), NRRD, the TFRecord codec, HDF5 packing (h5py
when installed), ``convert_npy_to_pt`` and ``extract_metadata``.  ``create_dataset`` reads
the inputs in worker processes (``spawn``: a CUDA context does not survive ``fork``) and
runs the device stages in the calling process.
"""

from __future__ import annotations

import glob
import gzip
import multiprocessing
import os
import struct
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.tools.tf_checkpoint import masked_crc32c

PAD_VALUE = -1024
CLIP_MAX = 2048
TARGET_SHAPE = (128, 512, 512)


def _as_tensor(array, device) -> torch.Tensor:
    """`array` (numpy or torch) on `device`, the CUDA device unless named."""
    dev = resolve_device(device)
    if isinstance(array, torch.Tensor):
        return array.to(dev)
    return torch.from_numpy(np.ascontiguousarray(array)).to(dev)


# ---------------------------------------------------------------------------
# Lanczos / block-reduce downsampling (reference :124-137 + block_reduce)
# ---------------------------------------------------------------------------


def _lanczos_window(x, a):
    return np.sinc(x) * np.sinc(x / a)


def lanczos_3d_filter(k: int, a: int = 4) -> np.ndarray:
    """Normalized k^3 Lanczos-a filter (reference lanczos_3d :124-137), float64."""
    d = k / 2
    ds = np.arange(-d + 0.5, d - 0.5 + 1)
    f1 = _lanczos_window(ds * (a / d), a)
    f = f1[:, None, None] * f1[None, :, None] * f1[None, None, :]
    return f / f.sum()


def _view_blocks(x: torch.Tensor, k: int) -> torch.Tensor:
    """(D, H, W) -> (D/k, H/k, W/k, k, k, k) block view."""
    D, H, W = x.shape
    if D % k or H % k or W % k:
        raise ValueError(f"volume {tuple(x.shape)} does not divide into {k}^3 blocks")
    return x.reshape(D // k, k, H // k, k, W // k, k).permute(0, 2, 4, 1, 3, 5)


def block_reduce_lanczos(x: torch.Tensor, k: int, a: int = 4) -> torch.Tensor:
    """Lanczos-filtered k^3 block downsampling, float64 (the reference multiplies its
    float32 volume by the float64 filter and sums in float64)."""
    if k == 1:
        return x
    f = torch.from_numpy(lanczos_3d_filter(k, a)).to(x.device)
    return (_view_blocks(x.double(), k) * f).sum(dim=(3, 4, 5))


def block_reduce_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """k^3 block mean, float64 (the reference's float32 mean rounds its sum in float32,
    so the two differ by up to k^3 * 2^-24 * max|x|)."""
    if k == 1:
        return x
    return _view_blocks(x.double(), k).mean(dim=(3, 4, 5))


def block_reduce_absmax(x: torch.Tensor, k: int) -> torch.Tensor:
    """Signed absolute-max pooling (reference convert_to_numpy absmax mode): the value of
    largest magnitude in each block, the first in block order on a tie (``np.argmax``'s
    rule, kept explicitly on every device)."""
    if k == 1:
        return x
    blocks = _view_blocks(x, k)
    flat = blocks.reshape(*blocks.shape[:3], -1)
    mag = flat.abs()
    order = torch.arange(flat.shape[-1], device=x.device)
    first = torch.where(mag == mag.amax(dim=-1, keepdim=True), order,
                        flat.shape[-1]).amin(dim=-1, keepdim=True)
    return torch.gather(flat, -1, first)[..., 0]


# ---------------------------------------------------------------------------
# Resampling (replacement for sitk Resample, reference :48-118)
# ---------------------------------------------------------------------------


def resample_volume(
    array,
    orig_spacing: Tuple[float, float, float],
    new_spacing: Tuple[float, float, float] = (3.0, 1.0, 1.0),
    fill_value: float = PAD_VALUE,
    device=None,
) -> torch.Tensor:
    """Linear resampling of a (D, H, W) volume to new voxel spacing: float32 on `device`.

    Spacings are (z, y, x) to match the array layout (the reference's sitk
    call uses (x, y, z) = (1, 1, 3); this is its array-order equivalent).
    Out size per axis is ``round(in * orig / new)`` and output index i samples input
    coordinate i * (in - 1) / (out - 1) (``scipy.ndimage.zoom``, scipy >= 1.6, order 1),
    which never leaves the input, so `fill_value` (scipy's cval) is never read.  Computed
    in float64 like scipy and cast to float32: within one float32 ulp of the reference.
    """
    del fill_value  # every sample lies inside the volume (see above)
    x = _as_tensor(array, device).to(torch.float32)
    factors = [o / n for o, n in zip(orig_spacing, new_spacing)]
    size = [int(round(s * f)) for s, f in zip(x.shape, factors)]
    out = F.interpolate(x.double()[None, None], size=size, mode="trilinear",
                        align_corners=True)
    return out[0, 0].to(torch.float32)


def clip_pad_normalize(array, device=None) -> torch.Tensor:
    """Clip HU, pad/crop to (128, 512, 512), divide by 1024 (reference :178-196), on
    `device`.  Keeps a float input's dtype; an integer one becomes float64, as numpy's
    division makes it."""
    x = _as_tensor(array, device)
    if not x.is_floating_point():
        x = x.double()
    x = x.clamp(PAD_VALUE, CLIP_MAX)
    z, y, w = x.shape

    def pads(total, cur):
        p = (total - cur) / 2
        return int(np.floor(p)), int(np.ceil(p))

    # center-pad / center-crop y and x to 512
    if y < 512:
        x = F.pad(x, (0, 0, *pads(512, y)), value=PAD_VALUE)
    elif y > 512:
        lo = (y - 512) // 2
        x = x[:, lo: lo + 512]
    if w < 512:
        x = F.pad(x, pads(512, w), value=PAD_VALUE)
    elif w > 512:
        lo = (w - 512) // 2
        x = x[:, :, lo: lo + 512]

    # z: keep the LAST 128 slices, pad at the front (reference :188-191)
    if x.shape[0] > 128:
        x = x[x.shape[0] - 128:]
    elif x.shape[0] < 128:
        x = F.pad(x, (0, 0, 0, 0, 128 - x.shape[0], 0), value=PAD_VALUE)

    if tuple(x.shape) != TARGET_SHAPE:
        raise ValueError(f"clip_pad_normalize produced {tuple(x.shape)}")
    return x / abs(PAD_VALUE)


_REDUCERS = {
    "lanczos": block_reduce_lanczos,
    "average": block_reduce_mean,
    "absmax": block_reduce_absmax,
}


def build_pyramid(array, num_levels: int = 8, method: str = "lanczos",
                  device=None) -> List[torch.Tensor]:
    """Full-res + 7 halvings (reference :199-204): level i reduces level 0 by 2^i, on
    `device` (float64 for lanczos and average)."""
    reduce_fn = _REDUCERS[method]
    x = _as_tensor(array, device)
    src = x if method == "absmax" else x.double()  # widened once for every level
    return [x] + [reduce_fn(src, 2 ** i) for i in range(1, num_levels)]


# ---------------------------------------------------------------------------
# Input readers (host)
# ---------------------------------------------------------------------------


def read_dicom_series(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """DICOM series -> ((D, H, W) HU array, (z, y, x) spacing).

    Prefers SimpleITK / pydicom when installed (full-format coverage,
    matching the reference's sitk.ImageSeriesReader path,
    process_lidc_idri_data.py:48-119); otherwise falls back to the
    port's pure-Python reader (tools/dicom.py) which covers the
    uncompressed little-endian syntaxes LIDC-IDRI CT actually uses."""
    try:
        import SimpleITK as sitk  # noqa

        reader = sitk.ImageSeriesReader()
        reader.SetFileNames(reader.GetGDCMSeriesFileNames(path))
        image = reader.Execute()
        sx, sy, sz = image.GetSpacing()
        return sitk.GetArrayFromImage(image).astype(np.float32), (sz, sy, sx)
    except ImportError:
        pass
    try:
        import pydicom

        files = sorted(glob.glob(os.path.join(path, "*.dcm")))
        slices = [pydicom.dcmread(f) for f in files]
        slices.sort(key=lambda s: float(s.ImagePositionPatient[2]))
        arr = np.stack([s.pixel_array * float(s.RescaleSlope) + float(s.RescaleIntercept)
                        for s in slices]).astype(np.float32)
        dz = abs(float(slices[1].ImagePositionPatient[2]) - float(slices[0].ImagePositionPatient[2]))
        dy, dx = (float(v) for v in slices[0].PixelSpacing)
        return arr, (dz, dy, dx)
    except ImportError:
        pass
    from saragan_tpu_torch.tools import dicom

    return dicom.read_series(path)


def read_nrrd(path: str) -> Tuple[np.ndarray, dict]:
    """Minimal NRRD reader (raw/gzip little-endian) — replaces the `nrrd`
    dependency of reference convert_nrrd_to_numpy_pgan.py."""
    with open(path, "rb") as f:
        header = {}
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path}: not a NRRD file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            line = line.decode("ascii", "ignore").strip()
            if line.startswith("#") or ":" not in line:
                continue
            key, _, value = line.partition(":")
            header[key.strip()] = value.lstrip("=").strip()
        payload = f.read()

    dtype_map = {
        "float": np.float32, "double": np.float64, "short": np.int16,
        "signed short": np.int16, "unsigned short": np.uint16,
        "int": np.int32, "uchar": np.uint8, "unsigned char": np.uint8,
    }
    dtype = dtype_map[header["type"]]
    sizes = [int(s) for s in header["sizes"].split()]
    enc = header.get("encoding", "raw")
    if enc in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif enc != "raw":
        raise NotImplementedError(f"NRRD encoding {enc}")
    arr = np.frombuffer(payload, dtype=dtype)
    # NRRD sizes are fastest-first; numpy shape is slowest-first
    return arr.reshape(sizes[::-1]), header


def read_input(path: str) -> Tuple[np.ndarray, Optional[Tuple[float, float, float]]]:
    """One input of ``create_dataset`` -> (array, (z, y, x) spacing or None): a DICOM
    series directory (resampled later), an ``.nrrd`` or an ``.npy`` volume."""
    if os.path.isdir(path):
        return read_dicom_series(path)
    if path.endswith(".nrrd"):
        return read_nrrd(path)[0], None
    return np.load(path), None


# ---------------------------------------------------------------------------
# Dataset creation (reference create_lidc_idri_dataset.py + Pool fan-out)
# ---------------------------------------------------------------------------


def process_volume(array, orig_spacing=None, method: str = "lanczos",
                   device=None) -> List[torch.Tensor]:
    """One volume through resample -> clip/pad/normalize -> pyramid, on `device`."""
    dev = resolve_device(device)
    if orig_spacing is not None:
        array = resample_volume(array, orig_spacing, device=dev)
    return build_pyramid(clip_pad_normalize(array, device=dev), method=method, device=dev)


def _level_dir(out_dir: str, level_shape: Tuple[int, int, int]) -> str:
    s = level_shape[-1]
    return os.path.join(out_dir, f"{s}x{s}")


def write_pyramid(pyramid: List[torch.Tensor], out_dir: str, index: int):
    for level in pyramid:
        d = _level_dir(out_dir, tuple(level.shape))
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{index:04d}.npy"),
                level.to(torch.float32).cpu().numpy())


def create_dataset(
    inputs: Iterable[str],
    out_dir: str,
    method: str = "lanczos",
    num_workers: int = 1,
    device=None,
) -> List[int]:
    """Every input (sorted) through ``process_volume`` into ``out_dir/{S}x{S}/NNNN.npy``.

    With ``num_workers > 1`` a ``spawn`` pool reads the files (the reference fans the
    whole pipeline out over a ``multiprocessing.Pool``); the device stages run here, in
    input order, while the workers read ahead."""
    dev = resolve_device(device)
    paths = sorted(inputs)

    def process(reads):
        for index, (array, spacing) in enumerate(reads):
            write_pyramid(process_volume(array, spacing, method, dev), out_dir, index)
        return list(range(len(paths)))

    if num_workers <= 1:
        return process(map(read_input, paths))
    with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
        return process(pool.imap(read_input, paths))


def pack_npy_to_hdf5(npy_dir: str, h5_path: str, dataset_name: str = "volumes"):
    """npy dir -> one HDF5 file (reference scripts/convert_npy_to_hdf5.py)."""
    import h5py

    files = sorted(glob.glob(os.path.join(npy_dir, "*.npy")))
    if not files:
        raise FileNotFoundError(f"no .npy files under {npy_dir}")
    first = np.load(files[0])
    with h5py.File(h5_path, "w") as f:
        ds = f.create_dataset(dataset_name, shape=(len(files), *first.shape), dtype=first.dtype)
        for i, p in enumerate(files):
            ds[i] = np.load(p)
    return h5_path


# ---------------------------------------------------------------------------
# TFRecord codec — pure Python, no TensorFlow dependency.
#
# The reference stores LIDC volumes as TFRecords of tf.train.Example with a
# single packed-float 'image' feature and converts them to .npy / .pt
# (data_scripts/convert_to_numpy.py:8-35, convert_to_torch.py).  The wire
# format is small enough to implement directly: each record is
#   uint64le length | uint32le masked_crc32c(length) |
#   data             | uint32le masked_crc32c(data)
# and the Example payload is three nested length-delimited protobuf fields
# (Example.features -> Features.feature[map] -> Feature.float_list).  The
# CRC-32C is tools/tf_checkpoint.py's (google_crc32c, else the NumPy route).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited protobuf field."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_float_example(values: np.ndarray, key: str = "image") -> bytes:
    """tf.train.Example with one packed-float feature (the reference's
    TFRecord schema, convert_to_numpy.py:9-11)."""
    float_list = _ld(1, np.asarray(values, "<f4").tobytes())
    feature = _ld(2, float_list)  # Feature.float_list
    entry = _ld(1, key.encode()) + _ld(2, feature)  # map<string, Feature>
    features = _ld(1, entry)  # Features.feature
    return _ld(1, features)  # Example.features


def decode_float_example(data: bytes, key: str = "image") -> np.ndarray:
    """Parse the float_list of `key` out of a serialized Example."""

    def fields(buf):
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 2:
                ln, pos = _read_varint(buf, pos)
                yield field, buf[pos: pos + ln], None
                pos += ln
            elif wire == 0:
                val, pos = _read_varint(buf, pos)
                yield field, None, val
            elif wire == 5:
                yield field, buf[pos: pos + 4], None
                pos += 4
            else:
                raise NotImplementedError(f"wire type {wire}")

    for f1, features, _ in fields(data):
        if f1 != 1:
            continue
        for f2, entry, _ in fields(features):
            if f2 != 1:
                continue
            name, feature = None, None
            for f3, payload, _ in fields(entry):
                if f3 == 1:
                    name = payload.decode()
                elif f3 == 2:
                    feature = payload
            if name != key or feature is None:
                continue
            for f4, payload, _ in fields(feature):
                if f4 == 2:  # float_list
                    floats = bytearray()
                    for f5, packed, _ in fields(payload):
                        if f5 == 1:
                            floats += packed
                    return np.frombuffer(bytes(floats), "<f4")
    raise KeyError(f"feature {key!r} not found in Example")


def write_tfrecords(arrays: Iterable[np.ndarray], path: str, key: str = "image") -> int:
    """Volumes -> one .tfrecord file (masked-CRC framing, TF-compatible)."""
    n = 0
    with open(path, "wb") as f:
        for arr in arrays:
            data = encode_float_example(np.asarray(arr).ravel(), key)
            length = struct.pack("<Q", len(data))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))
            n += 1
    return n


def read_tfrecords(path: str, shape=None, key: str = "image",
                   verify_crc: bool = False) -> List[np.ndarray]:
    """One .tfrecord file -> list of float32 arrays (reshaped if given)."""
    out = []
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            (length,) = struct.unpack("<Q", head)
            (lcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc32c(head) != lcrc:
                raise ValueError(f"{path}: length CRC mismatch")
            if verify_crc and masked_crc32c(data) != dcrc:
                raise ValueError(f"{path}: data CRC mismatch")
            arr = decode_float_example(data, key)
            out.append(arr.reshape(shape) if shape is not None else arr)
    return out


def convert_tfrecords_to_npy(tfrecord_dir: str, out_dir: str, shape) -> int:
    """Reference data_scripts/convert_to_numpy.py:37-62 — every .tfrecord in
    `tfrecord_dir` unpacked to sequentially numbered NNNN.npy files."""
    files = sorted(glob.glob(os.path.join(tfrecord_dir, "*.tfrecord")))
    if not files:
        raise FileNotFoundError(f"no .tfrecord files under {tfrecord_dir}")
    os.makedirs(out_dir, exist_ok=True)
    i = 0
    for path in files:
        for arr in read_tfrecords(path, shape):
            np.save(os.path.join(out_dir, f"{i:04d}.npy"), arr.astype(np.float32))
            i += 1
    return i


def convert_npy_to_pt(npy_root: str, out_root: str,
                      sizes=(4, 8, 16, 32, 64, 128, 256, 512)) -> int:
    """npy pyramid -> torch .pt pyramid (reference data_scripts/convert_npy_pt.py:
    int16 cast, per-size `{S}x{S}` folders, sequential NNNN.pt names)."""
    n = 0
    for size in sizes:
        folder = os.path.join(npy_root, f"{size}x{size}")
        if not os.path.isdir(folder):
            continue
        out_folder = os.path.join(out_root, f"{size}x{size}")
        os.makedirs(out_folder, exist_ok=True)
        for i, path in enumerate(sorted(glob.glob(os.path.join(folder, "*.npy")))):
            tensor = torch.from_numpy(np.load(path).astype(np.int16))
            torch.save(tensor, os.path.join(out_folder, f"{i:04d}.pt"))
            n += 1
    return n


# ---------------------------------------------------------------------------
# Metadata extraction (reference data_scripts/extract_metadata.py)
# ---------------------------------------------------------------------------


def volume_metadata(array: np.ndarray, path: str = "", spacing=None,
                    origin=None, direction=None) -> dict:
    """Stats row for one volume — same columns as the reference's map_fn
    (extract_metadata.py:43-66)."""
    return {
        "path": path,
        "orig_depth": int(array.shape[0]),
        "orig_spacing": tuple(spacing) if spacing is not None else None,
        "orig_origin": tuple(origin) if origin is not None else None,
        "orig_direction": tuple(direction) if direction is not None else None,
        "orig_size": tuple(int(s) for s in array.shape[::-1]),
        "orig_min": float(array.min()),
        "orig_max": float(array.max()),
        "orig_mean": float(array.mean()),
        "orig_std": float(array.std()),
        "orig_median": float(np.median(array)),
    }


def get_dcm_paths(root: str) -> Iterable[str]:
    """Directories under `root` containing .dcm files
    (reference extract_metadata.py:13-17)."""
    for directory, _, files in os.walk(root):
        if any(f.endswith(".dcm") for f in files):
            yield directory


def extract_metadata(root: str, csv_path: str, num_workers: int = 1) -> int:
    """Walk `root` for DICOM series (or loose .npy volumes), extract per-volume
    stats, write a metadata CSV (reference extract_metadata.py; DICOM read
    via sitk/pydicom when installed, else the port's pure-Python reader)."""
    import csv

    rows = []
    for d in get_dcm_paths(root):
        array, spacing = read_dicom_series(d)
        rows.append(volume_metadata(array, d, spacing))
    for p in sorted(glob.glob(os.path.join(root, "**", "*.npy"), recursive=True)):
        rows.append(volume_metadata(np.load(p), p))
    if not rows:
        raise FileNotFoundError(f"no DICOM series or .npy volumes under {root}")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return len(rows)
