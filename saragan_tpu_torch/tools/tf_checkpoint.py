"""TF1 checkpoint (TensorBundle) interop without TensorFlow (counterpart of
``saragan_tpu/tools/tf_checkpoint.py``; the port keeps its own copy).

The reference trains with ``tf.train.Saver``, whose on-disk format is the
TensorBundle: ``<prefix>.index`` (a leveldb-table of name ->
BundleEntryProto) plus ``<prefix>.data-NNNNN-of-MMMMM`` shards of raw
little-endian tensor bytes.  The reference README releases trained
checkpoints in exactly this format (reference README.md:33-43), and the
port's parameter dict is keyed by the reference's TF variable-scope paths
("generator/generator_block_2/conv_1/weight", ...) with identical array
layouts (TF conv3d weights are [kd,kh,kw,Cin,Cout]; dense [in,out]), so a
bundle reader completes the migration path: a user of the reference loads
released or trained checkpoints into the port's npz format
(``train/checkpoint.py``) and exports back.

Implemented from the public on-disk specification (leveldb table format +
the two TensorBundle protos), Python, NumPy and torch's bfloat16:

* leveldb-table reader/writer: footer (magic 0xdb4775248b80fb57),
  crc32c(Castagnoli)-masked block checksums, prefix-compressed keys with
  restart points, snappy block decompression (decoder implemented inline —
  TF writes bundle index blocks uncompressed, but a foreign writer may not);
* minimal protobuf codec for BundleHeaderProto / BundleEntryProto /
  TensorShapeProto (hand-rolled varint wire format);
* name mapping: plain variables -> the params section,
  ``<name>/ExponentialMovingAverage`` shadows -> the ema section (the
  reference's mid-phase checkpoints carry EMA as shadow variables,
  ExtendedEMA.py; final per-phase checkpoints have EMA folded in),
  optimizer slot variables (``.../Adam``, ``beta1_power``, ...) skipped.

CRC-32C: ``google_crc32c`` when it imports, otherwise a NumPy CRC-32C that
checksums many equal chunks at once with the table of the byte-wise loop and
folds the chunk CRCs together with the GF(2) shift operator (``CRC32C_ROUTE``
names the route).  ``DT_BFLOAT16`` tensors are read through torch's bfloat16
and returned widened to float32 (exact); a torch bfloat16 tensor is written as
``DT_BFLOAT16``.  The writer is deterministic: the same tensors give the same
``.index`` and ``.data-00000-of-00001`` bytes as the JAX package's writer.

Caveats (honest scope): partitioned variables (BundleEntryProto.slices)
and DT_STRING are rejected; written bundles use a single data shard and
uncompressed blocks (readable by any leveldb-table reader, TF included).
Everything here runs on the host: a file format, no device.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, poly 0x82f63b78 reflected), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _build_crc_table() -> None:
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_crc_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC_TABLE_NP = np.asarray(_CRC_TABLE, np.uint32)
_MAX_LANES = 1 << 16  # chunks checksummed at once by the NumPy route
_MIN_LANE_BYTES = 64  # below 64 bytes a chunk, the byte-wise loop runs instead


def _apply(cols: List[int], reg: int) -> int:
    """A GF(2) 32x32 matrix, given by its columns, times the register `reg`."""
    out = 0
    for b in range(32):
        if (reg >> b) & 1:
            out ^= cols[b]
    return out


def _shift_columns(nbytes: int) -> List[int]:
    """Columns of the matrix that advances a CRC register over `nbytes` zero bytes.

    The byte step reg -> T[reg & 0xff] ^ (reg >> 8) is linear over GF(2) (T[0] = 0), so
    n zero bytes are its n-th power, taken by repeated squaring."""
    step = [_CRC_TABLE[(1 << b) & 0xFF] ^ ((1 << b) >> 8) for b in range(32)]
    cols = [1 << b for b in range(32)]
    while nbytes:
        if nbytes & 1:
            cols = [_apply(step, c) for c in cols]
        nbytes >>= 1
        if nbytes:
            step = [_apply(step, c) for c in step]
    return cols


def _apply_np(cols: List[int], regs: np.ndarray) -> np.ndarray:
    """`_apply` on every register of a uint32 array."""
    out = np.zeros_like(regs)
    for b in range(32):
        out ^= ((regs >> b) & 1) * np.uint32(cols[b])
    return out


def _crc32c_np(data: bytes, crc: int = 0) -> int:
    """CRC-32C of `data` continuing `crc`, bit for bit ``_crc32c_py``'s.

    The body is cut into L = 2^k equal chunks whose raw CRCs (register from 0) the byte
    loop computes together, one NumPy step per byte position; chunk i's CRC is then
    shifted past the chunks after it and XORed in (a pairwise tree, one shift matrix per
    level).  The CRC's linearity gives crc(A || B) = shift_|B|(crc(A)) ^ crc(B), with the
    start register shifted over the whole body.  The tail, shorter than L, goes through
    the byte loop."""
    buf = np.frombuffer(data, np.uint8)
    lanes = 1 << max(0, int(buf.size // _MIN_LANE_BYTES).bit_length() - 1)
    lanes = min(lanes, _MAX_LANES)
    if lanes < 2:
        return _crc32c_py(data, crc)
    m = buf.size // lanes
    body = np.ascontiguousarray(buf[: lanes * m].reshape(lanes, m).T)
    regs = np.zeros(lanes, np.uint32)
    for row in body:
        regs = _CRC_TABLE_NP[(regs ^ row) & 0xFF] ^ (regs >> 8)
    length = m
    while regs.size > 1:
        regs = _apply_np(_shift_columns(length), regs[0::2]) ^ regs[1::2]
        length *= 2
    reg = _apply(_shift_columns(lanes * m), crc ^ 0xFFFFFFFF) ^ int(regs[0])
    for b in data[lanes * m:]:
        reg = _CRC_TABLE[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg ^ 0xFFFFFFFF


try:  # native path: a checkpoint has tens to hundreds of MB of tensor bytes to checksum
    import google_crc32c as _gcrc

    def crc32c(data: bytes, crc: int = 0) -> int:
        return _gcrc.extend(crc, data)

    CRC32C_ROUTE = "google_crc32c"
except ImportError:
    crc32c = _crc32c_np
    CRC32C_ROUTE = "numpy"


def masked_crc32c(data: bytes) -> int:
    """leveldb/TF checksum masking (crc.h): rot15 + 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints (leveldb and protobuf share LE base-128)
# ---------------------------------------------------------------------------


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


# ---------------------------------------------------------------------------
# snappy decompression (format spec; decode-only)
# ---------------------------------------------------------------------------


def snappy_decompress(data: bytes) -> bytes:
    length, pos = _decode_varint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            l = tag >> 2
            if l < 60:
                n = l + 1
            else:
                nbytes = l - 59
                n = int.from_bytes(data[pos : pos + nbytes], "little") + 1
                pos += nbytes
            out += data[pos : pos + n]
            pos += n
        else:
            if kind == 1:
                n = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                n = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                n = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise ValueError("snappy: bad copy offset")
            start = len(out) - offset
            for i in range(n):  # overlapping copies are byte-serial by spec
                out.append(out[start + i])
    if len(out) != length:
        raise ValueError(f"snappy: expected {length} bytes, got {len(out)}")
    return bytes(out)


# ---------------------------------------------------------------------------
# leveldb table blocks
# ---------------------------------------------------------------------------

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_SIZE = 48


def _parse_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) from one block (prefix-compressed + restarts)."""
    if len(block) < 4:
        raise ValueError("block too small")
    num_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * num_restarts
    if data_end < 0:
        raise ValueError("corrupt block trailer")
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _decode_varint(block, pos)
        unshared, pos = _decode_varint(block, pos)
        value_len, pos = _decode_varint(block, pos)
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _read_block(blob: bytes, offset: int, size: int, verify: bool = True) -> bytes:
    contents = blob[offset : offset + size]
    btype = blob[offset + size]
    if verify:
        stored = struct.unpack("<I", blob[offset + size + 1 : offset + size + 5])[0]
        actual = masked_crc32c(blob[offset : offset + size + 1])
        if stored != actual:
            raise ValueError(f"block crc mismatch at offset {offset}")
    if btype == 1:
        contents = snappy_decompress(contents)
    elif btype != 0:
        raise ValueError(f"unknown block compression type {btype}")
    return contents


def _build_block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """Uncompressed block, restart point at every entry (valid, simple)."""
    out = bytearray()
    restarts = []
    for key, value in entries:
        restarts.append(len(out))
        out += _encode_varint(0)  # shared
        out += _encode_varint(len(key))
        out += _encode_varint(len(value))
        out += key
        out += value
    if not entries:
        restarts.append(0)
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def _append_block(f_parts: List[bytes], offset: int, block: bytes) -> Tuple[int, int, int]:
    """Append block + trailer; return (handle_offset, handle_size, new_offset)."""
    trailer = bytes([0]) + struct.pack("<I", masked_crc32c(block + bytes([0])))
    f_parts.append(block + trailer)
    return offset, len(block), offset + len(block) + 5


# ---------------------------------------------------------------------------
# minimal protobuf: BundleHeaderProto / BundleEntryProto / TensorShapeProto
# ---------------------------------------------------------------------------

# tensorflow DataType enum values <-> numpy dtypes
_DTYPES = {
    1: np.dtype(np.float32),
    2: np.dtype(np.float64),
    3: np.dtype(np.int32),
    4: np.dtype(np.uint8),
    5: np.dtype(np.int16),
    6: np.dtype(np.int8),
    9: np.dtype(np.int64),
    10: np.dtype(np.bool_),
    17: np.dtype(np.uint16),
    19: np.dtype(np.float16),
    22: np.dtype(np.uint32),
    23: np.dtype(np.uint64),
}
_DT_BFLOAT16 = 14


def _dtype_to_enum(dt) -> int:
    if dt == torch.bfloat16 or getattr(dt, "name", None) == "bfloat16":
        return _DT_BFLOAT16
    for enum, nd in _DTYPES.items():
        if nd == dt:
            return enum
    raise ValueError(f"unsupported dtype for TF bundle: {dt}")


def _enum_to_dtype(enum: int):
    """The numpy dtype of a TF DataType enum; ``torch.bfloat16`` for DT_BFLOAT16 (numpy
    has no bfloat16 of its own)."""
    if enum == _DT_BFLOAT16:
        return torch.bfloat16
    if enum == 7:
        raise ValueError("DT_STRING tensors are not supported")
    if enum not in _DTYPES:
        raise ValueError(f"unsupported TF DataType enum {enum}")
    return _DTYPES[enum]


def _dtype_name(dt) -> str:
    return "bfloat16" if dt == torch.bfloat16 else np.dtype(dt).name


def _bfloat16_to_float32(data: bytes) -> np.ndarray:
    """DT_BFLOAT16 bytes as float32: every bfloat16 value is a float32 with the low 16
    mantissa bits zero, so the widening is exact."""
    if not data:
        return np.zeros(0, np.float32)
    return torch.frombuffer(bytearray(data), dtype=torch.bfloat16).float().numpy()


def _tensor_bytes(value):
    """(dtype, shape, raw little-endian bytes) of a numpy array or a torch tensor (a
    bfloat16 tensor keeps its 16-bit patterns)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return torch.bfloat16, tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        value = t.numpy()
    arr = np.ascontiguousarray(value)
    return arr.dtype, arr.shape, arr.tobytes()


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) — varint->int, length-delimited
    ->bytes, fixed32/64->int."""
    pos = 0
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _decode_varint(buf, pos)
        elif wire == 2:
            n, pos = _decode_varint(buf, pos)
            v = buf[pos : pos + n]
            pos += n
        elif wire == 5:
            v = struct.unpack("<I", buf[pos : pos + 4])[0]
            pos += 4
        elif wire == 1:
            v = struct.unpack("<Q", buf[pos : pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _field(field: int, wire: int, payload) -> bytes:
    tag = _encode_varint((field << 3) | wire)
    if wire == 0:
        return tag + _encode_varint(payload)
    if wire == 2:
        return tag + _encode_varint(len(payload)) + payload
    if wire == 5:
        return tag + struct.pack("<I", payload)
    raise ValueError(wire)


def _encode_shape(shape: Tuple[int, ...]) -> bytes:
    out = b""
    for dim in shape:
        out += _field(2, 2, _field(1, 0, int(dim)))  # Dim.size
    return out


def _decode_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, _, v in _proto_fields(buf):
        if field == 2:  # repeated Dim
            size = 0
            for f2, _, v2 in _proto_fields(v):
                if f2 == 1:
                    size = v2
            dims.append(size)
        elif field == 3 and v:  # unknown_rank
            raise ValueError("unknown-rank shape in bundle entry")
    return tuple(dims)


class BundleEntry:
    def __init__(self, dtype: np.dtype, shape: Tuple[int, ...], shard_id: int,
                 offset: int, size: int, crc: int):
        self.dtype, self.shape = dtype, shape
        self.shard_id, self.offset, self.size, self.crc = shard_id, offset, size, crc

    def encode(self) -> bytes:
        out = _field(1, 0, _dtype_to_enum(self.dtype))
        out += _field(2, 2, _encode_shape(self.shape))
        if self.shard_id:
            out += _field(3, 0, self.shard_id)
        if self.offset:
            out += _field(4, 0, self.offset)
        out += _field(5, 0, self.size)
        out += _field(6, 5, self.crc)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "BundleEntry":
        dtype, shape, shard, offset, size, crc = np.dtype(np.float32), (), 0, 0, 0, 0
        for field, _, v in _proto_fields(buf):
            if field == 1:
                dtype = _enum_to_dtype(v)
            elif field == 2:
                shape = _decode_shape(v)
            elif field == 3:
                shard = v
            elif field == 4:
                offset = v
            elif field == 5:
                size = v
            elif field == 6:
                crc = v
            elif field == 7:
                raise ValueError(
                    "partitioned variable (BundleEntryProto.slices) not supported"
                )
        return cls(dtype, shape, shard, offset, size, crc)


def _encode_header(num_shards: int) -> bytes:
    # BundleHeaderProto: num_shards=1, endianness LITTLE(0) implicit,
    # version.producer=1 (checkpoint V2 bundles write producer 1)
    return _field(1, 0, num_shards) + _field(3, 2, _field(1, 0, 1))


def _decode_header(buf: bytes) -> int:
    num_shards = 1
    for field, _, v in _proto_fields(buf):
        if field == 1:
            num_shards = v
        elif field == 2 and v == 1:
            raise ValueError("big-endian TF bundles are not supported")
    return num_shards


# ---------------------------------------------------------------------------
# bundle read / write
# ---------------------------------------------------------------------------


def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def read_index_entries(index_path: str, verify: bool = True) -> Dict[str, bytes]:
    """All (key -> raw value bytes) pairs of a leveldb-table index file."""
    with open(index_path, "rb") as f:
        blob = f.read()
    if len(blob) < _FOOTER_SIZE:
        raise ValueError(f"{index_path}: too small for a table footer")
    footer = blob[-_FOOTER_SIZE:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{index_path}: bad table magic {magic:#x}")
    pos = 0
    _mi_off, pos = _decode_varint(footer, pos)
    _mi_size, pos = _decode_varint(footer, pos)
    ix_off, pos = _decode_varint(footer, pos)
    ix_size, pos = _decode_varint(footer, pos)
    index_block = _read_block(blob, ix_off, ix_size, verify)

    out: Dict[str, bytes] = {}
    for _sep_key, handle in _parse_block_entries(index_block):
        hpos = 0
        d_off, hpos = _decode_varint(handle, hpos)
        d_size, hpos = _decode_varint(handle, hpos)
        for key, value in _parse_block_entries(_read_block(blob, d_off, d_size, verify)):
            out[key.decode("utf-8")] = value
    return out


def read_tensor_bundle(prefix: str, verify: bool = True) -> Dict[str, np.ndarray]:
    """Read every tensor of a TF checkpoint bundle into numpy arrays (DT_BFLOAT16 ones
    widened to float32, exactly)."""
    raw = read_index_entries(prefix + ".index", verify)
    if "" not in raw:
        raise ValueError(f"{prefix}.index: missing bundle header entry")
    num_shards = _decode_header(raw.pop(""))
    shards: Dict[int, bytes] = {}
    for shard in range(num_shards):
        with open(_shard_path(prefix, shard, num_shards), "rb") as f:
            shards[shard] = f.read()
    tensors: Dict[str, np.ndarray] = {}
    for name, value in raw.items():
        e = BundleEntry.decode(value)
        data = shards[e.shard_id][e.offset : e.offset + e.size]
        if len(data) != e.size:
            raise ValueError(f"{name}: truncated data shard")
        if verify and e.crc and masked_crc32c(data) != e.crc:
            raise ValueError(f"{name}: tensor crc mismatch")
        if e.dtype == torch.bfloat16:
            arr = _bfloat16_to_float32(data)
        else:
            arr = np.frombuffer(data, dtype=e.dtype)
        tensors[name] = arr.reshape(e.shape) if e.shape else arr.reshape(())
    return tensors


def write_tensor_bundle(prefix: str, tensors: Dict[str, object]) -> str:
    """Write a single-shard TF-readable checkpoint bundle of numpy arrays or torch
    tensors (a bfloat16 tensor as DT_BFLOAT16)."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    keys = sorted(tensors)
    data_parts: List[bytes] = []
    entries: List[Tuple[bytes, bytes]] = [(b"", _encode_header(1))]
    offset = 0
    for k in keys:
        dtype, shape, raw = _tensor_bytes(tensors[k])
        entries.append(
            (
                k.encode("utf-8"),
                BundleEntry(dtype, shape, 0, offset, len(raw), masked_crc32c(raw)).encode(),
            )
        )
        data_parts.append(raw)
        offset += len(raw)
    with open(_shard_path(prefix, 0, 1), "wb") as f:
        for part in data_parts:
            f.write(part)

    parts: List[bytes] = []
    off = 0
    data_block = _build_block(entries)
    d_off, d_size, off = _append_block(parts, off, data_block)
    meta_block = _build_block([])
    m_off, m_size, off = _append_block(parts, off, meta_block)
    last_key = entries[-1][0]
    index_block = _build_block(
        [(last_key, _encode_varint(d_off) + _encode_varint(d_size))]
    )
    i_off, i_size, off = _append_block(parts, off, index_block)
    footer = (
        _encode_varint(m_off) + _encode_varint(m_size)
        + _encode_varint(i_off) + _encode_varint(i_size)
    )
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        for part in parts:
            f.write(part)
        f.write(footer)
    return prefix


# ---------------------------------------------------------------------------
# name mapping: TF checkpoint <-> this repo's param/ema sections
# ---------------------------------------------------------------------------

_EMA_SUFFIX = "/ExponentialMovingAverage"
# optimizer-slot / bookkeeping variables a Saver(var_list=trainables+...)
# checkpoint may carry; never model weights (reference optimization.py uses
# Adam/SGD/Momentum/Adadelta; alpha/lr/step live as graph variables)
_SKIP_SUFFIXES = ("/Adam", "/Adam_1", "/Momentum", "/accum", "/accum_update",
                  "/RMSProp", "/RMSProp_1")
_SKIP_NAMES = ("beta1_power", "beta2_power", "global_step", "alpha", "g_lr", "d_lr",
               "global_size", "step")


def split_bundle_names(tensors: Dict[str, np.ndarray]):
    """-> (params, ema, skipped): EMA shadows to the ema section, optimizer
    slots/bookkeeping skipped, everything else params."""
    params: Dict[str, np.ndarray] = {}
    ema: Dict[str, np.ndarray] = {}
    skipped: List[str] = []
    for name, arr in tensors.items():
        if name.endswith(_EMA_SUFFIX):
            ema[name[: -len(_EMA_SUFFIX)]] = arr
        elif name in _SKIP_NAMES or name.endswith(_SKIP_SUFFIXES):
            skipped.append(name)
        else:
            params[name] = arr
    return params, ema, skipped


def import_tf_checkpoint(prefix: str, out_path: str, verify: bool = True,
                         verbose: bool = True) -> str:
    """TF bundle -> the port's .npz checkpoint (``train/checkpoint.py`` format, which
    the JAX package reads too).

    The result drops into the normal phase chain: name-intersection restore,
    EMA reseed (or the imported EMA shadows when present), --continue_path.
    """
    from saragan_tpu_torch.convert import params_from_numpy
    from saragan_tpu_torch.train.checkpoint import save_params

    tensors = read_tensor_bundle(prefix, verify=verify)
    params, ema, skipped = split_bundle_names(tensors)
    if not params:
        raise ValueError(f"{prefix}: no model variables found")
    if verbose:
        print(f"imported {len(params)} params, {len(ema)} EMA shadows; "
              f"skipped {len(skipped)} optimizer/bookkeeping vars")
        for n in sorted(params)[:8]:
            print(f"  {n} {params[n].shape} {params[n].dtype}")
    return save_params(out_path, params_from_numpy(params, "cpu"),
                       ema=params_from_numpy(ema, "cpu") if ema else None,
                       meta={"imported_from_tf": 1.0})


def export_tf_checkpoint(npz_path: str, prefix: str, include_ema: bool = True,
                         verbose: bool = True) -> str:
    """An .npz checkpoint of either package -> a TF-readable bundle (EMA as
    `/ExponentialMovingAverage` shadows, the reference's ExtendedEMA names)."""
    from saragan_tpu_torch.train.checkpoint import load_params

    params, ema, _meta = load_params(npz_path, "cpu")
    tensors: Dict[str, torch.Tensor] = dict(params)
    if include_ema and ema:
        for k, v in ema.items():
            tensors[k + _EMA_SUFFIX] = v
    if verbose:
        print(f"exporting {len(tensors)} tensors -> {prefix}.index / .data-00000-of-00001")
    return write_tensor_bundle(prefix, tensors)


def show_tf_checkpoint(prefix: str) -> List[Tuple[str, Tuple[int, ...], str]]:
    """List (name, shape, dtype) WITHOUT reading tensor data — the
    `tf.train.list_variables` analog (index file only)."""
    raw = read_index_entries(prefix + ".index")
    raw.pop("", None)
    rows = []
    for name in sorted(raw):
        e = BundleEntry.decode(raw[name])
        rows.append((name, e.shape, _dtype_name(e.dtype)))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="TF1 checkpoint (TensorBundle) import/export without TensorFlow"
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("import", help="TF checkpoint prefix -> saragan .npz")
    pi.add_argument("prefix", help="checkpoint prefix (path without .index)")
    pi.add_argument("out", help="output .npz path")
    pi.add_argument("--no_verify", action="store_true", help="skip crc32c checks")
    pe = sub.add_parser("export", help="saragan .npz -> TF checkpoint prefix")
    pe.add_argument("npz", help="input .npz checkpoint")
    pe.add_argument("prefix", help="output checkpoint prefix")
    pe.add_argument("--no_ema", action="store_true", help="omit EMA shadow variables")
    ps = sub.add_parser("show", help="list variables (tf.train.list_variables analog)")
    ps.add_argument("prefix", help="checkpoint prefix (path without .index)")
    args = p.parse_args(argv)
    if args.cmd == "import":
        import_tf_checkpoint(args.prefix, args.out, verify=not args.no_verify)
    elif args.cmd == "export":
        export_tf_checkpoint(args.npz, args.prefix, include_ema=not args.no_ema)
    else:
        for name, shape, dtype in show_tf_checkpoint(args.prefix):
            print(f"{name} {list(shape)} {dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
