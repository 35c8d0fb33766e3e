"""The port's TF TensorBundle codec (``saragan_tpu_torch/tools/tf_checkpoint.py``) against
the JAX package's: the NumPy CRC-32C bit for bit against the byte-wise table loop and
``google_crc32c``; the reference's format goldens (check value, varints, snappy streams,
prefix-compressed keys, multi-block and snappy-compressed indexes, corruption, partitioned
entries) on the port's copy; bundles written by either package read identically in the
other and are byte-identical for the same tensors (bfloat16 included: ml_dtypes arrays in
the reference, torch bfloat16 tensors in the port); bfloat16 read with ml_dtypes blocked;
and a reference-initialised pgan through npz -> bundle -> npz, bit-equal arrays and
bit-equal volumes from the port's generator."""

import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.tools import tf_checkpoint as ref
from saragan_tpu.train import checkpoint as jax_ckpt
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.core import filter_params
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.tools import tf_checkpoint as tfc
from saragan_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- CRC-32C


def test_crc32c_check_value():
    # the standard Castagnoli check value (RFC 3720 appendix / crc catalogs)
    for fn in (tfc.crc32c, tfc._crc32c_py, tfc._crc32c_np):
        assert fn(b"123456789") == 0xE3069283
    assert tfc.CRC32C_ROUTE in ("google_crc32c", "numpy")


@pytest.mark.parametrize("n", [0, 1, 63, 64, 129, 4096 + 3, 70_001, 1 << 20])
@pytest.mark.parametrize("start", [0, 0xDEADBEEF])
def test_numpy_crc32c_is_the_table_loop(n, start):
    """The lane-parallel NumPy route equals the byte-wise loop and google_crc32c on every
    length (below the lane threshold, at it, a tail past whole chunks) and continues a
    running CRC as they do."""
    import google_crc32c

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    got = tfc._crc32c_np(data, start)
    assert got == google_crc32c.extend(start, data)
    if n <= 70_001:
        assert got == tfc._crc32c_py(data, start) == ref._crc32c_py(data, start)


def test_crc32c_masking_matches_reference():
    for blob in (b"", b"some block", bytes(range(256)) * 37):
        assert tfc.masked_crc32c(blob) == ref.masked_crc32c(blob)
    c = tfc.crc32c(b"some block")
    unrot = (tfc.masked_crc32c(b"some block") - 0xA282EAD8) & 0xFFFFFFFF
    assert ((unrot >> 17) | (unrot << 15)) & 0xFFFFFFFF == c


# ---------------------------------------------------------------- primitives


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 2**31, 2**40 + 17])
def test_varint_round_trip(n):
    buf = tfc._encode_varint(n)
    assert buf == ref._encode_varint(n)
    val, pos = tfc._decode_varint(buf, 0)
    assert val == n and pos == len(buf)


@pytest.mark.parametrize("stream,expected", [
    # uncompressed length 10, literal "abcde", copy len 5 offset 5 (2-byte offset form)
    (bytes([10, (4 << 2) | 0]) + b"abcde" + bytes([(4 << 2) | 2, 5, 0]), b"abcdeabcde"),
    # "ab" then copy len 6 offset 2 -> "abababab" (overlapping, byte-serial)
    (bytes([8, (1 << 2) | 0]) + b"ab" + bytes([(5 << 2) | 2, 2, 0]), b"abababab"),
], ids=["literal_and_copy", "overlapping_copy"])
def test_snappy_streams(stream, expected):
    assert tfc.snappy_decompress(stream) == expected == ref.snappy_decompress(stream)


def test_prefix_compressed_keys_readable():
    """Real leveldb blocks share key prefixes between restarts."""
    v1, v2 = b"V1", b"V2222"
    out = bytearray()
    out += tfc._encode_varint(0) + tfc._encode_varint(5) + tfc._encode_varint(len(v1))
    out += b"gen/a" + v1
    out += tfc._encode_varint(4) + tfc._encode_varint(1) + tfc._encode_varint(len(v2))
    out += b"b" + v2
    out += (0).to_bytes(4, "little") + (1).to_bytes(4, "little")  # one restart at 0
    assert dict(tfc._parse_block_entries(bytes(out))) == {b"gen/a": v1, b"gen/b": v2}


def test_partitioned_variables_rejected():
    buf = tfc._field(1, 0, 1) + tfc._field(7, 2, b"\x08\x01")
    with pytest.raises(ValueError, match="slices"):
        tfc.BundleEntry.decode(buf)


def _write_index(prefix, blocks, block_type=0):
    """An index of `blocks` (lists of (key, value)); the first data block stored with
    `block_type` (1: one snappy literal, its length in a trailing byte past 60)."""
    parts, off, handles = [], 0, []
    for i, entries in enumerate(blocks):
        block = tfc._build_block(entries)
        if i == 0 and block_type == 1:
            n = len(block) - 1
            tag = bytes([n << 2]) if n < 60 else bytes([60 << 2, n])
            comp = tfc._encode_varint(len(block)) + tag + block
            parts.append(comp + bytes([1]) + tfc.masked_crc32c(comp + bytes([1])).to_bytes(
                4, "little"))
            handles.append((entries[-1][0], off, len(comp)))
            off += len(comp) + 5
        else:
            b_off, b_size, off = tfc._append_block(parts, off, block)
            handles.append((entries[-1][0], b_off, b_size))
    m_off, m_size, off = tfc._append_block(parts, off, tfc._build_block([]))
    index = tfc._build_block([(k, tfc._encode_varint(o) + tfc._encode_varint(s))
                              for k, o, s in handles])
    i_off, i_size, off = tfc._append_block(parts, off, index)
    footer = (tfc._encode_varint(m_off) + tfc._encode_varint(m_size)
              + tfc._encode_varint(i_off) + tfc._encode_varint(i_size))
    footer += b"\x00" * (40 - len(footer)) + (0xDB4775248B80FB57).to_bytes(8, "little")
    with open(prefix + ".index", "wb") as f:
        f.write(b"".join(parts) + footer)


@pytest.mark.parametrize("layout", ["two_data_blocks", "snappy_block"])
def test_foreign_index_layouts_read_in_both_packages(tmp_path, layout):
    """TF's table writer splits entries over several data blocks; a foreign writer may
    snappy-compress them.  Both readers walk either."""
    t1, t2 = np.float32([1, 2, 3]), np.float32([[4, 5], [6, 7]])
    e1 = tfc.BundleEntry(t1.dtype, t1.shape, 0, 0, t1.nbytes, tfc.masked_crc32c(t1.tobytes()))
    e2 = tfc.BundleEntry(t2.dtype, t2.shape, 0, t1.nbytes, t2.nbytes,
                         tfc.masked_crc32c(t2.tobytes()))
    header = (b"", tfc._encode_header(1))
    prefix = str(tmp_path / layout)
    if layout == "two_data_blocks":
        _write_index(prefix, [[header, (b"a/w", e1.encode())], [(b"b/w", e2.encode())]])
    else:
        _write_index(prefix, [[header, (b"a/w", e1.encode()), (b"b/w", e2.encode())]], 1)
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(t1.tobytes() + t2.tobytes())
    for reader in (tfc, ref):
        out = reader.read_tensor_bundle(prefix)
        np.testing.assert_array_equal(out["a/w"], t1)
        np.testing.assert_array_equal(out["b/w"], t2)


def test_corruption_detected(tmp_path):
    prefix = str(tmp_path / "ckpt")
    tfc.write_tensor_bundle(prefix, {"w": np.arange(16, dtype=np.float32)})
    data_path = prefix + ".data-00000-of-00001"
    raw = bytearray(open(data_path, "rb").read())
    raw[3] ^= 0xFF
    open(data_path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        tfc.read_tensor_bundle(prefix)
    tfc.read_tensor_bundle(prefix, verify=False)  # the opt-out reads the bytes


# ---------------------------------------------------------------- bundles, both packages


def _tensors():
    """The reference's example tensors (numpy; bfloat16 as ml_dtypes) and the same values
    in the port's form (bfloat16 as a torch tensor of the same bits)."""
    rng = np.random.default_rng(0)
    bf = rng.normal(size=(33, 5)).astype(ml_dtypes.bfloat16)
    numpy_tensors = {
        "generator/generator_in/conv/weight": rng.normal(size=(1, 3, 3, 8, 8)).astype(np.float32),
        "generator/generator_in/conv/bias": np.zeros((8,), np.float32),
        "discriminator/discriminator_out/dense_2/weight": rng.normal(size=(16, 1)),
        "counts": np.arange(7, dtype=np.int64),
        "flag": np.asarray(True),
        "scalar_step": np.asarray(123, np.int32),
        "half": rng.normal(size=(4,)).astype(np.float16),
        "big": rng.normal(size=(70, 70)).astype(np.float32),  # multi-byte varints
        "bf16_block": bf,
    }
    port = dict(numpy_tensors)
    port["bf16_block"] = torch.from_numpy(bf.view(np.int16).copy()).view(torch.bfloat16)
    port["big"] = torch.from_numpy(numpy_tensors["big"])  # a tensor is written as its array
    return numpy_tensors, port


def _files(prefix):
    return [open(prefix + ext, "rb").read() for ext in (".index", ".data-00000-of-00001")]


def test_bundles_are_byte_identical_and_read_in_both_packages(tmp_path):
    numpy_tensors, port_tensors = _tensors()
    ref.write_tensor_bundle(str(tmp_path / "ref"), numpy_tensors)
    tfc.write_tensor_bundle(str(tmp_path / "port"), port_tensors)
    assert _files(str(tmp_path / "ref")) == _files(str(tmp_path / "port"))
    for prefix in ("ref", "port"):
        by_port = tfc.read_tensor_bundle(str(tmp_path / prefix))
        by_ref = ref.read_tensor_bundle(str(tmp_path / prefix))
        assert set(by_port) == set(by_ref) == set(numpy_tensors)
        for k, want in numpy_tensors.items():
            if k == "bf16_block":  # the port widens bfloat16 to float32, exactly
                assert by_port[k].dtype == np.float32 and by_ref[k].dtype == want.dtype
                np.testing.assert_array_equal(by_port[k], want.astype(np.float32))
            else:
                assert by_port[k].dtype == by_ref[k].dtype == want.dtype, k
                np.testing.assert_array_equal(by_port[k], by_ref[k])
            np.testing.assert_array_equal(by_ref[k], want)
    assert tfc.show_tf_checkpoint(str(tmp_path / "port")) == ref.show_tf_checkpoint(
        str(tmp_path / "ref"))


_BLOCKED_READ = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"ml_dtypes", "jax", "jaxlib", "saragan_tpu"}:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
from saragan_tpu_torch.tools import tf_checkpoint as tfc
out = tfc.read_tensor_bundle(sys.argv[1])
want = np.load(sys.argv[2])
assert out["bf16_block"].dtype == np.float32
assert np.array_equal(out["bf16_block"], want), "bfloat16 values differ"
assert tfc.show_tf_checkpoint(sys.argv[1])[0][2] == "bfloat16"
assert "ml_dtypes" not in sys.modules
print("ok")
"""


def test_bfloat16_reads_without_ml_dtypes(tmp_path):
    """A bundle the reference wrote with an ml_dtypes bfloat16 array reads in a process
    where ml_dtypes (and JAX) cannot be imported: torch's bfloat16, widened to float32."""
    bf = np.random.default_rng(1).normal(size=(33, 5)).astype(ml_dtypes.bfloat16)
    ref.write_tensor_bundle(str(tmp_path / "b"), {"bf16_block": bf})
    np.save(tmp_path / "want.npy", bf.astype(np.float32))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_READ, str(tmp_path / "b"),
                          str(tmp_path / "want.npy")], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


def test_split_bundle_names_matches_reference():
    t = {
        "generator/g1/weight": np.ones(1),
        "generator/g1/weight/ExponentialMovingAverage": np.full(1, 2.0),
        "generator/g1/weight/Adam": np.zeros(1),
        "generator/g1/weight/Adam_1": np.zeros(1),
        "beta1_power": np.asarray(0.9),
        "global_step": np.asarray(7),
        "discriminator/d1/bias": np.ones(3),
    }
    params, ema, skipped = tfc.split_bundle_names(t)
    rparams, rema, rskipped = ref.split_bundle_names(t)
    assert set(params) == set(rparams) == {"generator/g1/weight", "discriminator/d1/bias"}
    assert set(ema) == set(rema) == {"generator/g1/weight"}
    assert sorted(skipped) == sorted(rskipped) == [
        "beta1_power", "generator/g1/weight/Adam", "generator/g1/weight/Adam_1",
        "global_step"]


# ---------------------------------------------------------------- end to end


def test_reference_pgan_round_trips_and_generates_equal_volumes(tmp_path):
    """A reference-initialised phase-2 pgan (params + EMA, npz written by the JAX
    package) -> the port's export -> bundle (byte-identical to the reference's export)
    -> the port's import -> npz: every array bit-equal, and the port's generator gives
    bit-equal volumes from both npz files."""
    kw = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 16, 64, 64)",
              latent_dim=32, network_size="xs", starting_phase=2, ending_phase=2)
    params = jax_arch("pgan").init(jax.random.PRNGKey(0), phase=2, cfg=JaxConfig(**kw).finalize())
    ema = {k: np.asarray(v) * 0.5 for k, v in params.items()}
    npz = jax_ckpt.save_params(str(tmp_path / "model_2"), params, ema=ema)

    assert tfc.main(["export", npz, str(tmp_path / "tf" / "model_2")]) == 0
    ref.export_tf_checkpoint(npz, str(tmp_path / "tf_ref" / "model_2"), verbose=False)
    assert _files(str(tmp_path / "tf" / "model_2")) == _files(str(tmp_path / "tf_ref" / "model_2"))
    assert tfc.main(["show", str(tmp_path / "tf" / "model_2")]) == 0
    back = str(tmp_path / "back" / "model_2")
    assert tfc.main(["import", str(tmp_path / "tf" / "model_2"), back]) == 0

    p0, e0, _ = ckpt.load_params(npz, "cpu")
    p1, e1, meta = ckpt.load_params(back, "cpu")
    assert meta["imported_from_tf"] == 1.0 and set(p1) == set(p0) and set(e1) == set(e0)
    for k in p0:
        assert torch.equal(p1[k], p0[k]) and torch.equal(e1[k], e0[k]), k

    cfg = Config(**kw).finalize()
    z = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32)).astype(np.float32))
    arch = get_architecture("pgan")
    with torch.no_grad():
        vols = [arch.generator(filter_params(p, "generator"), z, 0.0, phase=2, cfg=cfg,
                               train=False) for p in (p0, p1, e0, e1)]
    assert vols[0].shape == (2, 1, 2, 8, 8)
    assert torch.equal(vols[0], vols[1]) and torch.equal(vols[2], vols[3])
