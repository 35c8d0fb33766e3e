"""The port's native host library (``csrc/host/saragan_io.cc`` through
``saragan_tpu_torch/data/native.py``) against ``np.load``, the Python path and the JAX
package's ``saragan_tpu/data/native.py`` on the same files: the npy probe, read and batch
read; the prefetcher's order and its f32 / f16 / bf16 bytes (bf16 without ``ml_dtypes``);
the trainer choosing the native prefetcher or, with ``--no_native_prefetch``, the Python
thread, with bit-equal checkpoints; a preempted run under the native prefetcher resuming
bit for bit; a failed build raising.

The JAX module loads ``runtime/build/libsaragan_io.so`` when someone built it; the
``jax_native`` fixture builds the reference's own sources (``runtime/*.cc``) with the same
flags into a temporary directory instead and points the JAX module at it, so the
comparison never depends on a build left in the tree.  Every comparison is exact: both
libraries run the same C++ arithmetic."""

import os
import signal
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from saragan_tpu.data import native as jax_native_mod
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.data import native
from saragan_tpu_torch.data.dataset import NumpyPathDataset, get_numpy_dataset
from saragan_tpu_torch.data.normalize import normalize_numpy
from saragan_tpu_torch.ops import _build
from saragan_tpu_torch.train import checkpoint as ckpt
from saragan_tpu_torch.train.trainer import Trainer, TrainingInterrupted

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.float32, np.int16, np.float64, np.uint8, np.float16, np.int32, np.int64]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module, bound to the reference's sources built here."""
    lib = tmp_path_factory.mktemp("ref_lib") / "libsaragan_io.so"
    _build.build_host(lib, [os.path.join(ROOT, "runtime", f)
                            for f in ("saragan_io.cc", "saragan_jpeg.cc")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_mod, "_find_lib", lambda: str(lib))
        mp.setattr(jax_native_mod, "_TRIED", False)
        mp.setattr(jax_native_mod, "_LIB", None)
        assert jax_native_mod.available()
        yield jax_native_mod


def _save(path, a):
    np.save(path, a)
    return str(path)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_load_npy_matches_np_load_and_reference(tmp_path, jax_native, dtype):
    a = (np.random.default_rng(0).normal(0, 100, size=(3, 5, 7))).astype(dtype)
    p = _save(tmp_path / "v.npy", a)
    ours, ref = native.load_npy(p), jax_native.load_npy(p)
    assert ours.dtype == ref.dtype == a.dtype and ours.shape == a.shape
    np.testing.assert_array_equal(ours, a)
    np.testing.assert_array_equal(ours, ref)


def test_load_npy_reads_what_the_parser_refuses_with_np_load(tmp_path):
    """Big-endian and Fortran-order files are np.load's, as in the reference."""
    a = np.arange(24, dtype=">f4").reshape(2, 3, 4)
    for arr in (a, np.asfortranarray(a.astype(np.float32))):
        p = _save(tmp_path / "odd.npy", arr)
        np.testing.assert_array_equal(native.load_npy(p), np.load(p))


@pytest.mark.parametrize("dtype", [np.int16, np.float64, np.float16],
                         ids=lambda d: np.dtype(d).name)
def test_load_npy_batch_converts_as_reference(tmp_path, jax_native, dtype):
    rng = np.random.default_rng(1)
    arrays = [rng.integers(-1024, 3072, size=(4, 6, 6)).astype(dtype) for _ in range(6)]
    paths = [_save(tmp_path / f"ct{i}.npy", a) for i, a in enumerate(arrays)]
    ours = np.empty((6, 4, 6, 6), np.float32)
    ref = np.empty_like(ours)
    assert native.load_npy_batch(paths, ours, num_threads=3)
    assert jax_native.load_npy_batch(paths, ref, num_threads=3)
    np.testing.assert_array_equal(ours, np.stack(arrays).astype(np.float32))
    np.testing.assert_array_equal(ours, ref)


def test_load_npy_batch_refuses_a_mismatch(tmp_path, jax_native):
    p = _save(tmp_path / "a.npy", np.zeros((2, 2), np.float32))
    out = np.empty((1, 3, 3), np.float32)
    assert not native.load_npy_batch([p], out)
    assert not jax_native.load_npy_batch([p], out)
    with pytest.raises(ValueError, match="float32"):
        native.load_npy_batch([p], np.empty((1, 2, 2), np.float64))


def test_dataset_batches_equal_np_load(tmp_path):
    """The dataset's native batch read equals the stacked np.load batch of the same
    paths, for float32 and int16 files."""
    rng = np.random.default_rng(2)
    d = tmp_path / "8x8"
    d.mkdir()
    for i in range(5):
        dt = np.float32 if i % 2 else np.int16
        np.save(d / f"{i}.npy", (100 * rng.normal(size=(8, 8, 8))).astype(dt))
    ds = NumpyPathDataset(str(d), seed=3)
    paths = ds.batch_paths(4)
    want = np.stack([np.load(p).astype(np.float32) for p in paths])[:, None]
    got = ds._load_batch_from_filelist(paths)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _volumes(root, n=7, size=6):
    rng = np.random.default_rng(4)
    d = os.path.join(root, f"{size}x{size}")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        np.save(os.path.join(d, f"{i:03d}.npy"), rng.normal(3, 2, size=(size,) * 3)
                .astype(np.float32))
    return d


def _path_stream(d, batch):
    ds = NumpyPathDataset(d, seed=11)
    return lambda: ds.batch_paths(batch)


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("out", ["float32", "float16", "bfloat16"])
def test_prefetcher_bytes_equal_reference_and_python_path(tmp_path, jax_native, out,
                                                          normalize):
    """Six batches of 3 through the port's prefetcher, the reference's and the Python
    path (np.load, normalize_numpy, torch's cast) from three equal path streams: every
    batch in the same order, bit for bit."""
    d = _volumes(str(tmp_path))
    mean, std = (3.0, 2.0) if normalize else (None, None)
    dtype = getattr(torch, out)
    ref_dtype = {"float32": np.float32, "float16": np.float16,
                 "bfloat16": ml_dtypes.bfloat16}[out]
    ours = native.NativeBatchPrefetcher(_path_stream(d, 3), (1, 6, 6, 6), mean, std,
                                        out_dtype=dtype)
    ref = jax_native.NativeBatchPrefetcher(_path_stream(d, 3), (1, 6, 6, 6), mean, std,
                                           out_dtype=ref_dtype)
    python_paths = _path_stream(d, 3)
    try:
        for _ in range(6):
            a, b = next(ours), next(ref)
            paths = python_paths()
            py = normalize_numpy(np.stack([np.load(p) for p in paths])[:, None], mean, std)
            want = torch.from_numpy(np.ascontiguousarray(py, np.float32)).to(dtype)
            assert a.dtype == dtype and a.shape == (3, 1, 6, 6, 6) == b.shape
            bits = torch.int16 if dtype != torch.float32 else torch.int32
            assert torch.equal(a.view(bits), want.view(bits))
            np.testing.assert_array_equal(a.view(bits).numpy(),
                                          b.view(np.int16 if bits == torch.int16 else np.int32))
    finally:
        ours.stop()
        ref.stop()


_BF16_WITHOUT_ML_DTYPES = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"ml_dtypes", "jax", "saragan_tpu"}:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np, torch
from saragan_tpu_torch.data import native
d = sys.argv[1]
paths = [f"{d}/{i:03d}.npy" for i in range(4)]
pf = native.NativeBatchPrefetcher(lambda: paths, (1, 6, 6, 6), 3.0, 2.0,
                                  out_dtype=torch.bfloat16)
got = next(pf)
pf.stop()
want = torch.from_numpy((np.stack([np.load(p) for p in paths])[:, None] - 3.0) / 2.0)
assert got.dtype == torch.bfloat16
assert torch.equal(got.view(torch.int16), want.float().to(torch.bfloat16).view(torch.int16))
assert "ml_dtypes" not in sys.modules
print("ok")
"""


def test_bf16_batches_need_no_ml_dtypes(tmp_path):
    d = _volumes(str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _BF16_WITHOUT_ML_DTYPES, d], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["ok"], out.stderr


def test_prefetcher_refuses_half_normalization(tmp_path):
    d = _volumes(str(tmp_path))
    with pytest.raises(ValueError, match="both"):
        native.NativeBatchPrefetcher(_path_stream(d, 2), (1, 6, 6, 6), 1.0, None)
    with pytest.raises(ValueError, match="out_dtype"):
        native.NativeBatchPrefetcher(_path_stream(d, 2), (1, 6, 6, 6), None, None,
                                     out_dtype=torch.float64)


def test_prefetcher_reports_a_bad_file(tmp_path):
    d = _volumes(str(tmp_path))
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((5, 5, 5), np.float32))
    pf = native.NativeBatchPrefetcher(lambda: [os.path.join(d, "000.npy"), bad],
                                      (1, 6, 6, 6), None, None, depth=1)
    with pytest.raises(RuntimeError, match="native prefetch failed"):
        next(pf)


def _cfg(tmp_path, logdir, **kw):
    d = dict(architecture="pgan", dataset_path=str(tmp_path / "data"),
             start_shape="(1, 4, 4, 4)", final_shape="(1, 8, 8, 8)", starting_phase=1,
             ending_phase=1, latent_dim=16, base_batch_size=4, mixing_nimg=16,
             stabilizing_nimg=16, checkpoint_every_nsteps=10_000,
             summary_small_every_nsteps=8, summary_large_every_nsteps=1_000,
             filter_spec=[[8, 8]], loss_fn="wgan", gp_weight=10.0, noise_stddev=0.0,
             g_lr=1e-3, d_lr=1e-3, validation_fraction=0.0, test_fraction=0.0,
             grad_histograms=False, logdir=str(tmp_path / logdir))
    d.update(kw)
    return Config(**d).finalize()


def _pipelines(logdir):
    import json

    with open(os.path.join(logdir, "events.jsonl")) as f:
        ev = [json.loads(line) for line in f]
    return ([e["text"] for e in ev if e["tag"] == "config/input_pipeline"],
            [e["value"] for e in ev if e["tag"] == "Timing/input_wait_ms"])


def _assert_same_checkpoints(a, b):
    pa, ea, ma = ckpt.load_params(os.path.join(a, "model_1.npz"), "cpu")
    pb, eb, mb = ckpt.load_params(os.path.join(b, "model_1.npz"), "cpu")
    assert ma == mb and set(pa) == set(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]) and torch.equal(ea[k], eb[k]), k


@pytest.mark.parametrize("mean_std", [(None, None), (0.5, 2.0)], ids=["raw", "normalized"])
def test_trainer_picks_native_and_the_flag_picks_the_thread(tmp_path, mean_std):
    """The native prefetcher is the default for the npy pyramid; native_prefetch=False
    (``--no_native_prefetch``) runs the Python thread; both train to the same bits, in
    bf16 transfer too."""
    _volumes(str(tmp_path / "data"), n=9, size=4)
    mean, std = mean_std
    kw = dict(data_mean=mean, data_stddev=std, compute_dtype="bfloat16")
    Trainer(_cfg(tmp_path, "native", **kw), device="cpu").run()
    Trainer(_cfg(tmp_path, "thread", native_prefetch=False, **kw), device="cpu").run()
    for logdir, name in (("native", "native"), ("thread", "python_thread")):
        names, waits = _pipelines(str(tmp_path / logdir))
        assert names == [name] and len(waits) == 1 and waits[0] >= 0
    _assert_same_checkpoints(str(tmp_path / "native"), str(tmp_path / "thread"))


def test_cli_no_native_prefetch_flag(tmp_path):
    from saragan_tpu_torch.cli import build_parser, config_from_args

    argv = ["pgan", "d", "--start_shape", "(1, 4, 4, 4)", "--final_shape", "(1, 8, 8, 8)",
            "--starting_phase", "1", "--ending_phase", "1", "--latent_dim", "8",
            "--noise_stddev", "0"]
    assert config_from_args(build_parser().parse_args(argv)).native_prefetch is True
    assert config_from_args(build_parser().parse_args(
        argv + ["--no_native_prefetch"])).native_prefetch is False


class _SignalOnPaths(NumpyPathDataset):
    """Raises SIGTERM in the main thread on the `after`-th call of ``batch_paths`` (the
    native prefetcher's path stream, three jobs ahead of the step)."""

    after = None
    calls = 0

    def batch_paths(self, batch_size, auto_repeat=True):
        type(self).calls += 1
        if type(self).calls == self.after:
            signal.raise_signal(signal.SIGTERM)
        return super().batch_paths(batch_size, auto_repeat)


def test_preempted_native_run_resumes_bit_for_bit(tmp_path):
    """SIGTERM with batches in flight in the C++ queue: the resumed run (native too)
    ends bit-identical to an uninterrupted one."""
    d = _volumes(str(tmp_path / "data"), n=9, size=4)
    kw = dict(mixing_nimg=24, stabilizing_nimg=24)
    Trainer(_cfg(tmp_path, "u", **kw), device="cpu").run()

    class Interrupting(_SignalOnPaths):
        after = 6

    cfg_i = _cfg(tmp_path, "i", auto_resume=True, **kw)
    with pytest.raises(TrainingInterrupted) as e:
        Trainer(cfg_i, device="cpu",
                dataset_factory=lambda phase: Interrupting(d, seed=42)).run()
    assert 0 < e.value.global_step < 48
    assert _pipelines(str(tmp_path / "i"))[0] == ["native"]
    cfg_r = _cfg(tmp_path, "i", auto_resume=True, **kw)
    Trainer(cfg_r, device="cpu").run()
    _assert_same_checkpoints(str(tmp_path / "u"), str(tmp_path / "i"))


def test_dataset_of_the_trainer_is_path_based(tmp_path):
    _volumes(str(tmp_path / "data"), n=3, size=4)
    ds = get_numpy_dataset(1, 1, "(1, 4, 4, 4)", str(tmp_path / "data"), None)
    assert hasattr(ds, "batch_paths") and ds.shape == (1, 4, 4, 4)


def test_failed_build_raises_with_the_compiler_log(tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text('extern "C" int f() { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match="undefined_name"):
        _build.build_host(tmp_path / "libbroken.so", [src])
    assert not (tmp_path / "libbroken.so").exists()


def test_host_build_flags_follow_the_jpeg_header(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "JPEG_HEADER", tmp_path / "none.h")
    cflags, libs = _build.host_flags()
    assert "-DSARAGAN_HAVE_JPEG" not in cflags and libs == ()
    path_without = _build.host_library_path()
    (tmp_path / "none.h").write_text("")
    cflags, libs = _build.host_flags()
    assert "-DSARAGAN_HAVE_JPEG" in cflags and libs == ("-ljpeg",)
    assert _build.host_library_path() != path_without  # the flags are in the digest
