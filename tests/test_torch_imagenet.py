"""The port's 2-D image dataset (``saragan_tpu_torch/data/imagenet.py``) and JPEG decoder
(``csrc/host/saragan_jpeg.cc``) against the JAX package's ``saragan_tpu/data/imagenet.py``
and ``saragan_tpu/data/native.py`` for the same seed: class and label maps, file order,
the pipeline's batches and labels across epochs, every shard exactly once, the scratch
copy, the adapter's ``batch_sharded``, splits and clones; the libjpeg decode bit-equal
to the reference's ``decode_jpeg_batch`` and within 1.5/127.5 of PIL after a resize
(``tests/test_native_io.py``'s bound: PIL resizes in uint8 fixed point, the C++ in f32);
the plain PyTorch resize bit-equal to the C++ one; a non-JPEG file switching the pipeline
to PIL with the reference's warning; the decoder choice and its refusal."""

import os
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from saragan_tpu.data import imagenet as jax_imagenet
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.data import imagenet, native
from test_torch_native_io import jax_native  # noqa: F401  (the reference's built library)

torch.set_num_threads(1)


def _img(rng, h, w):
    """A smooth image with noise: JPEG keeps it close, so resizes are comparable."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    base = 127 * (1 + np.sin(3 * yy + rng.uniform(0, 3)) * np.cos(2 * xx))
    noise = rng.normal(0, 8, size=(h, w, 3))
    return np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """train/: n001 (5 .JPEG), n002 (3 .jpg only), n003 (2 .JPEG), n004 (train only);
    test/: n001, n002, n003 (2 each), n000 (test only).  Sizes vary, 20 to 48 pixels."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    spec = {"train": {"n001": (5, "JPEG"), "n002": (3, "jpg"), "n003": (2, "JPEG"),
                      "n004": (2, "JPEG")},
            "test": {"n000": (2, "JPEG"), "n001": (2, "JPEG"), "n002": (2, "jpg"),
                     "n003": (2, "JPEG")}}
    for split, classes in spec.items():
        for cls, (n, ext) in classes.items():
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = rng.integers(20, 49, size=2)
                Image.fromarray(_img(rng, h, w)).save(d / f"img_{i}.{ext}", quality=90)
    return str(root)


@pytest.mark.parametrize("num_classes", [1, 2, 3])
def test_classes_labels_and_files_equal_reference(folders, num_classes):
    ours = imagenet.ImageNetDataset(folders, num_classes=num_classes)
    ref = jax_imagenet.ImageNetDataset(folders, num_classes=num_classes)
    assert ours.label_to_ix == ref.label_to_ix and ours.ix_to_label == ref.ix_to_label
    for train in (True, False):
        assert ours.files_and_labels(train) == ref.files_and_labels(train)
    assert len(ours) == len(ref) and [ours[i] for i in range(len(ours))] == \
        [ref[i] for i in range(len(ref))]


def test_too_many_classes_raise(folders):
    with pytest.raises(ValueError, match="3 classes"):
        imagenet.ImageNetDataset(folders, num_classes=4)
    with pytest.raises(AssertionError):
        jax_imagenet.ImageNetDataset(folders, num_classes=4)


def test_scratch_copy_equals_reference(folders, tmp_path):
    ours = imagenet.ImageNetDataset(folders, str(tmp_path / "a"), copy_files=True,
                                    num_classes=3)
    ref = jax_imagenet.ImageNetDataset(folders, str(tmp_path / "b"), copy_files=True,
                                       num_classes=3)
    for train in (True, False):
        fo, lo = ours.files_and_labels(train)
        fr, lr = ref.files_and_labels(train)
        assert lo == lr
        assert [f.replace(str(tmp_path / "a"), "") for f in fo] == \
            [f.replace(str(tmp_path / "b"), "") for f in fr]
        src, _ = imagenet.ImageNetDataset(folders, num_classes=3).files_and_labels(train)
        for f, s in zip(fo, src):
            assert open(f, "rb").read() == open(s, "rb").read()
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs if ".tmp." in f]
    # a second copier finds the files and copies nothing
    again = imagenet.ImageNetDataset(folders, str(tmp_path / "a"), copy_files=True,
                                     num_classes=3)
    assert again.files_and_labels() == ours.files_and_labels()


def _pipes(files, labels, size=16, batch=4, shards=1, index=0, seed=5, channels=3):
    ours = imagenet.ImagePipeline(files, labels, size, batch, num_shards=shards,
                                  shard_index=index, seed=seed, channels=channels,
                                  decoder="pil")
    os.environ["SARAGAN_NATIVE_JPEG"] = "0"
    try:
        ref = jax_imagenet.ImagePipeline(files, labels, size, batch, num_shards=shards,
                                         shard_index=index, seed=seed, channels=channels)
    finally:
        del os.environ["SARAGAN_NATIVE_JPEG"]
    assert ref._native is None
    return ours, ref


@pytest.mark.parametrize("channels", [3, 1])
def test_pipeline_batches_and_labels_equal_reference(folders, channels):
    """Seven batches of 4 over a 12-file set: three epochs' shuffles, PIL on both sides,
    every image and label equal."""
    files, labels = imagenet.ImageNetDataset(folders, num_classes=3).files_and_labels()
    ours, ref = _pipes(files, labels, channels=channels)
    for _ in range(7):
        (bo, lo), (br, lr) = ours.next_batch(), ref.next_batch()
        assert bo.shape == (4, channels, 16, 16) and bo.dtype == np.float32
        np.testing.assert_array_equal(lo, lr)
        np.testing.assert_array_equal(bo, br)
    ours.close()
    ref.close()


@pytest.mark.parametrize("shards", [2, 3])
def test_shards_cover_each_epoch_exactly_once(folders, shards):
    files, labels = imagenet.ImageNetDataset(folders, num_classes=3).files_and_labels()
    seen = []
    for index in range(shards):
        ours, ref = _pipes(files, labels, shards=shards, index=index)
        ours._refill()
        ref._refill()
        assert ours._buffer == ref._buffer
        seen += ours._buffer
        ours.close()
        ref.close()
    assert sorted(seen) == list(range(len(files)))


def test_empty_shard_raises_as_reference(folders):
    files, labels = imagenet.ImageNetDataset(folders, num_classes=1).files_and_labels()
    ours, ref = _pipes(files[:2], labels[:2], shards=3, index=2)
    for p in (ours, ref):
        with pytest.raises(ValueError, match="empty"):
            p.next_batch()


def test_adapter_batches_splits_and_clone_equal_reference(folders):
    files, labels = imagenet.ImageNetDataset(folders, num_classes=3).files_and_labels()
    ours = imagenet.ImageDatasetAdapter(files, labels, 8, seed=9, decoder="pil")
    os.environ["SARAGAN_NATIVE_JPEG"] = "0"
    try:
        ref = jax_imagenet.ImageDatasetAdapter(files, labels, 8, seed=9)
        for o, r in ((ours, ref), (ours.clone(1), ref.clone(1))):
            for _ in range(2):
                np.testing.assert_array_equal(o.batch_sharded(2, 2, 1),
                                              r.batch_sharded(2, 2, 1))
                np.testing.assert_array_equal(o.batch(3), r.batch(3))
        for (o1, o2), (r1, r2) in ((ours.split_by_fraction(0.7), ref.split_by_fraction(0.7)),
                                   (ours.split_by_index(5), ref.split_by_index(5))):
            assert (o1.files, o1.labels, o2.files, o2.labels) == \
                (r1.files, r1.labels, r2.files, r2.labels)
            np.testing.assert_array_equal(o2.batch(2), r2.batch(2))
    finally:
        del os.environ["SARAGAN_NATIVE_JPEG"]
    assert ours.shape == ref.shape == (1, 3, 8, 8) and len(ours) == len(ref)
    with pytest.raises(NotImplementedError):
        ours.batch(2, auto_repeat=False)


def test_factory_sizes_and_channels(folders, tmp_path):
    cfg = Config(start_shape="(1, 4, 4)", final_shape="(1, 32, 32)", dataset_path=folders,
                 latent_dim=8).finalize()
    factory = imagenet.imagenet_dataset_factory(cfg, folders, num_classes=2)
    ds = factory(3)
    assert (ds.size, ds.channels, ds.seed) == (16, 1, cfg.seed)
    assert ds.batch(2).shape == (2, 1, 16, 16)
    assert ds.files == imagenet.ImageNetDataset(folders, num_classes=2).files_and_labels()[0]


@pytest.mark.parametrize("size,channels", [(48, 3), (32, 3), (16, 3), (32, 1), (64, 3)])
def test_libjpeg_decode_equals_reference_and_is_near_pil(folders, jax_native, size,  # noqa: F811
                                                         channels):
    files, _ = imagenet.ImageNetDataset(folders, num_classes=3).files_and_labels()
    ours = native.decode_jpeg_batch(files, size, channels)
    ref = jax_native.decode_jpeg_batch(files, size, channels)
    pil = np.stack([jax_imagenet._decode_resize(f, size, channels) for f in files])
    assert ours.shape == pil.shape == (len(files), channels, size, size)
    np.testing.assert_array_equal(ours, ref)
    assert np.abs(ours - pil).max() < 1.5 / 127.5


def test_libjpeg_at_source_size_is_pil_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"s{i}.jpg")
        Image.fromarray(_img(rng, 24, 24)).save(p, quality=95)
        paths.append(p)
    np.testing.assert_array_equal(native.decode_jpeg_batch(paths, 24, 3),
                                  np.stack([imagenet._decode_resize(p, 24, 3) for p in paths]))


@pytest.mark.parametrize("size", [7, 16, 33, 64])
def test_plain_resize_equals_the_cpp_resize(folders, size):
    """The plain PyTorch triangle resize on the decoded pixels (PIL's decode, the same
    libjpeg bits at source size) equals the C++ decode + resize bit for bit."""
    files, _ = imagenet.ImageNetDataset(folders, num_classes=3).files_and_labels()
    cpp = native.decode_jpeg_batch(files, size, 3)
    for f, c in zip(files, cpp):
        with Image.open(f) as im:
            pixels = torch.from_numpy(np.array(im.convert("RGB")))
        assert torch.equal(native.resize_triangle_plain(pixels, size), torch.from_numpy(c))


def test_non_jpeg_switches_to_pil_with_the_reference_warning(folders, tmp_path):
    files, labels = imagenet.ImageNetDataset(folders, num_classes=1).files_and_labels()
    png = str(tmp_path / "odd.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png)
    assert native.decode_jpeg_batch([png], 8, 3) is None
    pipe = imagenet.ImagePipeline(files[:3] + [png], labels[:3] + [0], size=16,
                                  batch_size=4, seed=5)
    assert pipe.decoder == "libjpeg"
    with pytest.warns(RuntimeWarning, match="falling back to the PIL thread pool"):
        b, lab = pipe.next_batch()
    assert b.shape == (4, 3, 16, 16) and np.isfinite(b).all() and pipe.decoder == "pil"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipe.next_batch()  # PIL from now on, no second warning
    pipe.close()


def test_decoder_choice_and_refusal(monkeypatch):
    assert imagenet.jpeg_decoder() == "libjpeg"
    assert "saragan_jpeg.cc" in imagenet.decoder_name("libjpeg")
    assert imagenet.decoder_name("pil").startswith("PIL ")
    monkeypatch.setattr(native, "have_jpeg", lambda: False)
    assert imagenet.jpeg_decoder() == "pil"
    with pytest.raises(RuntimeError, match="without libjpeg"):
        native.decode_jpeg_batch(["x.jpg"], 8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        imagenet.jpeg_decoder()
    with pytest.raises(ValueError, match="decoder"):
        imagenet.ImagePipeline([], [], 8, 1, decoder="nvjpeg")


def test_a_second_reader_of_the_scratch_copy_waits_for_nothing(folders, tmp_path):
    """A reader that does not copy finds every destination present and returns the
    copier's paths (the busy-wait ends at once)."""
    first = imagenet.ImageNetDataset(folders, str(tmp_path), copy_files=True, num_classes=2)
    waiter = imagenet.ImageNetDataset(folders, str(tmp_path), copy_files=False, num_classes=2)
    assert waiter.files_and_labels() == first.files_and_labels()
