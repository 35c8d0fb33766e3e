"""The 2-D image dataset (own copy of ``saragan_tpu/data/imagenet.py``): ImageNet-style
class folders of JPEGs.

* ``ImageNetDataset``: ``train/`` and ``test/`` class folders, their intersection, the
  first ``num_classes`` classes (sorted), label <-> index maps, ``*.JPEG`` then ``*.jpg``
  files per class (sorted), and an optional copy to a scratch directory (temporary name,
  atomic rename, then a busy-wait until every file exists);
* ``ImagePipeline``: per epoch e a shuffle by ``random.Random(f"{seed}/{e}")`` that every
  shard computes alike, each shard reading its interleaved slice (exactly once per
  epoch), decode -> resize to the phase's resolution -> [-1, 1] -> CHW -> batch;
* ``ImageDatasetAdapter``: the npy dataset's batching interface over an image list, so
  the trainer's phase loop runs 2-D unchanged; ``imagenet_dataset_factory``: one adapter
  per phase at that phase's resolution.

The decoder (``jpeg_decoder``): the port's libjpeg decoder with the C++ antialiased
triangle resize (``csrc/host/saragan_jpeg.cc``) where the host library was built against
libjpeg, else PIL; neither raises and names what it looked for.  As in the JAX package, a
file libjpeg cannot decode (a PNG in the folder) makes the pipeline warn and decode with
PIL from then on.  Every file order, label and shard is the JAX package's for the same
seed.
"""

from __future__ import annotations

import glob
import os
import random
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from saragan_tpu_torch.data import native
from saragan_tpu_torch.ops import _build

DECODERS = ("libjpeg", "pil")


def jpeg_decoder() -> str:
    """The decoder this machine has: "libjpeg" (the host library built against it), else
    "pil"; raises when it has neither."""
    if native.have_jpeg():
        return "libjpeg"
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"no JPEG decoder: the host library has no libjpeg "
                           f"({_build.JPEG_HEADER} not found) and PIL is not "
                           f"installed") from e
    return "pil"


def decoder_name(decoder: str) -> str:
    """A printable name of `decoder`, with PIL's version."""
    if decoder == "libjpeg":
        return "libjpeg + C++ triangle resize (csrc/host/saragan_jpeg.cc)"
    import PIL

    return f"PIL {PIL.__version__}"


def _decode_resize(path: str, size: int, channels: int = 3) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB" if channels == 3 else "L").resize((size, size),
                                                                 Image.BILINEAR)
        arr = np.asarray(im, np.float32)
    arr = arr / 127.5 - 1.0
    if arr.ndim == 2:
        return arr[None]
    return np.transpose(arr, (2, 0, 1))


class ImageNetDataset:
    def __init__(self, imagenet_dir: str, scratch_dir: Optional[str] = None,
                 copy_files: bool = False, is_correct_phase: bool = True,
                 num_classes: int = 1):
        train_folder = os.path.join(imagenet_dir, "train")
        test_folder = os.path.join(imagenet_dir, "test")

        def class_dirs(folder):
            return {d for d in os.listdir(folder) if os.path.isdir(os.path.join(folder, d))}

        classes = sorted(class_dirs(train_folder) & class_dirs(test_folder))[:num_classes]
        if len(classes) != num_classes:
            raise ValueError(f"{imagenet_dir} has {len(classes)} classes in both train/ "
                             f"and test/, {num_classes} asked for")
        self.label_to_ix = {label: i for i, label in enumerate(classes)}
        self.ix_to_label = {i: label for label, i in self.label_to_ix.items()}

        def collect(folder):
            files, labels = [], []
            for label in classes:
                for f in (sorted(glob.glob(os.path.join(folder, label, "*.JPEG")))
                          or sorted(glob.glob(os.path.join(folder, label, "*.jpg")))):
                    files.append(f)
                    labels.append(self.label_to_ix[label])
            return files, labels

        train_examples, self.train_labels = collect(train_folder)
        test_examples, self.test_labels = collect(test_folder)

        if scratch_dir is not None and is_correct_phase:
            scratch_dir = os.path.normpath(scratch_dir)

            def to_scratch(files):
                out = []
                for f in files:
                    dst = os.path.normpath(scratch_dir + "/" + f)
                    if copy_files:
                        os.makedirs(os.path.dirname(dst), exist_ok=True)
                        if not os.path.isfile(dst):
                            # concurrent copiers are safe and the wait below never
                            # sees a truncated file
                            tmp = f"{dst}.tmp.{os.getpid()}"
                            shutil.copy(f, tmp)
                            os.replace(tmp, dst)
                    out.append(dst)
                return out

            self.scratch_files_train = to_scratch(train_examples)
            self.scratch_files_test = to_scratch(test_examples)
            for files in (self.scratch_files_train, self.scratch_files_test):
                while not all(os.path.exists(f) for f in files):
                    time.sleep(1)
        else:
            self.scratch_files_train = train_examples
            self.scratch_files_test = test_examples
        self.is_train = True

    def files_and_labels(self, train: bool = True) -> Tuple[List[str], List[int]]:
        if train:
            return self.scratch_files_train, self.train_labels
        return self.scratch_files_test, self.test_labels

    def __len__(self):
        return len(self.train_labels) if self.is_train else len(self.test_labels)

    def __getitem__(self, idx):
        return (self.train_labels if self.is_train else self.test_labels)[idx]


class ImagePipeline:
    """Per-phase batches: the shared deterministic shuffle, interleaved shards, decode on
    a thread pool (PIL) or in one native batch call (libjpeg)."""

    def __init__(self, files: List[str], labels: List[int], size: int, batch_size: int,
                 num_shards: int = 1, shard_index: int = 0, seed: int = 42,
                 num_workers: int = 4, channels: int = 3, decoder: Optional[str] = None):
        self.files = list(files)
        self.labels = list(labels)
        self.size = size
        self.channels = channels
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self._epoch = 0
        self._buffer: List[int] = []
        self._num_workers = num_workers
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self.decoder = decoder or jpeg_decoder()
        if self.decoder not in DECODERS:
            raise ValueError(f"decoder {self.decoder!r} not in {DECODERS}")

    def _refill(self):
        order = list(range(len(self.files)))
        random.Random(f"{self.seed}/{self._epoch}").shuffle(order)
        self._epoch += 1
        shard = order[self.shard_index::self.num_shards]
        if not shard:
            raise ValueError(
                f"shard {self.shard_index}/{self.num_shards} of a {len(self.files)}-file "
                f"dataset is empty — next_batch would spin forever; use fewer shards or "
                f"more files")
        self._buffer.extend(shard)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        while len(self._buffer) < self.batch_size:
            self._refill()
        idxs = self._buffer[:self.batch_size]
        self._buffer = self._buffer[self.batch_size:]
        labels = np.asarray([self.labels[i] for i in idxs], np.int32)
        if self.decoder == "libjpeg":
            batch = native.decode_jpeg_batch([self.files[i] for i in idxs], self.size,
                                             self.channels, self._num_workers)
            if batch is not None:
                return batch, labels
            # a non-JPEG or truncated file: PIL from here on, with a warning (a silent
            # switch would pay the thread-pool decode for the rest of the run unseen)
            warnings.warn(
                "native JPEG batch decode failed (one of "
                f"{[os.path.basename(self.files[i]) for i in idxs[:4]]}"
                f"{'...' if len(idxs) > 4 else ''}); falling back to the "
                "PIL thread pool for the rest of this run", RuntimeWarning)
            self.decoder = "pil"
        imgs = list(self._pool.map(
            lambda i: _decode_resize(self.files[i], self.size, self.channels), idxs))
        return np.stack(imgs), labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()

    def close(self):
        self._pool.shutdown(wait=False)


class ImageDatasetAdapter:
    """An image list with the npy dataset's batching interface (``batch``,
    ``batch_sharded``, ``clone``, the ordered splits, ``len``)."""

    def __init__(self, files: List[str], labels: List[int], size: int, seed: int = 42,
                 channels: int = 3, decoder: Optional[str] = None):
        self.files = list(files)
        self.labels = list(labels)
        self.size = size
        self.channels = channels
        self.seed = seed
        self.decoder = decoder or jpeg_decoder()
        self._pipe: Optional[ImagePipeline] = None
        self.shape = (1, channels, size, size)

    def _pipeline(self, batch_size: int, num_shards: int = 1,
                  shard_index: int = 0) -> ImagePipeline:
        p = self._pipe
        if (p is None or p.batch_size != batch_size or p.num_shards != num_shards
                or p.shard_index != shard_index):
            if p is not None:
                p.close()
            self._pipe = ImagePipeline(self.files, self.labels, self.size, batch_size,
                                       num_shards=num_shards, shard_index=shard_index,
                                       seed=self.seed, channels=self.channels,
                                       decoder=self.decoder)
        return self._pipe

    def batch(self, batch_size: int, auto_repeat: bool = True, verbose: bool = False):
        if not auto_repeat:
            # the stream always repeats; looping would double-count an exactly-once sweep
            raise NotImplementedError("ImageDatasetAdapter.batch only supports "
                                      "auto_repeat=True")
        imgs, _ = self._pipeline(batch_size).next_batch()
        return imgs

    def batch_sharded(self, local_batch: int, num_shards: int, shard_index: int):
        """This process's shard of the shared stream."""
        imgs, _ = self._pipeline(local_batch, num_shards, shard_index).next_batch()
        return imgs

    def close(self):
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None

    def __del__(self):  # pragma: no cover
        self.close()

    def clone(self, seed_offset: int = 0) -> "ImageDatasetAdapter":
        return ImageDatasetAdapter(self.files, self.labels, self.size,
                                   self.seed + seed_offset, channels=self.channels,
                                   decoder=self.decoder)

    def split_by_fraction(self, fraction: float):
        return self.split_by_index(int(np.round(fraction * len(self.files)) + 1e-5))

    def split_by_index(self, index: int):
        return tuple(ImageDatasetAdapter(f, lab, self.size, self.seed, channels=self.channels,
                                         decoder=self.decoder)
                     for f, lab in ((self.files[:index], self.labels[:index]),
                                    (self.files[index:], self.labels[index:])))

    def __len__(self):
        return len(self.files)


def imagenet_dataset_factory(cfg, imagenet_dir: str, num_classes: int = 1,
                             decoder: Optional[str] = None):
    """dataset_factory(phase) for the trainer: the train images at the phase's
    resolution, in the config's channel count (1: grayscale)."""
    ds = ImageNetDataset(imagenet_dir, cfg.scratch_path,
                         copy_files=cfg.scratch_path is not None, is_correct_phase=True,
                         num_classes=num_classes)
    files, labels = ds.files_and_labels(train=True)
    decoder = decoder or jpeg_decoder()

    def factory(phase: int) -> ImageDatasetAdapter:
        size = cfg.start_shape_t[-1] * 2 ** (phase - 1)
        return ImageDatasetAdapter(files, labels, size, seed=cfg.seed,
                                   channels=cfg.start_shape_t[0], decoder=decoder)

    return factory
