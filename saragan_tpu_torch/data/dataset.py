"""The npy-pyramid dataset (own copy of ``saragan_tpu/data/dataset.py``).

* one volume per ``{dir}/*.npy`` file, sorted, a channel axis inserted on load;
* an optional copy to a scratch directory (copy to a temporary name, then an atomic
  rename, so concurrent copiers are safe);
* ordered, not shuffled, ``split_by_fraction`` / ``split_by_index`` (neighbouring files
  may come from one patient, so a split keeps them together);
* a sample buffer refilled one shuffled epoch at a time from a deterministic stream:
  epoch e of a dataset with seed s is shuffled by ``random.Random(f"{s}/{e}")``, so the
  same seed gives the same file order as the reference, and ``fast_forward`` can skip
  whole epochs arithmetically when a run resumes mid-phase;
* ``batch_sharded``: a data-parallel rank's share of each global batch, every volume read
  by one rank only;
* a background-thread ``Prefetcher``;
* the port's native C++ reader (``data/native.py``) for a batch of same-shape files, as
  the reference reads them when its library is built: one thread pool decodes every file
  straight into the float32 batch.  A batch it cannot read (shapes differ) falls back to
  one file at a time, each also read natively.
"""

from __future__ import annotations

import glob
import os
import queue
import random
import shutil
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from saragan_tpu_torch.config import parse_tuple
from saragan_tpu_torch.data import native


class NumpyPathDataset:
    def __init__(self, npy_dir: str, scratch_dir: Optional[str] = None,
                 copy_files: bool = False, is_correct_phase: bool = True, seed: int = 42,
                 _files: Optional[List[str]] = None):
        if _files is not None:
            # internal: construction from an explicit file list (splits, clones)
            self.npy_files = list(_files)
            self.scratch_files = list(_files)
            self._seed = seed
            self._init_samplebuffer()
            return

        self.npy_files = sorted(glob.glob(os.path.join(npy_dir, "*.npy")))
        if scratch_dir is not None and scratch_dir.endswith("/"):
            scratch_dir = scratch_dir[:-1]
        self.scratch_dir = (os.path.normpath(scratch_dir + "/" + npy_dir)
                            if (scratch_dir and is_correct_phase) else npy_dir)
        if copy_files and is_correct_phase and scratch_dir is not None:
            os.makedirs(self.scratch_dir, exist_ok=True)
            for f in self.npy_files:
                dst = os.path.join(self.scratch_dir, os.path.basename(f))
                if not os.path.isfile(dst):
                    tmp = f"{dst}.tmp.{os.getpid()}"
                    shutil.copy(f, tmp)
                    os.replace(tmp, dst)

        # wait until some process finished the scratch copy
        while len(glob.glob(os.path.join(self.scratch_dir, "*.npy"))) < len(self.npy_files):
            time.sleep(1)

        self.scratch_files = sorted(glob.glob(os.path.join(self.scratch_dir, "*.npy")))
        assert len(self.scratch_files) == len(self.npy_files)
        self._seed = seed
        self._init_samplebuffer()
        if self.scratch_files:
            test = np.load(self.scratch_files[0])[np.newaxis, ...]
            self.shape = test.shape
            self.dtype = test.dtype

    # -- the deterministic shuffle stream ---------------------------------------------

    def _shuffled_epoch(self) -> List[str]:
        files = self.scratch_files[:]
        random.Random(f"{self._seed}/{self._epoch}").shuffle(files)
        self._epoch += 1
        return files

    def _init_samplebuffer(self):
        self._epoch = 0
        self.samplebuffer: List[str] = self._shuffled_epoch()

    def repeat(self):
        """Extend the buffer with a fresh shuffled epoch."""
        self.samplebuffer.extend(self._shuffled_epoch())

    # -- container protocol ---------------------------------------------------------

    def __iter__(self):
        return iter(self.scratch_files)

    def __getitem__(self, idx):
        return self.scratch_files[idx]

    def __len__(self):
        return len(self.scratch_files)

    # -- splits ---------------------------------------------------------------------

    def clone(self, seed_offset: int = 0) -> "NumpyPathDataset":
        """An independent view of the same files with its own sample buffer (a second
        draw stream that a prefetch thread does not share)."""
        out = NumpyPathDataset("", _files=self.scratch_files, seed=self._seed + seed_offset)
        for attr in ("shape", "dtype"):
            if hasattr(self, attr):
                setattr(out, attr, getattr(self, attr))
        return out

    def split_by_fraction(self, fraction: float) -> Tuple["NumpyPathDataset",
                                                          "NumpyPathDataset"]:
        nsamples_1 = int(np.round(fraction * len(self.scratch_files)) + 1e-5)
        assert nsamples_1 > 0 and len(self.scratch_files) > 0
        return self.split_by_index(nsamples_1)

    def split_by_index(self, index: int) -> Tuple["NumpyPathDataset", "NumpyPathDataset"]:
        d1 = NumpyPathDataset("", seed=self._seed, _files=self.scratch_files[:index])
        d2 = NumpyPathDataset("", seed=self._seed, _files=self.scratch_files[index:])
        for d in (d1, d2):
            if hasattr(self, "shape"):
                d.shape, d.dtype = self.shape, self.dtype
        return d1, d2

    # -- batching -------------------------------------------------------------------

    def _load_batch_from_filelist(self, batch_paths: Sequence[str]) -> np.ndarray:
        n = len(batch_paths)
        if n > 0 and hasattr(self, "shape"):
            out = np.empty((n, *self.shape[1:]), np.float32)
            if native.load_npy_batch(list(batch_paths), out, num_threads=min(8, n)):
                return out[:, np.newaxis, ...]
        batch = [native.load_npy(p).astype("float32") for p in batch_paths]
        if batch:
            batch = np.stack(batch)[:, np.newaxis, ...]
        return batch

    def batch_paths(self, batch_size: int, auto_repeat: bool = True) -> List[str]:
        while batch_size > len(self.samplebuffer):
            if not auto_repeat:
                paths, self.samplebuffer = self.samplebuffer, []
                return paths
            self.repeat()
        paths = self.samplebuffer[:batch_size]
        self.samplebuffer = self.samplebuffer[batch_size:]
        return paths

    def batch(self, batch_size: int, auto_repeat: bool = True) -> np.ndarray:
        """The next `batch_size` volumes of the stream, (N, 1, *spatial) f32."""
        return self._load_batch_from_filelist(self.batch_paths(batch_size, auto_repeat))

    def batch_sharded(self, batch_size: int, num_shards: int, shard_index: int,
                      auto_repeat: bool = True) -> np.ndarray:
        """This shard's `batch_size` volumes of the next global batch (the reference's
        ``batch_mpi`` without the rank-0 scatter): every shard draws the same
        ``batch_size * num_shards`` paths from the shared deterministic stream and loads
        only paths [shard_index::num_shards], so each volume is read exactly once per
        global batch."""
        paths = self.batch_paths(batch_size * num_shards, auto_repeat)
        return self._load_batch_from_filelist(paths[shard_index::num_shards])

    def fast_forward(self, num_paths: int):
        """Advance the stream by `num_paths` draws without loading a file.  Whole epochs
        are skipped by bumping the epoch counter (an epoch's shuffle depends only on it);
        only the last, partial epoch is drawn."""
        if num_paths <= 0:
            return
        if num_paths <= len(self.samplebuffer):
            self.samplebuffer = self.samplebuffer[num_paths:]
            return
        n = len(self.scratch_files)
        assert n > 0, "fast_forward past an empty dataset"
        remaining = num_paths - len(self.samplebuffer)
        self._epoch += (remaining - 1) // n
        rem = (remaining - 1) % n + 1
        self.samplebuffer = self._shuffled_epoch()[rem:]


def get_numpy_dataset(phase: int, starting_phase: int, start_shape, dataset_path: str,
                      scratch_path: Optional[str], verbose: bool = False,
                      copy_files: bool = False, seed: int = 42) -> NumpyPathDataset:
    """The phase's dataset from the directory ``{dataset_path}/{S}x{S}/``, S the phase's
    last spatial size."""
    size = parse_tuple(start_shape)[-1] * (2 ** (phase - 1))
    data_path = os.path.join(dataset_path, f"{size}x{size}/")
    if verbose:
        print(f"Phase {phase}: reading data from dir {data_path}")
    return NumpyPathDataset(data_path, scratch_path, copy_files=copy_files,
                            is_correct_phase=phase >= starting_phase, seed=seed)


class Prefetcher:
    """Batches made by `make_batch` on a background thread, `depth` ahead.  Pull with
    next(); stop() to shut it down.  An exception in the thread surfaces at next()."""

    def __init__(self, make_batch, depth: int = 2):
        self._make_batch = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._make_batch()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on next()
            self._exc = e

    def __next__(self):
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    if self._exc is not None:
                        raise self._exc
                    raise StopIteration

    def stop(self):
        self._stop.set()
        try:  # drain so the worker can leave a blocked put
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
