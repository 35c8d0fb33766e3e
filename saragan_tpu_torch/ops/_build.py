"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own by nvcc
into ``build/lib<name>_<digest>.so`` (nvcc's output beside it, ``.log``), where the digest
covers the source, the shared headers (``csrc/*.cuh``) and the flags, so a changed source
never loads a stale library.  The host library (``csrc/host/*.cc``: the npy reader, the
prefetch executor and the JPEG decoder) is compiled by g++ the same way into
``build/libsaragan_io_<digest>.so``, with ``-DSARAGAN_HAVE_JPEG -ljpeg`` where
``jpeglib.h`` exists.  A build happens at first use, never at import time, and a failed
one raises with the compiler's log.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, the default toolkit location, or $PATH; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all() -> Dict[str, dict]:
    """Compile every source that has no library yet, one nvcc per source, all started
    together.  Returns {name: {"seconds": s, "log": nvcc output}}; raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {name: _start(name) for name in sources() if not library_path(name).exists()}
    report = {}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``) from the build of ``csrc/<name>.cu``, kept beside its
    library."""
    return library_path(name).with_suffix(".log").read_text()


def ptxas_report(log: str) -> list:
    """Per kernel entry of an nvcc log built with ``-Xptxas -v``: {"function" (mangled),
    "registers", "spill_stores", "spill_loads"} (bytes of spills)."""
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = dict(function=m.group(1), registers=None, spill_stores=None,
                           spill_loads=None)
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return rows


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    if not library_path(name).exists():
        build_all()
    return ctypes.CDLL(str(library_path(name)))


HOST_DIR = CSRC_DIR / "host"
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
JPEG_HEADER = Path("/usr/include/jpeglib.h")


def host_sources() -> list:
    return sorted(HOST_DIR.glob("*.cc"))


def host_flags() -> tuple:
    """(compile flags, link flags): libjpeg's where its header exists, as the JAX
    package's ``runtime/Makefile`` probes."""
    if JPEG_HEADER.is_file():
        return HOST_FLAGS + ("-DSARAGAN_HAVE_JPEG",), ("-ljpeg",)
    return HOST_FLAGS, ()


def host_library_path() -> Path:
    h = hashlib.sha256()
    for src in host_sources():
        h.update(src.read_bytes())
    h.update(" ".join(sum(host_flags(), ())).encode())
    return BUILD_DIR / f"libsaragan_io_{h.hexdigest()[:16]}.so"


def build_host(out: Path = None, srcs=None) -> Path:
    """Compile the host sources with g++ into `out` (default ``host_library_path()``);
    raises with the compiler's output on a failure."""
    out = Path(out or host_library_path())
    srcs = [str(p) for p in (srcs or host_sources())]
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library needs a C++17 compiler "
                           "(set CXX or put g++ on PATH)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cflags, libs = host_flags()
    proc = subprocess.run([cxx, *cflags, "-o", str(tmp), *srcs, *libs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed ({cxx} exited {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_host_library() -> ctypes.CDLL:
    """The ctypes handle of the host library, built first if needed."""
    path = host_library_path()
    if not path.exists():
        build_host(path)
    return ctypes.CDLL(str(path))
