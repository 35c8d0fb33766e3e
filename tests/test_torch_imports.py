"""The PyTorch port stands alone: it imports with JAX, optax, ml_dtypes and the JAX
package blocked, never names the JAX package in an import, and its entry points refuse to fall
back to the CPU when no GPU is present."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "saragan_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "optax", "ml_dtypes", "saragan_tpu"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import saragan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(saragan_tpu_torch.__path__, "saragan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""

# the trainer slice's, the metrics slice's, the model families', the HPO slice's, the
# input layer's, the data-parallel slice's and the op formulations' modules, which the
# hook must reach
REQUIRED = {"saragan_tpu_torch.cli", "saragan_tpu_torch.__main__",
            "saragan_tpu_torch.optim.factory", "saragan_tpu_torch.hpo",
            *(f"saragan_tpu_torch.hpo.{m}" for m in ("engine", "harness", "suggestions")),
            "saragan_tpu_torch.train.trainer", "saragan_tpu_torch.data.dataset",
            "saragan_tpu_torch.optim.schedules", "saragan_tpu_torch.optim.freeze",
            "saragan_tpu_torch.ops.minibatch_stddev", "saragan_tpu_torch.tools.profile_mbstd",
            *(f"saragan_tpu_torch.metrics.{m}"
              for m in ("fid", "inception", "kms", "save_metrics", "skim", "swd")),
            *(f"saragan_tpu_torch.models.{m}"
              for m in ("pgan2", "pgandeep", "style_ops", "stylegan", "stylegan2", "surfgan")),
            "saragan_tpu_torch.data.native", "saragan_tpu_torch.data.imagenet",
            "saragan_tpu_torch.ops._build", "saragan_tpu_torch.parallel",
            *(f"saragan_tpu_torch.parallel.{m}" for m in ("mesh", "multihost", "halo")),
            "saragan_tpu_torch.tools.profile_parallel", "saragan_tpu_torch.utils",
            "saragan_tpu_torch.ops.conv3d_gemm", "saragan_tpu_torch.ops.conv3d_s2d"}


def test_port_imports_with_jax_and_reference_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20  # every module of the port was imported
    assert REQUIRED <= names, REQUIRED - names


_ENGINE_IMPORT = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"torch", "jax", "jaxlib", "optax", "saragan_tpu"}:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import importlib.util
spec = importlib.util.spec_from_file_location("engine", "saragan_tpu_torch/hpo/engine.py")
engine = sys.modules["engine"] = importlib.util.module_from_spec(spec)
spec.loader.exec_module(engine)
study = engine.create_study(sampler=engine.samplers.TPESampler(seed=0))
study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=12)
assert not [m for m in sys.modules if m.split(".")[0] in {"torch", "jax", "saragan_tpu"}]
print(len(study.trials))
"""


def test_hpo_engine_needs_neither_torch_nor_the_jax_package():
    """The engine is numpy and sqlite3 only: it imports and runs a study with torch, JAX
    and the JAX package blocked (loaded from its file, outside the package, whose
    ``__init__`` imports torch)."""
    out = subprocess.run([sys.executable, "-c", _ENGINE_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["12"]


_REF_IMPORT = re.compile(
    r"^\s*(from\s+saragan_tpu(\.|\s)|import\s+saragan_tpu(\.|\s|,|$))"
    r"|import_module\(\s*['\"]saragan_tpu(\.|['\"])"
    r"|^\s*(from|import)\s+(jax|jaxlib|optax)\b",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import_in_source(path):
    src = path.read_text()
    assert not _REF_IMPORT.search(src), f"{path} imports JAX or the JAX package"


def test_sampler_without_device_raises_on_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from saragan_tpu_torch import resolve_device
    from saragan_tpu_torch.config import Config
    from saragan_tpu_torch.tools.generate import make_keyed_sampler

    cfg = Config(start_shape="(1, 4, 4, 4)", final_shape="(1, 8, 8, 8)",
                 latent_dim=8, filter_spec=[[8, 8]]).finalize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_keyed_sampler(cfg, 1, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
