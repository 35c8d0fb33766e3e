"""Fixtures of the benchmark's tests: a temporary benchmark root with tiny cells.

    python -m pytest portbench/tests -q

The tests run on the CPU at tiny sizes; a test that needs the card is marked ``cuda`` and
skips inside itself when there is none.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CELLS = (("tiny-pgan-train", "tiny_pgan_xs", "tiny_train"),
              ("tiny-surfgan-train", "tiny_surfgan", "tiny_train"))
# the tiny cells run in float32, where the program and the reference agree to about 1e-6
# (test_portbench_reference.py) and the faults read 1e-2 or more; step 2's gradient is
# taken at each side's own state after step 1, where Adam has turned round-off in the
# smallest gradient entries into steps of lr: it reads up to about 4e-4
TRAIN_LIMITS = {"grad_diff": 1e-4, "mix_grad_diff": 3e-3, "change_gap": 1e-4,
                "ema_gap": 1e-4, "mix_change_gap": 1e-4, "mix_ema_gap": 1e-4,
                "change_worst": 1e-4}
TINY_LIMITS = {"tiny-pgan-train": TRAIN_LIMITS, "tiny-surfgan-train": TRAIN_LIMITS}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


def tiny_config(name: str) -> dict:
    """The configuration file `name` shrunk to a (1, 1, 2, 2) start and latent 32 in
    float32, with its kernel and filter specs resolved by the port's own rules."""
    from saragan_tpu_torch.config import Config

    c = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    f = c["config"]
    f.update(start_shape="(1, 1, 2, 2)", final_shape="(1, 8, 16, 16)", latent_dim=32,
             compute_dtype="float32")
    f.pop("kernel_spec")
    f.pop("filter_spec")
    cfg = Config(**f).finalize()
    f["kernel_spec"] = cfg.resolved_kernel_spec()
    f["filter_spec"] = cfg.resolved_filter_spec()
    if f["architecture"] == "pgan":  # pgan reads its filters from the spec: keep it small
        f["filter_spec"] = [[16, 16], [16, 16], [8, 8]]
    return c


def make_tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark's files with two tiny cells (and their limits) added."""
    root = Path(tmp)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("pgan_xs", "surfgan"):
        (root / "portbench" / "configs" / f"tiny_{name}.json").write_text(
            json.dumps(tiny_config(name)))
    (root / "portbench" / "traffic" / "tiny_train.json").write_text(json.dumps(dict(
        kind="train_step", phase=3, batch=4, alpha_start=0.75, inputs=4, profile_steps=1,
        host_steps=1)))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] += [dict(name=f"tiny_{n}", source="https://github.com/sara-nl/saraGAN",
                              file=f"portbench/configs/tiny_{n}.json", reduced=[], why="test")
                         for n in ("pgan_xs", "surfgan")]
    bench["workloads"] += [dict(name=n, config=c, traffic=t, chips=1, why="test")
                           for n, c, t in TINY_CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [n for n, _, _ in TINY_CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, limits in TINY_LIMITS.items():
        (root / "portbench" / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": limits}))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
