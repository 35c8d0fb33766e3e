"""No module of a run may have the top-level name ``jax``, ``jaxlib``, ``flax`` or
``saragan_tpu`` (compared whole: ``saragan_tpu_torch`` is the port), and the reference
imports nothing of the port.  Both checked in fresh processes: a CPU dry run of every
tiny cell, and an import of the reference and the counter alone."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.run import forbidden_modules

from conftest import REPO

ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
ENV["PYTHONPATH"] = str(REPO)


def test_the_comparison_is_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "saragan_tpu_torch_fake_test_module", sys)
    assert "saragan_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "saragan_tpu.fake_test_module", sys)
    assert "saragan_tpu" in forbidden_modules()


def test_a_cpu_dry_run_loads_no_jax(tiny_root):
    script = f"""
import json, pathlib
from portbench import spec
from portbench.run import run_cell, forbidden_modules
root = pathlib.Path({str(tiny_root)!r})
bench = spec.load_benchmark(root)
for name in ("tiny-pgan-train", "tiny-surfgan-train"):
    res = run_cell(spec.Cell(bench, name, root), 2**31 + 11, 0.5, True, device="cpu")
    assert res["attempted"] > 0
print(json.dumps(forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_port():
    script = ("import sys, json; import portbench.reference.train, portbench.counts, "
              "portbench.compare; print(json.dumps(sorted({m.split('.')[0] for m in "
              "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"saragan_tpu_torch", "saragan_tpu", "jax", "jaxlib", "flax"}
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        assert "saragan_tpu" not in path.read_text(), path
