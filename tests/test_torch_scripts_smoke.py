"""The convergence drivers of ``saragan_tpu_torch.scripts`` end to end on the CPU
(``--smoke --device cpu``, phases 1 -> 2, toy budgets): the flagship schedule and a leg
chained from its ``model_1``, the cubic schedule and the 2-D path.  Each writes its
trajectory under the JAX drivers' keys (``phase``, ``step``, ``suffix``, ``time``, the
metrics), the per-pass host readings, the per-phase table and the gate's verdict."""

import json
import math

import numpy as np
import torch

torch.set_num_threads(1)

ENTRY_KEYS = {"phase", "step", "suffix", "time", "FID", "mse"}


def check_doc(path, phases, entry_keys=ENTRY_KEYS):
    doc = json.loads(path.read_text())
    assert {"trajectory", "wall_s", "passes", "gate", "phases"} <= set(doc)
    t = doc["trajectory"]
    assert {e["phase"] for e in t} == set(phases)
    for e in t:
        assert set(e) == entry_keys, e
        assert math.isfinite(e["FID"])
    assert {e["suffix"] for e in t} == {"", "_EMA", "_test", "_validation"}
    assert len(doc["passes"]) == len(t)
    assert all(p["rss_mib"] > 0 and p["cuda_peak_mib"] is None for p in doc["passes"])
    assert sorted(doc["phases"]) == [str(p) for p in phases]
    return doc


def test_flagship_smoke(tmp_path, capsys):
    from saragan_tpu_torch.scripts import convergence_run_flagship as m

    assert m.main([str(tmp_path), "2", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FLAGSHIP SMOKE OK" in out and "HOST phase 2" in out
    doc = check_doc(tmp_path / "trajectory_p1-2.json", [1, 2])
    assert doc["gate"]["gate"] == "band" and doc["seed"] == 42
    # the volumes on disk are the anisotropic field's, phase 2 at (2, 8, 8)
    assert np.load(tmp_path / "data" / "8x8" / "v0000.npy").shape == (2, 8, 8)
    # a leg from phase 2 chains from the run's model_1 and keeps its own trajectory file
    assert m.main([str(tmp_path), "2", "2", "--smoke", "--device", "cpu", "--seed", "1"]) == 0
    doc = check_doc(tmp_path / "trajectory_p2-2.json", [2])
    assert doc["seed"] == 1


def test_cubic_smoke(tmp_path, capsys):
    from saragan_tpu_torch.scripts import convergence_run as m

    assert m.main([str(tmp_path), "2", "--smoke", "--device", "cpu"]) == 0
    assert "CONVERGENCE SMOKE OK (pgan" in capsys.readouterr().out
    doc = check_doc(tmp_path / "trajectory.json", [1, 2])
    assert doc["gate"]["gate"] == "band" and doc["arch"] == "pgan"


def test_2d_smoke(tmp_path, capsys):
    from saragan_tpu_torch.scripts import convergence_run_2d as m

    assert m.main([str(tmp_path), "2", "--smoke", "--device", "cpu"]) == 0
    assert "CONVERGENCE 2D SMOKE OK" in capsys.readouterr().out
    doc = check_doc(tmp_path / "trajectory_2d.json", [1, 2],
                    {"phase", "step", "suffix", "time", "FID", "MSE"})
    assert doc["gate"]["gate"] == "caps_2d"
