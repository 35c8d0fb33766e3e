"""``saragan_tpu_torch.scripts.seed_band`` end to end on the CPU: one seed of the flagship
recipe at phases 1 -> 2 (``--smoke --device cpu``) in a subprocess, and the band file in
the JAX driver's layout (``kind``, ``seeds``, ``runs``, ``band``)."""

import json
import math

import torch

torch.set_num_threads(1)


def test_seed_band_smoke(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the subprocesses' torch threads
    from saragan_tpu_torch.scripts import seed_band as m

    assert m.main(["flagship", str(tmp_path), "3", "--smoke", "--device", "cpu"]) == 0
    assert "BAND" in capsys.readouterr().out
    doc = json.loads((tmp_path / "band_flagship.json").read_text())
    assert set(doc) == {"kind", "seeds", "runs", "band"}
    assert doc["kind"] == "flagship" and doc["seeds"] == [3]
    (run,) = doc["runs"]
    assert set(run) == {"seed", "rc", "wall_s", "first", "last", "tail"}
    assert run["rc"] == 0 and "FLAGSHIP SMOKE OK" in run["tail"]
    assert sorted(run["first"]) == sorted(run["last"]) == ["1", "2"]
    assert sorted(doc["band"]) == ["1", "2"]
    for ph, b in doc["band"].items():
        rel = (run["last"][ph] - run["first"][ph]) / abs(run["first"][ph])
        assert b["rel_changes"] == [round(rel, 4)] and b["worst"] == b["best"]
        assert math.isfinite(rel)
    traj = json.loads((tmp_path / "flagship_seed3" / "trajectory_p1-2.json").read_text())
    assert traj["seed"] == 3
