"""A later change adds a configuration, a cell and a per-layer metric by adding files and
entries: in a temporary copy of the benchmark, one new configuration file, one new cell
and one new metric reader run through the harness, and no file that was there changes."""

from __future__ import annotations

import hashlib
import json

from portbench import spec
from portbench.run import run_cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_add_a_config_a_cell_and_a_metric(tiny_root):
    before = _digests(tiny_root)
    bench_path = tiny_root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    conf = json.loads((tiny_root / "portbench" / "configs" / "tiny_pgan_xs.json").read_text())
    conf["name"] = "tiny_pgan_wide"
    conf["config"]["filter_spec"] = [[24, 24], [24, 24], [12, 12]]
    (tiny_root / "portbench" / "configs" / "tiny_pgan_wide.json").write_text(json.dumps(conf))
    (tiny_root / "portbench" / "metrics" / "device_ops.train.py").write_text(
        '"""Device operations a profiled step."""\n\n\n'
        "def read(rec):\n"
        "    if rec.get('kind') != 'train_step' or not rec.get('steps'):\n"
        "        return None\n"
        "    return rec['launches'] / rec['steps'] + 1.0\n")
    (tiny_root / "portbench" / "limits" / "tiny-wide-train.json").write_text(json.dumps(
        {"limits": {"grad_diff": 1e-4, "change_gap": 1e-4, "ema_gap": 1e-4}}))
    bench["configs"].append(dict(name="tiny_pgan_wide", source="https://github.com/sara-nl/saraGAN",
                                 file="portbench/configs/tiny_pgan_wide.json", reduced=[],
                                 why="test"))
    bench["workloads"].append(dict(name="tiny-wide-train", config="tiny_pgan_wide",
                                   traffic="tiny_train", chips=1, why="test"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny-pgan-train" in m["workloads"]:
            m["workloads"].append("tiny-wide-train")
    for m in bench["per_layer"]:
        if "workloads" in m and "tiny-pgan-train" in m["workloads"]:
            m["workloads"].append("tiny-wide-train")
    bench["per_layer"].append(dict(name="device_ops.train", unit="ops", better="lower",
                                   source="device_trace", layer="device",
                                   moves="train_vol_s", workloads=["tiny-wide-train"]))
    bench_path.write_text(json.dumps(bench))

    cell = spec.Cell(spec.load_benchmark(tiny_root), "tiny-wide-train", tiny_root)
    res = run_cell(cell, 2 ** 31 + 21, 0.5, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["device_ops.train"]["value"] >= 1.0
    plain = run_cell(cell, 2 ** 31 + 21, 0.5, False, device="cpu")
    assert set(plain["metrics"]) == {"train_vol_s", "train_peak_gib", "setup_s"}

    after = _digests(tiny_root)
    changed = [p for p, d in before.items() if after.get(p) != d]
    assert changed == [bench_path.relative_to(tiny_root)]
