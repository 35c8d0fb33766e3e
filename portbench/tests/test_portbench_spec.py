"""``BENCHMARK.json`` against the benchmark's contract, and every file it names found by
name: each cell's configuration, traffic and driver, each per-layer metric's reader, each
cell's limits."""

from __future__ import annotations

import json
import math

from portbench import spec

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


def test_top_level_and_entry_keys():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"] and (REPO / "portbench").is_dir()
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert spec.check_names(BENCH) == []
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[g]]
    assert len(names) == len(set(names))


def test_every_cell_resolves_its_files():
    drivers = {"train_step"}
    for w in BENCH["workloads"]:
        cell = spec.Cell(BENCH, w["name"], REPO)
        assert cell.kind in drivers and spec.driver(cell.kind).run
        assert cell.limits and all(math.isfinite(v) and v > 0 for v in cell.limits.values())
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"], REPO))
            assert m["moves"] in e2e


def test_names_and_units_use_the_allowed_characters():
    assert spec.NAME.match("mfu.train") and not spec.NAME.match("bad name")
    assert not spec.NAME.match("a/b") and spec.UNIT.match("volumes/s")
    assert not spec.UNIT.match("tokens per second")


def test_readers_find_nothing_in_an_empty_record():
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"], REPO)({}) is None
