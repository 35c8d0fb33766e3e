"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file ``configs`` gives,
and a traffic mix, ``portbench/traffic/<traffic>.json``, whose ``kind`` names the driver
``portbench/drivers/<kind>.py``.  A per-layer metric is read by
``portbench/metrics/<name>.py``; the numbers that decide ``correct`` are held to
``portbench/limits/<cell>.json``.  Adding a cell, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic, metrics and
    limits resolved."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.root = root
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (root / "portbench" / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.kind = self.traffic["kind"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._applies(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]
        limits = root / "portbench" / "limits" / f"{name}.json"
        self.limits: Optional[Dict[str, float]] = (json.loads(limits.read_text())["limits"]
                                                   if limits.exists() else None)

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def driver(kind: str):
    """The module ``portbench.drivers.<kind>``."""
    if not NAME.match(kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(record)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def check_names(bench: dict) -> List[str]:
    """The names and units that break the benchmark's character rules."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            for key in ("name", "config", "traffic"):
                if key in entry and not NAME.match(str(entry[key])):
                    bad.append(f"{group}: {key} {entry[key]!r}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                bad.append(f"{group}: unit {entry['unit']!r}")
            for key in entry.get("reduced", []):
                if not NAME.match(key):
                    bad.append(f"{group}: reduced {key!r}")
    return bad
