"""``BENCHMARK.json`` and the files each of its names leads to.

A cell ``<name>`` has ``workloads/<name>.json`` (its runner, traffic kind
and parameters) and ``limits/<name>.json`` (what its check samples and the
limit of each number compared); a configuration ``<config>`` has
``configs/<config>.json``; a per-layer metric ``<metric>`` has
``metrics/<metric>.py``, whose ``read(run)`` returns the metric or None.
Adding a cell, a configuration or a metric adds files and entries and edits
none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    entry: dict        # its line in BENCHMARK.json's "workloads"
    workload: dict     # workloads/<name>.json
    limits: dict       # limits/<name>.json
    config: dict       # configs/<config>.json
    end_to_end: list   # the end-to-end metrics it reports
    per_layer: list    # the per-layer metrics it reports

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def _reports(metric, cell, e2e_names):
    """Whether ``cell`` reports ``metric``: the cells it lists, or, without
    a list, every cell (an end-to-end metric) or every cell that reports the
    end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name, root=ROOT, bench=None) -> Cell:
    """Everything a run of cell ``name`` needs, found by name."""
    bench = bench or benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name, entry,
                load_json(HERE / "workloads" / f"{name}.json"),
                load_json(HERE / "limits" / f"{name}.json"),
                load_json(ROOT / configs[entry["config"]]["file"]),
                e2e, per_layer)


def metric_reader(name):
    """``read`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
