"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's file is the `configs` entry's `file`, the mix is
`portbench/traffic/<traffic>.json`, and each per-layer metric is read by
`portbench/metrics/<name>.py` (its `read(record)`). Adding a cell, a mix, a
configuration or a metric is adding files and entries: nothing here names
one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # the cell's end-to-end metric entries
    per_layer: list           # the cell's per-layer metric entries


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str) -> Cell:
    """The cell `name` of the benchmark at `root`, with its configuration
    and traffic read. Raises KeyError for an unknown cell."""
    root = Path(root)
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{entry['traffic']}.json").read_text())
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def reader(root: Path, metric: str):
    """The `read(record)` function of a per-layer metric's reader."""
    path = Path(root) / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
