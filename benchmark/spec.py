"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root names the cells; a cell names its configuration
(`benchmark/configs/<config>.json`) and its traffic
(`benchmark/traffic/<traffic>.json`, whose `kind` names the code that
drives it, `benchmark/kinds/<kind>.py`); each per-layer metric is read by
`benchmark/layer_metrics/<metric>.py`. A cell, a configuration, a traffic
mix or a metric is added by adding files and entries, never by editing a
file that is there."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with `workloads` belongs to the cells it lists; one without
    to every cell (end-to-end), or to every cell that reports the
    end-to-end metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: Path = ROOT) -> Cell:
    """Cell `name` of `root`/BENCHMARK.json, with its configuration,
    traffic and metrics."""
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    w = entries[name]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    config = json.loads((root / config_file).read_text())
    traffic = json.loads((root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic, e2e, per_layer)


def kind(traffic: dict):
    """The module that drives a traffic file's kind."""
    return importlib.import_module(f"{__package__}.kinds.{traffic['kind']}")


def layer_metric(name: str, root: Path = ROOT):
    """The reader of per-layer metric `name`: `read(reading)` returns its
    value, or None where the run has nothing to read."""
    path = root / HERE.name / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.layer_metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
