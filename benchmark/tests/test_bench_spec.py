"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit and metric parses and is found by name, within the
contract's limits; and a cell, a configuration, a traffic mix and a
per-layer metric added as files and entries only are found."""

import json
import re
import shutil
from pathlib import Path

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert len(b["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in b["command"])


def test_names_units_and_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for x in b["configs"]] + [x["name"] for x in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_resolves():
    b = bench()
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert spec.kind(cell.traffic).run
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer, w["name"]
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
        for m in cell.per_layer:
            assert callable(spec.layer_metric(m["name"]).read)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_a_cell_added_as_files_only_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    config = json.loads((ROOT / b["configs"][0]["file"]).read_text())
    config.update(name="new_config", batch_size=8)
    (root / "benchmark" / "configs" / "new_config.json").write_text(json.dumps(config))
    (root / "benchmark" / "traffic" / "new_mix.json").write_text(
        json.dumps({"kind": "train", "sequence_frames": 502, "shift_px": 3, "trace_calls": 2}))
    (root / "benchmark" / "layer_metrics" / "new_metric.py").write_text(
        "def read(r):\n    return r.steps * 2 if r.steps else None\n")
    b["configs"].append({"name": "new_config", "source": "https://arxiv.org/abs/1806.01260",
                         "file": "benchmark/configs/new_config.json", "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "new_cell", "config": "new_config", "traffic": "new_mix", "chips": 1,
                           "why": "a test"})
    b["end_to_end"][0].setdefault("workloads", []).append("new_cell")
    b["per_layer"].append({"name": "new_metric", "unit": "x", "better": "higher", "source": "host_clock",
                           "layer": "trainer input", "moves": b["end_to_end"][0]["name"], "workloads": ["new_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.cell("new_cell", root=root)
    assert cell.config["batch_size"] == 8 and cell.traffic["sequence_frames"] == 502
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    from benchmark.result import Reading

    assert spec.layer_metric("new_metric", root=root).read(Reading({}, steps=3)) == 6
    assert spec.layer_metric("new_metric", root=root).read(Reading({})) is None
