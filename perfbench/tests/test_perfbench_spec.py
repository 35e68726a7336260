"""Every entry of BENCHMARK.json resolves to its files, and the file keeps to
the shape the benchmark's contract sets."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import spec

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["perfbench"] and B["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.cell(cell, ROOT)
    assert c["chips"] in (1, 4)
    cfg = c["config"]
    model = spec.model(cfg["model"])
    assert model.Program and model.Judge
    assert callable(spec.init(cfg["init"]).particles)
    entry = spec.entry(cfg["model"], c["traffic"]["entry"])
    assert callable(entry.build)
    assert {"pos_err", "vel_err"} <= set(c["limits"])
    if entry.IMAGE:
        assert "image_err" in c["limits"] and "render" in cfg
    names = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert callable(spec.metric(m["name"]).read)
        assert m["moves"] in names


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    for c in B["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert cfg["guarantees"] == {"lost": 0, "live": "n", "finite": True}


def test_names_units_and_bounds():
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(B["workloads"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in B[group]]
        assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in B["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in B["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and set(m["workloads"]) <= set(CELLS)
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for text in [w["why"] for w in B["workloads"]] + [c["why"] for c in B["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
