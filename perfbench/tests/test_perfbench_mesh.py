"""The band mesh's path of the harness, in a world of four CPU processes over
gloo (halos staged through the host): a sound run is correct, the control is
not, and a run whose halo exchanges are left out is not."""

from __future__ import annotations

import json

import pytest

from conftest import plant
from harness import result

CELL = "sph16m_bands4"


@pytest.fixture
def mesh_mini(mini):
    """The miniature, with the band cell's entry and limits added where the
    benchmark does not list it (the path is kept for it)."""
    b = json.loads((mini / "BENCHMARK.json").read_text())
    if CELL not in [w["name"] for w in b["workloads"]]:
        b["workloads"].append({"name": CELL, "config": "sph_16m_bands4",
                               "traffic": "headless_bands", "chips": 4, "why": "test"})
        for m in b["per_layer"]:
            if m["name"] != "render_roofline":
                m["workloads"].append(CELL)
        b["per_layer"].append({"name": "halo_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "mesh", "moves": "frame_ms",
                               "workloads": [CELL]})
        (mini / "BENCHMARK.json").write_text(json.dumps(b))
    limits = mini / "perfbench" / "limits" / f"{CELL}.json"
    if not limits.exists():
        limits.write_text((mini / "perfbench" / "limits" / "sph16m_headless.json").read_text())
    return mini


def test_sound_and_control(mesh_mini):
    line = result.measure(CELL, 2**31 + 3, 0.05, False, "cpu", mesh_mini, backend="gloo",
                          control=True)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4 and line["attempted"] > 0 and line["failed"] == 0
    assert not line["control_correct"], line["control_checks"]


def test_traced(mesh_mini):
    line = result.measure(CELL, 4, 0.05, True, "cpu", mesh_mini, backend="gloo")
    assert line["correct"] and "host_enqueue_ms" in line["metrics"]
    assert "halo_ms" not in line["metrics"]  # no device rows on the CPU: no reading, not 0


def test_exchange_left_out_is_caught(mesh_mini):
    plant(mesh_mini, CELL, "exchange")
    line = result.measure(CELL, 6, 0.05, False, "cpu", mesh_mini, backend="gloo")
    assert not line["correct"], line["checks"]
