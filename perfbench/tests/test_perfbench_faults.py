"""`correct` comes out false when the timed path is broken underneath (a
frame entry replaced, in a miniature, by one that breaks its frames), once
for each fault a cell can have, and for the control (the reference with its
pair terms in bfloat16 in the program's place); a sound run is correct.  The
runs skip the look for a card and drive the rest of a run on the CPU, at the
miniature's size, under the cells' own limits."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT, plant
from harness import result

B = json.loads((ROOT / "BENCHMARK.json").read_text())
ONE = [w["name"] for w in B["workloads"] if w["chips"] == 1]


@pytest.mark.parametrize("cell", ONE)
def test_sound_run_is_correct(mini, cell):
    line = result.measure(cell, 2**31 + 5, 0.05, False, "cpu", mini)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ONE)
def test_fault_is_caught(mini, cell, fault):
    plant(mini, cell, fault)
    line = result.measure(cell, 9, 0.05, False, "cpu", mini)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("cell", ONE)
def test_control_is_not_correct(mini, cell):
    line = result.measure(cell, 13, 0.05, False, "cpu", mini, control=True)
    assert line["correct"] and not line["control_correct"], line["control_checks"]
