"""A later change adds a configuration (here with another layout: 64 slots a
cell, pair-packed walks), an initial state, a traffic mix, a limit set and a
per-layer metric as new files and new entries; the harness finds them by
name, passes the layout to the port and to the reference, and no file that
was there changes."""

from __future__ import annotations

import hashlib
import json

from harness import result


POOL = """import torch


def particles(cfg, seed, device):
    x_min, x_max, y_min, y_max = (float(b) for b in cfg["bounds"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = int(cfg["n"])
    u = torch.rand((n, 2), generator=gen, device=device)
    pos = torch.stack([x_min + u[:, 0] * (x_max - x_min),
                       y_min + u[:, 1] * 0.5 * (y_max - y_min)], dim=1)
    return pos, 20.0 * torch.randn((n, 2), generator=gen, device=device)
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(mini):
    before = _digests(mini)
    pb = mini / "perfbench"
    cfg = json.loads((pb / "configs" / "sph_16m.json").read_text())
    cfg.update(n=2000, capacity=64, pack2=True, init="pool")  # a deployment of its own
    (pb / "configs" / "sph_small.json").write_text(json.dumps(cfg))
    (pb / "inits" / "pool.py").write_text(POOL)
    mix = json.loads((pb / "traffic" / "headless.json").read_text())
    mix["cycle_frames"] = 4  # restart the scene more often
    (pb / "traffic" / "short_cycles.json").write_text(json.dumps(mix))
    (pb / "limits" / "small_short.json").write_text(
        (pb / "limits" / "sph16m_headless.json").read_text())
    (pb / "metrics" / "frames_traced.py").write_text(
        "def read(ranks):\n    return float(ranks[0].frames)\n")
    b = json.loads((mini / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "sph_small", "source": "test", "why": "test", "reduced": [],
                         "file": "perfbench/configs/sph_small.json"})
    b["workloads"].append({"name": "small_short", "config": "sph_small",
                           "traffic": "short_cycles", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "driver",
                           "moves": "frame_ms", "workloads": ["small_short"]})
    (mini / "BENCHMARK.json").write_text(json.dumps(b))

    line = result.measure("small_short", 5, 0.05, True, "cpu", mini)
    assert line["correct"] and line["attempted"] == 4, line["checks"]
    assert line["checks"]["init_mismatch"] == [0, 0]
    assert line["metrics"]["frames_traced"]["value"] == 4.0
    line = result.measure("small_short", 5, 0.05, False, "cpu", mini)
    assert line["correct"] and line["attempted"] % 4 == 0
    after = _digests(mini)
    assert {k: v for k, v in after.items() if k in before} == before
