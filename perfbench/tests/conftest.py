"""The harness's tests run on the CPU, through the port's plain versions, at a
few thousand particles: the same files and code paths as a run on the card,
with every size cut down.  Tests that need a card are marked ``card`` and
skip here."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The miniature: 192 x 108 units (22 x 13 cells of 9), ~10 particles a cell,
# a 192 x 108 image at one unit a pixel, cycles of 6 frames.
MINI_BOUNDS = [-96.0, 96.0, -54.0, 54.0]
MINI_N = 3000


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


def miniature(dest: Path) -> Path:
    """A checkout-shaped copy of the benchmark with every size cut down:
    ``dest/BENCHMARK.json`` and ``dest/perfbench/{configs,traffic,limits,
    metrics,models,entries,inits}``; the limits are the real ones."""
    pb = dest / "perfbench"
    for d in ("traffic", "limits", "metrics", "configs", "models", "entries", "inits"):
        shutil.copytree(BENCH / d, pb / d, ignore=shutil.ignore_patterns("__pycache__"))
    for f in (pb / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["n"], c["bounds"] = MINI_N, MINI_BOUNDS
        if "render" in c:
            c["render"] = dict(c["render"], width=192, height=108)
        f.write_text(json.dumps(c))
    for f in (pb / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(cycle_frames=6, warmup_frames=1, calibrate_frames=2, enqueue_frames=2,
                 work_samples=2)
        f.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


@pytest.fixture
def mini(tmp_path) -> Path:
    return miniature(tmp_path)


# Faults planted under the timed path: each replaces a frame entry's file in a
# miniature with one that wraps the real entry and breaks its frames.
FAULTS = {
    "unchanged": """
def planted(real, program):
    def frame(ps):  # the step returns its state as it was
        new, aux = real(ps)
        return dataclasses.replace(ps, frame=new.frame), aux
    return frame
""",
    "half": """
def planted(real, program):
    def frame(ps):  # half of the particles left out of the frame
        new, aux = real(ps)
        half = ps.px.shape[0] // 2
        keep = lambda a, b: torch.cat([a[:half], b[half:]])
        return dataclasses.replace(new, **{f: keep(getattr(ps, f), getattr(new, f))
                                           for f in ("px", "py", "vx", "vy", "idsf")}), aux
    return frame
""",
    "altered": """
def planted(real, program):
    def frame(ps):  # one particle's answer changed where it is made
        new, aux = real(ps)
        vx = new.vx.clone().reshape(-1)
        vx[int(torch.nonzero(new.px.reshape(-1) < 5e5)[0])] += 1.0
        return dataclasses.replace(new, vx=vx.reshape(new.vx.shape)), aux
    return frame
""",
    "exchange": """
def planted(real, program):
    from rust_particle_system_tpu_torch.parallel import plane_sharded

    def rebin_halo(chans, fills, mesh):  # ghost rows hold the fills
        fill = lambda cs: torch.stack([torch.full_like(p[0], f) for p, f in zip(cs, fills)])
        return fill(chans[:2]), fill(chans), fill(chans)

    def halo_rows(planes, fills, mesh):
        return [torch.cat([torch.full_like(p[:1], f), p, torch.full_like(p[:1], f)])
                for p, f in zip(planes, fills)]

    def frame(ps):  # the exchange between bands left out
        saved = plane_sharded.rebin_halo, plane_sharded.halo_rows
        plane_sharded.rebin_halo, plane_sharded.halo_rows = rebin_halo, halo_rows
        try:
            return real(ps)
        finally:
            plane_sharded.rebin_halo, plane_sharded.halo_rows = saved
    return frame
""",
}

PLANTED = """import dataclasses
from pathlib import Path

import torch

from harness import spec

_REAL = spec.entry({model!r}, {entry!r}, Path({bench!r}))
IMAGE = _REAL.IMAGE
{code}

def build(program):
    return planted(_REAL.build(program), program)
"""


def plant(root: Path, workload: str, fault: str) -> None:
    """Break ``workload``'s frame entry in the miniature ``root`` as ``fault``."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    w = next(w for w in b["workloads"] if w["name"] == workload)
    cfg = json.loads((root / "perfbench" / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    entry = mix["entry"]
    path = root / "perfbench" / "entries" / cfg["model"] / f"{entry}.py"
    path.write_text(PLANTED.format(model=cfg["model"], entry=entry, bench=str(BENCH),
                                   code=FAULTS[fault]))
