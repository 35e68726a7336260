"""The 256M band cell's pieces, found by name: its configuration, the model
``sph_large`` (built on ``sph``'s program and judge), its entry, its limits
and its two mesh metrics; and the cell run whole in a miniature over four
gloo ranks on the CPU: a sound run is correct, the control is not."""

from __future__ import annotations

import json

import torch

from conftest import BENCH, ROOT
from harness import result, spec, trace

CELL = "sph256m_bands4"


def test_the_cell_finds_its_pieces_by_name():
    c = spec.cell(CELL, ROOT)
    cfg = c["config"]
    assert c["chips"] == 4 and cfg["bands"] == 4 and cfg["model"] == "sph_large"
    assert cfg["n"] > 1 << 24 and cfg["reduced"] == []
    model, sph = spec.model(cfg["model"]), spec.model("sph")
    assert issubclass(model.Program, sph.Program) and issubclass(model.Judge, sph.Judge)
    entry = spec.entry(cfg["model"], c["traffic"]["entry"])
    assert entry.build is spec.entry("sph", "sharded_step").build and not entry.IMAGE
    assert set(c["limits"]) == {"pos_err", "vel_err"}
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    assert all(v["lower"] < v["limit"] < v["upper"] and v["why"] for v in limits.values())
    names = {m["name"] for m in c["per_layer"]}
    assert names == {"halo_ms", "halo_roofline"}
    for name in names:
        assert callable(spec.metric(name).read)
    assert {m["name"] for m in c["end_to_end"]} == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_the_judge_sizes_the_whole_grid():
    cfg = spec.config("sph_256m_bands4")
    judge = spec.model("sph_large").Judge(cfg)
    assert (judge.g.gw, judge.g.gh, judge.g.C) == (3414, 1924, 128)
    rows = judge.g.gh // 4
    got = [judge.halo_bytes((r * rows, 0, rows)) for r in range(4)]
    row = 3414 * 128 * 4
    assert got == [11 * row + 12, 24 * row + 12, 24 * row + 12, 13 * row + 12]


def _reading(ms: float, work: dict | None) -> trace.Reading:
    ops = [("ncclDevKernel_SendRecv", 0.0, 1e3 * ms)]
    return trace.Reading(ops=ops, frames=1, window_s=0.1, enqueue_ms=1.0, work=work)


def test_halo_roofline_reads_the_census_over_halo_ms():
    roof = spec.metric("halo_roofline")
    got = roof.read([_reading(2.0, {"halo_bytes": 9e8}), _reading(1.0, None)])
    assert abs(got - 100.0 * 9e8 / 450e9 / 2e-3) < 1e-9  # the slowest band's NCCL time
    assert roof.read([_reading(2.0, {"live": 1})]) is None  # no census of the halo
    empty = trace.Reading(ops=[], frames=1, window_s=0.1, enqueue_ms=1.0,
                          work={"halo_bytes": 1})
    assert roof.read([empty]) is None  # no NCCL rows


def test_sound_and_control(mini):
    line = result.measure(CELL, 2**31 + 11, 0.05, False, "cpu", mini, backend="gloo",
                          control=True)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4 and line["attempted"] > 0 and line["failed"] == 0
    assert not line["control_correct"], line["control_checks"]


def test_traced(mini):
    line = result.measure(CELL, 5, 0.05, True, "cpu", mini, backend="gloo")
    assert line["correct"] and line["device"]["count"] == 4
    assert "halo_ms" not in line["metrics"]  # no device rows on the CPU: no reading, not 0
    assert "halo_roofline" not in line["metrics"]


def test_the_programs_band_is_the_sph_programs(mini):
    """Binned band by band, the initial state is the whole grid's rows."""
    from rust_particle_system_tpu_torch.parallel import BandMesh

    cfg = spec.config("sph_256m_bands4", mini / "perfbench")
    large, sph = spec.model("sph_large"), spec.model("sph")
    particles = spec.init("uniform").particles(cfg, 3, "cpu")
    for rank in range(4):
        mesh = BandMesh(group=None, size=4, rank=rank, device=torch.device("cpu"),
                        backend="gloo")
        a = large.Program(cfg, torch.device("cpu"), mesh).init(particles)
        b = sph.Program(cfg, torch.device("cpu"), mesh).init(particles)
        for x, y in zip(large.Program.planes(a), sph.Program.planes(b)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_profile_spans_reads_each_bands_halo_bytes(mini):
    """``profile_spans.py``'s band runs: each band's counter over one frame
    is the judge's census of that band."""
    import profile_spans as tool

    c = spec.cell(CELL, mini)
    ranks = tool._ranks(c, 7, "cpu", "gloo")
    judge = spec.model("sph_large").Judge(c["config"])
    rows = judge.g.gh // 4
    got = [sum(r["reading"].received.values()) for r in ranks]
    assert got == [judge.halo_bytes((b * rows, 0, rows)) for b in range(4)]
    assert set(ranks[1]["reading"].received) == {"below", "above", "reduce"}
