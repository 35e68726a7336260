"""The band mesh's path of the harness, in a world of four CPU processes over
gloo (halos staged through the host): a sound run is correct, the control is
not, and a run whose halo exchanges are left out is not.  Each band checks
its own rows: its numbers, summed or maximised over the bands, equal those of
the whole grid, a particle altered in any band's rows is caught, and no band's
judge is handed the whole grid."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import BENCH, PLANTED, plant
from harness import cell, result, spec

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


def _world(fn, root, *args):
    """``fn(mesh, c, *args)`` on each of the band cell's four gloo ranks."""
    from rust_particle_system_tpu_torch.parallel import run_bands

    c = spec.cell(CELL, root)
    return run_bands(fn, int(c["config"]["bands"]), "gloo", "cpu", 300.0, args=(c,) + args)


def _whole(planes, mesh):
    """The whole grid's planes from every band's rows (the test's own gather)."""
    import torch.distributed as dist

    out = []
    for p in planes:
        parts = [torch.empty_like(p) for _ in range(mesh.size)]
        dist.all_gather(parts, p.contiguous(), group=mesh.group)
        out.append(torch.cat(parts))
    return out


def _equal_band(mesh, c, seed):
    """This rank's run, band by band, and the whole grid's numbers of the
    same frames, worked out from the gathered planes on the first rank."""
    from reference import sph as ref

    # At the cells' sizes a reference chunk is one row of cells (854 x 128 or
    # wider); here too, so that a band's sums run over the same slots, in the
    # same order, as the whole grid's.
    ref.CHUNK_ELEMS = 1
    Judge = spec.model(c["config"]["model"], c["bench"]).Judge
    seen = {}
    numbers, census = Judge.numbers, Judge.census

    def seen_numbers(self, particles, init, planes_in, out, image, lost, band=None):
        seen.update(particles=particles, init=init, planes_in=planes_in, out=out, lost=lost,
                    band=band)
        return numbers(self, particles, init, planes_in, out, image, lost, band)

    def seen_census(self, samples, out, band=None):
        seen["samples"] = samples
        return census(self, samples, out, band)

    Judge.numbers, Judge.census = seen_numbers, seen_census
    got = cell.run(c, seed, 0.05, True, "cpu", mesh, control=True)
    _, lo, rows = seen["band"]
    own = lambda planes: [p[lo: lo + rows] for p in planes]
    init, out = _whole(seen["init"], mesh), _whole(seen["out"], mesh)
    planes_in = _whole(own(seen["planes_in"]), mesh)
    samples = [_whole(own(s), mesh) for s in seen["samples"]]
    if mesh.rank:
        return None
    judge = Judge(c["config"], c["bench"])
    whole = {"numbers": judge.combine([numbers(judge, seen["particles"], init, planes_in, out,
                                               None, seen["lost"])]),
             "work": judge.work([census(judge, samples, out)]),
             "control": judge.combine([judge.control(planes_in)])}
    return whole, {"numbers": got["numbers"], "work": got["reading"].work,
                   "control": got["control_numbers"]}, init[0].shape[0]


@pytest.mark.parametrize("seed", [2**31 + 17, 5])
def test_bands_equal_the_whole_grid(mesh_mini, seed):
    whole, bands, gh = _world(_equal_band, mesh_mini, seed)[0]
    assert gh == 16  # the miniature's 13 rows padded to four bands of 4
    assert bands == whole
    assert whole["numbers"]["slot_mismatch"] == 0 and whole["work"]["density_pairs"] > 0
    assert whole["control"]["vel_err"] > 0


PHYSICS = json.loads((BENCH / "configs" / "sph_16m.json").read_text())["physics"]


def _crowded(seed: int):
    """A judge for 6 x 16 cells of 16 slots in four bands, and planes of ~12
    particles a cell moving up to 4.5 units a frame each way: many movers
    across rows, into cells with few holes."""
    cfg = {"n": 0, "bounds": [0.0, 45.0, 0.0, 135.0], "cell_size": 9.0, "capacity": 16,
           "physics": PHYSICS, "bands": 4}
    judge = spec.model("sph").Judge(cfg)
    g = judge.g
    gen = torch.Generator().manual_seed(seed)
    n = 12 * g.gw * g.gh
    pos = torch.rand((n, 2), generator=gen) * torch.tensor([45.0, 135.0])
    vel = 900.0 * torch.rand((n, 2), generator=gen) - 450.0
    from reference import sph as ref

    return judge, ref.bin_particles(pos, vel, g)[0]


@pytest.mark.parametrize("seed", [0, 2])
def test_ghost_rows_are_what_a_band_step_reads(monkeypatch, seed):
    """Each band's step of its own rows, with ``Judge.GHOSTS`` rows of the
    input below and above them, equals those rows of the whole grid's step
    bit for bit; a row fewer on either side does not."""
    from reference import sph as ref

    monkeypatch.setattr(ref, "CHUNK_ELEMS", 1)  # one row a chunk, as at the cells' sizes
    judge, planes = _crowded(seed)
    whole = judge.step(planes)
    gh, R = judge.g.gh, judge.g.gh // 4

    def bands_equal(below, above):
        for row0 in range(0, gh, R):
            lo, hi = min(below, row0), min(above, gh - row0 - R)
            got = judge.step([p[row0 - lo: row0 + R + hi] for p in planes], band=(row0, lo, R))
            for a, w in zip(got["planes"] + got["raw"], whole["planes"] + whole["raw"]):
                if not torch.equal(a.view(torch.int32), w[row0: row0 + R].view(torch.int32)):
                    return False
        return True

    below, above = judge.GHOSTS
    assert bands_equal(below, above)
    assert not bands_equal(below - 1, above)
    assert not bands_equal(below, above - 1)


def test_a_band_bins_its_rows_as_the_whole_grid_does():
    """Particles crowded about the seam of bands 0 and 1, 8 slots a cell:
    the overflow spills across the seam and some is lost.  Each band's rows
    of the reference's binning equal those rows of the whole binning, and
    the bands' losses sum to the whole loss."""
    from conftest import MINI_BOUNDS
    from reference import sph as ref

    g = ref.Grid.of(MINI_BOUNDS, 9.0, 8, bands=4)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((900, 2), generator=gen)
    pos = torch.stack([40.0 * u[:, 0] - 20.0, 8.0 * u[:, 1] - 22.0], dim=1)  # rows 3 and 4
    vel = torch.rand((900, 2), generator=gen)
    whole, lost = ref.bin_particles(pos, vel, g)
    R, losses = g.gh // 4, []
    for row0 in range(0, g.gh, R):
        band, band_lost = ref.bin_particles(pos, vel, g, (row0, row0 + R))
        losses.append(band_lost)
        for a, w in zip(band, whole):
            assert torch.equal(a.view(torch.int32), w[row0: row0 + R].view(torch.int32))
    assert sum(losses) == lost > 0 and losses[0] > 0 and losses[1] > 0
    assert int(ref.live(whole[0][:R]).sum()) > 0 and int(ref.live(whole[0][R:2 * R]).sum()) > 0


# One particle of band 1 altered where its frame makes it, in a grid row at a
# seam with another band or inside the band.
ROW_FAULT = """
def planted(real, program):
    def frame(ps):
        new, aux = real(ps)
        if program.mesh.rank != 1:
            return new, aux
        vx = new.vx.clone()
        row = vx[{row}].reshape(-1)
        row[int(torch.nonzero(new.px[{row}].reshape(-1) < 5e5)[0])] += 1.0
        return dataclasses.replace(new, vx=vx), aux
    return frame
"""


@pytest.mark.parametrize("row", [0, 2, -1], ids=["seam_below", "interior", "seam_above"])
def test_a_fault_in_any_row_of_a_band_is_caught(mesh_mini, row):
    b = json.loads((mesh_mini / "BENCHMARK.json").read_text())
    w = next(w for w in b["workloads"] if w["name"] == CELL)
    mix = json.loads((mesh_mini / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    (mesh_mini / "perfbench" / "entries" / "sph" / f"{mix['entry']}.py").write_text(
        PLANTED.format(model="sph", entry=mix["entry"], bench=str(BENCH),
                       code=ROW_FAULT.format(row=row)))
    line = result.measure(CELL, 7, 0.05, False, "cpu", mesh_mini, backend="gloo")
    assert not line["correct"], line["checks"]
    assert line["checks"]["vel_err"][0] >= 0.5, line["checks"]


def _judge_rows(mesh, c):
    """The row counts of every plane this rank's judge is handed in a traced
    run with the control."""
    Judge = spec.model(c["config"]["model"], c["bench"]).Judge
    handed = []

    def scan(x):
        if isinstance(x, torch.Tensor) and x.dim() == 3:
            handed.append(x.shape[0])
        elif isinstance(x, (list, tuple)):
            for y in x:
                scan(y)

    def watched(name):
        real = getattr(Judge, name)

        def method(self, *args, **kwargs):
            scan(list(args) + list(kwargs.values()))
            return real(self, *args, **kwargs)
        return method

    for name in ("numbers", "census", "control"):
        setattr(Judge, name, watched(name))
    cell.run(c, 11, 0.05, True, "cpu", mesh, control=True)
    return handed


def test_no_band_is_handed_the_whole_grid(mesh_mini):
    ranks = _world(_judge_rows, mesh_mini)
    gh, bands = 16, 4
    for rank, handed in enumerate(ranks):
        assert handed, rank
        assert max(handed) < gh, (rank, handed)
        # its own rows and at most 4 below and 3 above
        assert max(handed) <= gh // bands + 4 * (rank > 0) + 3 * (rank < bands - 1)
