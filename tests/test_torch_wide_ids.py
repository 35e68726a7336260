"""Ids past 2^24 on the plane path, on the CPU through the plain versions.

The ``idsf`` codec (``ops/cuda/resident.py``: ``encode_ids``/``decode_ids``)
at its edges; a state whose ids start above 2^24 through ``plane_step`` and
through the 4-band sharded step (4-rank gloo worlds), against the same state
with small ids; a band's own initial binning against the whole grid's rows;
the benchmark's large reference (``perfbench/reference/sph_large.py``)
against the port with wide ids and against ``reference/sph.py`` with its
chunks cut into columns; a planted fault in the ids that its judge catches;
and the judge's halo census against the bytes the mesh's counter saw.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.core.state import make_state
from rust_particle_system_tpu_torch.interop import state_to_numpy
from rust_particle_system_tpu_torch.ops.cuda.resident import (
    ID_EXACT, MAX_IDS, decode_ids, encode_ids, plane_state_from_particles, plane_step,
    to_particle_state)
from rust_particle_system_tpu_torch.parallel import (BandMesh, band_plane_state,
                                                    gather_plane_state, make_plane_sharded_step,
                                                    make_shard_spec, run_bands,
                                                    shard_plane_state)

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import spec as bench_spec  # noqa: E402
from harness import work  # noqa: E402
from reference import sph as ref  # noqa: E402
from reference import sph_large as ref_large  # noqa: E402

BOUNDS = (-54.0, 54.0, -36.0, 36.0)  # 12 x 9 cells of 9.0, padded to 12 rows on 4 bands
CHANNELS = ("px", "py", "vx", "vy", "idsf")
WIDE = (1 << 28) + 5  # the wide state's first id
WORLD_S = 120.0
EDGES = [0, ID_EXACT - 1, ID_EXACT, 1 << 28, MAX_IDS - 1]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _particles(seed: int, n: int = 400, bounds=BOUNDS, vmax: float = 40.0):
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([bounds[0], bounds[2]])
    hi = torch.tensor([bounds[1], bounds[3]]) - 1e-3
    pos = lo + torch.rand((n, 2), generator=g) * (hi - lo)
    return pos, vmax * (2.0 * torch.rand((n, 2), generator=g) - 1.0)


def _state(pos, vel, first_id: int = 0):
    s = make_state(pos, vel)
    return dataclasses.replace(s, ids=first_id + torch.arange(s.n, dtype=torch.int32))


def _params():
    return make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)


def _assert_like_small(wide: dict, small: dict):
    """Every channel but idsf bit for bit; the ids decoded, WIDE apart."""
    for k in CHANNELS[:4]:
        assert torch.equal(_bits(wide[k]), _bits(small[k])), k
    live = small["px"] < 5e5
    assert torch.equal(decode_ids(wide["idsf"])[live], decode_ids(small["idsf"])[live] + WIDE)
    assert torch.equal(_bits(wide["idsf"])[~live], _bits(small["idsf"])[~live])


# ---------------------------------------------------------------- the codec


@pytest.mark.parametrize("i", EDGES)
def test_codec_round_trip(i):
    ids = torch.tensor([i], dtype=torch.int32)
    f = encode_ids(ids)
    assert int(decode_ids(f)) == i
    assert torch.equal(_bits(ref_large.id_values(ids)), _bits(f))  # the reference's own codec
    if i < ID_EXACT:
        assert torch.equal(_bits(f), _bits(torch.tensor([float(i)], dtype=torch.float32)))
    else:  # a negative normal float: no subnormal, -0.0, infinity or NaN
        v = float(f)
        assert np.isfinite(v) and v < 0 and abs(v) >= np.finfo(np.float32).tiny


def test_codec_is_one_to_one_at_its_edges():
    ids = torch.cat([torch.arange(ID_EXACT - 64, ID_EXACT + 64, dtype=torch.int32),
                     torch.arange(MAX_IDS - 64, MAX_IDS, dtype=torch.int32)])
    f = encode_ids(ids)
    assert torch.equal(decode_ids(f), ids)
    assert torch.unique(_bits(f)).numel() == ids.numel()


def test_ids_past_the_codec_and_states_past_2_24_for_jax_are_refused():
    spec = make_shard_spec(BOUNDS, 9.0, 16, 1)
    pos, vel = _particles(1, n=4)
    with pytest.raises(ValueError, match="idsf"):
        plane_state_from_particles(_state(pos, vel, MAX_IDS - 3), spec)
    ps = plane_state_from_particles(_state(pos, vel), spec)
    with pytest.raises(ValueError, match="2\\^24"):
        state_to_numpy(dataclasses.replace(ps, n=ID_EXACT + 1))
    assert state_to_numpy(ps)["state/idsf"].dtype == np.float32


# ------------------------------------------------------- the port's step


@pytest.mark.parametrize("variant,fuse_tail", [(6, True), (6, False), (5, True), (4, True),
                                               (3, True), (2, True)])
def test_wide_ids_step_as_small_ones(variant, fuse_tail):
    """Every rebin variant (K1, K9's passes, K12) and both tails move the
    ids' bits and compute nothing with them."""
    spec, params = make_shard_spec(BOUNDS, 9.0, 16, 1), _params()
    pos, vel = _particles(3)
    states = {k: plane_state_from_particles(_state(pos, vel, first), spec)
              for k, first in (("small", 0), ("wide", WIDE))}
    for _ in range(3):
        states = {k: plane_step(s, params, spec, fuse_tail, variant) for k, s in states.items()}
    _assert_like_small(*({f: getattr(states[k], f) for f in CHANNELS} for k in ("wide", "small")))
    a, b = to_particle_state(states["wide"]), to_particle_state(states["small"])
    assert torch.equal(a.ids, b.ids + WIDE) and torch.equal(a.pos, b.pos)


@pytest.mark.parametrize("crowded", [False, True])
def test_band_binning_is_the_whole_grid_rows(crowded):
    """A band's own initial binning equals those rows of the whole grid's,
    spills across the band edges included (a crowded band seam)."""
    cap = 4 if crowded else 16
    spec = make_shard_spec(BOUNDS, 9.0, cap, 4)
    pos, vel = _particles(5, n=600)
    if crowded:  # most particles within a few cells of the seam of bands 1 and 2
        pos = pos * torch.tensor([0.15, 0.1])
    state = _state(pos, vel, WIDE)
    whole = plane_state_from_particles(state, spec)
    if crowded:  # the spill reached band 0's rows, and some particles found no slot
        assert int(whole.lost) > 0 and bool((whole.px[:spec.gh // 4] < 5e5).any())
    for rank in range(4):
        mesh = BandMesh(group=None, size=4, rank=rank, device=torch.device("cpu"),
                        backend="gloo")
        want, got = shard_plane_state(whole, mesh), band_plane_state(state, spec, mesh)
        for f in CHANNELS:
            assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), (rank, f)
        assert int(got.lost) == int(whole.lost) and got.n == whole.n


# ---------------------------------------------------------- the mesh


def _drive(mesh, pos, vel, gh_rows: int, frames: int):
    """One rank: the small and the wide state binned on this band, ``frames``
    sharded steps of each; the bytes the counter saw in the last frame, and
    on band 0 the whole planes."""
    spec = make_shard_spec((BOUNDS[0], BOUNDS[1], BOUNDS[2], BOUNDS[2] + 9.0 * gh_rows - 1.0),
                           9.0, 16, mesh.size)
    step = make_plane_sharded_step(spec, mesh)
    params = _params()
    out = {"rows": spec.gh // mesh.size, "gh": spec.gh}
    for name, first in (("small", 0), ("wide", WIDE)):
        slab = band_plane_state(_state(pos, vel, first), spec, mesh)
        for _ in range(frames):
            before = sum(mesh.received.values())
            slab, diags = step(slab, params)
            assert int(diags[1]) == pos.shape[0]
        out[f"bytes_{name}"] = sum(mesh.received.values()) - before
        whole = gather_plane_state(slab, mesh)
        out[name] = {f: getattr(whole, f) for f in CHANNELS}
    return out


def _world(gh_rows: int, frames: int = 3):
    pos, vel = _particles(7, n=300, bounds=(BOUNDS[0], BOUNDS[1], BOUNDS[2],
                                             BOUNDS[2] + 9.0 * gh_rows - 1.0))
    return run_bands(_drive, 4, backend="gloo", device="cpu", timeout=WORLD_S,
                     args=(pos, vel, gh_rows, frames))


@pytest.fixture(scope="module", params=[8, 4], ids=["two_rows_a_band", "one_row_a_band"])
def world(request):
    return request.param, _world(request.param)


def test_wide_ids_sharded_step_as_small_ones(world):
    _, out = world
    _assert_like_small(out[0]["wide"], out[0]["small"])


def test_halo_census_is_the_bytes_the_mesh_received(world):
    gh_rows, out = world
    cfg = dict(bench_spec.config("sph_256m_bands4"), n=300,
               bounds=[BOUNDS[0], BOUNDS[1], BOUNDS[2], BOUNDS[2] + 9.0 * gh_rows - 1.0],
               capacity=16)
    judge = bench_spec.model(cfg["model"]).Judge(cfg)
    rows = out[0]["rows"]
    assert judge.g.gh == out[0]["gh"]
    counted = [judge.halo_bytes((rank * rows, 0, rows)) for rank in range(4)]
    assert counted == [o["bytes_small"] for o in out] == [o["bytes_wide"] for o in out]
    parts = [{"walks": [{"live": 1}], "halo_bytes": b} for b in counted]
    assert judge.work(parts)["halo_bytes"] == max(counted) > 0


# ------------------------------------------------- the large reference


def _ref_cfg(capacity=16):
    return dict(bench_spec.config("sph_256m_bands4"), n=400, bounds=list(BOUNDS),
                capacity=capacity, bands=1)


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_large_reference_follows_the_port_with_wide_ids(seed):
    cfg = _ref_cfg()
    model = bench_spec.model(cfg["model"])
    program, judge = model.Program(cfg, torch.device("cpu")), model.Judge(cfg)
    pos, vel = _particles(seed)
    ps = plane_state_from_particles(_state(pos, vel, WIDE), program.spec)
    for _ in range(2):
        ps_in, ps = ps, program.step(ps)
    numbers = judge.frame_numbers(model.Program.planes(ps), None,
                                  judge.step(model.Program.planes(ps_in)))
    assert numbers["slot_mismatch"] == numbers["nonfinite"] == 0, numbers
    assert numbers["pos_err"] <= 1e-3 and numbers["vel_err"] <= 5e-3, numbers
    assert bool((decode_ids(ps.idsf)[ps.live] >= WIDE).all())


def test_large_reference_is_sph_reference_with_columns_cut(monkeypatch):
    """Small ids, the chunk budgets forced small (column pieces of a row
    chunk, rebin calls of 2 rows): every plane and count bit for bit."""
    monkeypatch.setattr(ref_large, "CHUNK_ELEMS", 3 * 9 * 16 * 16)
    monkeypatch.setattr(ref_large, "REBIN_ROWS", 2)
    g = ref.Grid.of(BOUNDS, 9.0, 16)
    p = ref.Params.of(_ref_cfg()["physics"], BOUNDS)
    pos, vel = _particles(11, vmax=60.0)
    assert len(list(ref_large._pieces(torch.zeros(g.gh, g.gw, 16)))) > g.gh
    planes, lost = ref.bin_particles(pos, vel, g)
    planes_l, lost_l = ref_large.bin_particles(pos, vel, g)
    assert lost == lost_l
    for a, b in zip(planes, planes_l):
        assert torch.equal(_bits(a), _bits(b))
    for row0, rows in ((0, slice(None)), (3, slice(2, 7))):  # the whole grid; a band's rows
        band = [t[rows] for t in planes]
        want = ref.step(band, p, g, row0=row0)
        got = ref_large.step(band, p, g, row0=row0)
        for a, b in zip(want["planes"] + list(want["raw"]), got["planes"] + list(got["raw"])):
            assert torch.equal(_bits(a), _bits(b))
        for k in ("density_pairs", "force_pairs", "walk_live"):
            assert want[k] == got[k]
    wx, wy = ref.walk_positions(*ref.rebin(ref.predict(planes, p), g)[:2], g)
    assert ref_large.count_pairs(wx, wy, p.h, slice(2, 6)) == work.count_pairs(
        wx, wy, p.h, slice(2, 6))


def test_ids_rounded_to_float_are_caught():
    """The fault the codec cures: ids written as float(id), rounded past
    2^24.  The judge's slot check sees every such particle."""
    cfg = _ref_cfg()
    model = bench_spec.model(cfg["model"])
    program, judge = model.Program(cfg, torch.device("cpu")), model.Judge(cfg)
    pos, vel = _particles(13)
    ps_in = plane_state_from_particles(_state(pos, vel, WIDE), program.spec)
    out = program.planes(program.step(ps_in))
    rounded = out[:4] + [torch.where(out[0] < 5e5, decode_ids(out[4]).to(torch.float32), 0.0)]
    numbers = judge.frame_numbers(rounded, None, judge.step(program.planes(ps_in)))
    assert numbers["slot_mismatch"] == int((out[0] < 5e5).sum()) > 0
    assert judge.frame_numbers(out, None, judge.step(program.planes(ps_in)))[
        "slot_mismatch"] == 0
