"""The rebin that writes the walks' position planes (K1 and K7 with the defer
mask in their stores).

``rebin_planes_walk`` (K1 on the whole grid, K7 on a band's slab given its
ghost rows) returns the rebin's planes and counts and, beside them, the walk
planes: ``walk_positions`` of
the rebinned x/y, every deferred slot (live, keyed to another cell than the
one it sits in) parked at SENTINEL.  The kernel decides "deferred" by its
block's key cuts as it writes each slot, so the planes must equal the torch
mask of its own output bit for bit, and asking for them must leave the
rebin's planes and counts as they were.

On the CPU the entry runs the plain rebin followed by ``walk_positions``:
held here on the whole grid and on band slabs with ghost rows, at C 16 and
128, on states built to hold deferred slots (crowded cells whose movers find
no hole and are retained, movers of more than one cell), and through the
frame's core ``resident._physics``, which must give the same frame whether
the rebin hands it the walk planes or it computes them.  On a card, K1's and K7's walk planes are
held to ``walk_positions`` of K1's output over C 16/128/1024 and uniform,
crowded and sparse planes; those cases skip without a card.

Handed the state's raw planes and ``predict = (dt, gdt)``, the entry applies
gravity and the predict as it loads (K1 and K7, ``rebin_tile<true>``): its
planes, counts and walk planes must equal ``predict_channels`` followed by
the entry bit for bit, also where dead slots hold stale velocities and ids
lie past 2^24; a band's, its ghost rows predicted as the band path predicts
its edge rows, must be those rows of the whole grid's.  ``plane_step``
variant 6 is that composition written out; variant 5 still predicts in
torch.  This module imports only the port, so on the card it runs with
``python -m pytest --noconftest tests/test_torch_rebin_walk.py``.
"""

import numpy as np
import pytest
import torch

from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.ops.cuda import rebin as R
from rust_particle_system_tpu_torch.ops.cuda import resident
from rust_particle_system_tpu_torch.ops.cuda.rebin import SENTINEL, walk_positions
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.parallel import plane_sharded

H = 9.0
GEOMS = {  # C: bounds (gw x gh cells of 9.0)
    16: (-90.0, 90.0, -45.0, 45.0),  # 21 x 11
    128: (-54.0, 54.0, -36.0, 36.0),  # 13 x 9
    1024: (-18.0, 18.0, -18.0, 18.0),  # 5 x 5
}
PLANES = {  # name: (share of slots live, drift in cells)
    "uniform": (0.4, 1.6),
    "crowded": (1.0, 0.6),  # no hole anywhere: every mover is retained
    "sparse": (0.05, 1.6),
}
FILLS = (SENTINEL, SENTINEL, 0.0, 0.0, 0.0)


def _planes(capacity, kind, seed=0, device="cpu"):
    """(spec, [x, y, vx, vy, ids]): the rebin's input, slots live at the
    share ``kind`` gives, each particle in its cell jittered by up to the
    drift (so some key one or more cells away), and a twentieth of them
    put on a cell edge or the float just below it."""
    bounds = GEOMS[capacity]
    fill, drift = PLANES[kind]
    spec = GridSpec.from_bounds(bounds, H, capacity)
    rng = np.random.default_rng(seed)
    shape = (spec.gh, spec.gw, capacity)
    live = rng.random(shape) < fill
    jitter = lambda: (rng.random(shape) * 2 - 1) * drift
    cx = np.arange(spec.gw)[None, :, None] + rng.random(shape) + jitter()
    cy = np.arange(spec.gh)[:, None, None] + rng.random(shape) + jitter()
    x = np.clip(spec.x_min + cx * spec.cell_width, bounds[0], bounds[1]).astype(np.float32)
    y = np.clip(spec.y_min + cy * spec.cell_size, bounds[2], bounds[3]).astype(np.float32)
    for v, lo, w, n in ((x, spec.x_min, spec.cell_width, spec.gw),
                        (y, spec.y_min, spec.cell_size, spec.gh)):
        edge = rng.random(shape) < 0.05
        j = rng.integers(0, n + 1, shape)
        at = np.float32(lo) + np.float32(j) * np.float32(w)
        v[edge] = np.where(rng.random(shape) < 0.5, at, np.nextafter(at, np.float32(-np.inf)))[edge]
    ids = np.arange(live.size, dtype=np.float32).reshape(shape)
    chans = [np.where(live, x, SENTINEL), np.where(live, y, SENTINEL),
             np.where(live, rng.standard_normal(shape) * 20, 0.0),
             np.where(live, rng.standard_normal(shape) * 20, 0.0), np.where(live, ids, 0.0)]
    return spec, [torch.as_tensor(a.astype(np.float32), device=device) for a in chans]


def _raw(capacity, kind, seed=0, device="cpu"):
    """(spec, [px, py, vx, vy, idsf], predict): a state for the predict at
    load, from :func:`_planes`.  ``kind`` as there, or "stale" (uniform,
    every dead slot holding a velocity of its own, which the predict must
    not carry) or "wide" (uniform, ids from 2^24 up, in the codec's negative
    floats)."""
    spec, chans = _planes(capacity, "uniform" if kind in ("stale", "wide") else kind, seed)
    dead = ~(chans[0] < 0.5 * SENTINEL)
    gen = torch.Generator().manual_seed(seed)
    if kind == "stale":
        for c in (2, 3):
            chans[c] = torch.where(dead, torch.randn(dead.shape, generator=gen) * 30, chans[c])
    if kind == "wide":
        ids = (1 << 24) + torch.arange(dead.numel(), dtype=torch.int32).reshape(dead.shape)
        chans[4] = torch.where(dead, 0.0, resident.encode_ids(ids))
    params = make_params(bounds=GEOMS[capacity], gravity=300.0)
    return spec, [c.to(device) for c in chans], resident.predict_args(params)


RAW = ["uniform", "crowded", "stale", "wide"]


def _deferred(px, wx) -> int:
    return int(((px < 0.5 * SENTINEL) & ~(wx < 0.5 * SENTINEL)).sum())


def _bit_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _ghosts(planes, r0, R, gh):
    """K7's ghost rows of the slab [r0, r0 + R): x/y of row r0-2, every
    channel of rows r0-1 and r0+R; the fill past the grid's edges."""
    row = lambda c, r: planes[c][r] if 0 <= r < gh else torch.full_like(planes[c][0], FILLS[c])
    k = len(planes)
    return ([row(c, r0 - 2) for c in (0, 1)], [row(c, r0 - 1) for c in range(k)],
            [row(c, r0 + R) for c in range(k)])


def _bands(gh):
    """(r0, R) of slabs at the grid's bottom, inside it and at its top, one
    of them a single row."""
    return [(0, 3), (gh // 2 - 1, 1), (gh // 2, 3), (gh - 4, 4)]


@pytest.mark.parametrize("kind", ["uniform", "crowded"])
@pytest.mark.parametrize("capacity", [16, 128])
def test_wrapper_is_the_rebin_then_the_mask(capacity, kind):
    """The whole grid: the rebin's planes and counts as ``rebin_planes``
    gives them, and the walk planes ``walk_positions`` of them; some slots
    deferred, each parked in both walk planes."""
    spec, chans = _planes(capacity, kind, seed=capacity)
    out, counts, (wx, wy) = R.rebin_planes_walk(chans, spec)
    want, want_counts = R.rebin_planes(chans, spec)
    assert all(_bit_equal(a, b) for a, b in zip(out, want)) and torch.equal(counts, want_counts)
    mx, my = walk_positions(out[0], out[1], spec)
    assert _bit_equal(wx, mx) and _bit_equal(wy, my)
    parked = (out[0] < 0.5 * SENTINEL) & ~(wx < 0.5 * SENTINEL)
    assert int(parked.sum()) > 0
    assert bool((wy[parked] == SENTINEL).all())
    home = ~parked
    assert _bit_equal(wx[home], out[0][home]) and _bit_equal(wy[home], out[1][home])


@pytest.mark.parametrize("kind", ["uniform", "crowded"])
@pytest.mark.parametrize("capacity", [16, 128])
def test_band_wrapper_is_those_rows_of_the_whole_grid(capacity, kind):
    """A band's slab with its ghost rows (``row0`` > 0, the grid's edges, a
    single row): its planes, counts and walk planes are those rows of the
    whole grid's."""
    spec, chans = _planes(capacity, kind, seed=capacity + 1)
    whole, whole_counts, whole_walk = R.rebin_planes_walk(chans, spec)
    assert _deferred(whole[0], whole_walk[0]) > 0
    for r0, Rb in _bands(spec.gh):
        slab = [p[r0:r0 + Rb].contiguous() for p in chans]
        out, counts, walk = R.rebin_planes_walk(slab, spec, FILLS, r0,
                                                _ghosts(chans, r0, Rb, spec.gh))
        rows = slice(r0, r0 + Rb)
        assert all(_bit_equal(a, b[rows]) for a, b in zip(out, whole)), (r0, Rb)
        assert torch.equal(counts, whole_counts[r0 * spec.gw:(r0 + Rb) * spec.gw])
        assert all(_bit_equal(a, b[rows]) for a, b in zip(walk, whole_walk)), (r0, Rb)
        plain, _ = R.rebin_planes_band(slab, spec, FILLS, r0, *_ghosts(chans, r0, Rb, spec.gh))
        mx, my = walk_positions(plain[0], plain[1], spec, r0)
        assert _bit_equal(walk[0], mx) and _bit_equal(walk[1], my)


def test_walk_wrappers_check_their_inputs():
    spec, chans = _planes(16, "uniform")
    with pytest.raises(ValueError):
        R.rebin_planes_walk([p[:-1] for p in chans], spec)
    slab = [p[:3] for p in chans]
    lo2, lo1, hi1 = _ghosts(chans, 0, 3, spec.gh)
    with pytest.raises(ValueError):
        R.rebin_planes_walk(chans, spec, FILLS, 1)
    with pytest.raises(ValueError):
        R.rebin_planes_walk(slab, spec, FILLS, spec.gh - 2, (lo2, lo1, hi1))
    with pytest.raises(ValueError):
        R.rebin_planes_walk(slab, spec, FILLS, 0, (lo1, lo1, hi1))


@pytest.mark.parametrize("fuse_tail", [True, False])
@pytest.mark.parametrize("capacity", [16, 128])
def test_walk_and_integrate_takes_the_walk_planes(capacity, fuse_tail):
    """The frame's core on the whole grid, its walks handed K1's walk
    planes, gives the frame (every plane, the live count, the counts and the
    walk x plane) it gives on a slab whose rebin returns K1's planes alone,
    the walk planes then computed by ``walk_positions``."""
    spec, chans = _planes(capacity, "uniform", seed=capacity + 2)
    params = make_params(bounds=GEOMS[capacity], gravity=300.0)
    ps = resident.PlaneState(*chans, frame=params.shader_delay,
                             lost=torch.zeros((), dtype=torch.int32),
                             n=int((chans[0] < 0.5 * SENTINEL).sum()))
    masked = resident.Slab(0, lambda c, variant, predict: (
        *R.rebin_planes(R.predict_channels(c, predict) if predict else c, spec), None))
    got = resident._physics(ps, params, spec, fuse_tail, 6, resident._grid_slab(spec))
    want = resident._physics(ps, params, spec, fuse_tail, 6, masked)
    (got_planes, got_live, got_counts, got_fpx) = got
    (want_planes, want_live, want_counts, want_fpx) = want
    assert _deferred(got_planes[0], got_fpx) > 0
    assert _bit_equal(got_fpx, want_fpx)
    assert all(_bit_equal(a, b) for a, b in zip(got_planes, want_planes))
    assert torch.equal(got_live, want_live) and torch.equal(got_counts, want_counts)


def test_frame_with_the_folded_mask_is_variant_5s():
    """A few frames of ``plane_step``: variant 6 (the walk planes from the
    rebin) equals variant 5 (K9's passes, the mask in torch) bit for bit."""
    spec, chans = _planes(16, "uniform", seed=5)
    params = make_params(bounds=GEOMS[16], gravity=300.0)
    ps = resident.PlaneState(*chans, frame=params.shader_delay,
                             lost=torch.zeros((), dtype=torch.int32),
                             n=int((chans[0] < 0.5 * SENTINEL).sum()))
    a = b = ps
    for _ in range(3):
        a = resident.plane_step(a, params, spec, variant=6)
        b = resident.plane_step(b, params, spec, variant=5)
    for f in ("px", "py", "vx", "vy", "idsf", "lost"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _cpu(result):
    """A ``rebin_planes_walk`` result on the host."""
    planes, counts, walk = result
    return [p.cpu() for p in planes], counts.cpu(), tuple(w.cpu() for w in walk)


def _same_rebin(got, want) -> bool:
    """Two ``rebin_planes_walk`` results equal bit for bit."""
    (a, ca, wa), (b, cb, wb) = got, want
    return (all(_bit_equal(x, y) for x, y in zip(a, b)) and torch.equal(ca, cb)
            and all(_bit_equal(x, y) for x, y in zip(wa, wb)))


@pytest.mark.parametrize("kind", RAW)
@pytest.mark.parametrize("capacity", [16, 128])
def test_entry_predicts_at_load(capacity, kind):
    """The whole grid handed the raw planes and the predict: the planes,
    counts and walk planes of ``predict_planes`` followed by the entry, bit
    for bit; the predict moved every live slot's y and parked every dead one."""
    spec, raw, predict = _raw(capacity, kind, seed=capacity + 3)
    got = R.rebin_planes_walk(raw, spec, FILLS, predict=predict)
    ps = resident.PlaneState(*raw, frame=0, lost=torch.zeros((), dtype=torch.int32), n=0)
    chans = resident.predict_planes(ps, make_params(bounds=GEOMS[capacity], gravity=300.0))
    assert _same_rebin(got, R.rebin_planes_walk(chans, spec, FILLS))
    live = raw[0] < 0.5 * SENTINEL
    assert not bool((chans[1][live] == raw[1][live]).any())
    assert bool((chans[0][~live] == SENTINEL).all()) and bool((chans[3][~live] == 0).all())
    assert _deferred(got[0][0], got[2][0]) > 0


@pytest.mark.parametrize("kind", ["uniform", "crowded"])
@pytest.mark.parametrize("capacity", [16, 128])
def test_band_entry_predicts_its_own_rows(capacity, kind):
    """K7 handed a band's raw slab and the predict, its ghost rows the
    neighbour bands' edge rows predicted as the band path predicts them
    (``plane_sharded._edge_rows``, then ``predict_channels``): every output
    is those rows of the whole grid's."""
    spec, raw, predict = _raw(capacity, kind, seed=capacity + 4)
    whole = R.rebin_planes_walk(raw, spec, FILLS, predict=predict)
    edges = lambda a, b: R.predict_channels(plane_sharded._edge_rows([p[a:b] for p in raw]),
                                            predict)
    fill = lambda c: torch.full_like(raw[c][0], FILLS[c])
    for r0, Rb in _bands(spec.gh):
        # The bands below and above: every row under the slab, every row over it.
        lo = edges(0, r0) if r0 else None
        hi = edges(r0 + Rb, spec.gh) if r0 + Rb < spec.gh else None
        ghosts = ([lo[c][-2] if r0 >= 2 else fill(c) for c in (0, 1)],
                  [lo[c][-1] if lo else fill(c) for c in range(5)],
                  [hi[c][0] if hi else fill(c) for c in range(5)])
        slab = [p[r0:r0 + Rb].contiguous() for p in raw]
        out, counts, walk = R.rebin_planes_walk(slab, spec, FILLS, r0, ghosts, predict)
        rows = slice(r0, r0 + Rb)
        assert all(_bit_equal(a, b[rows]) for a, b in zip(out, whole[0])), (r0, Rb)
        assert torch.equal(counts, whole[1][r0 * spec.gw:(r0 + Rb) * spec.gw])
        assert all(_bit_equal(a, b[rows]) for a, b in zip(walk, whole[2])), (r0, Rb)


def test_edge_rows_are_the_rows_the_neighbours_read():
    """``_edge_rows`` keeps rows 0, R-2 and R-1 in that order (the whole band
    at three rows or fewer), so the ghost rows ``rebin_halo`` picks from it
    are the band's own."""
    planes = [torch.arange(7 * 2 * 3, dtype=torch.float32).reshape(7, 2, 3) + c for c in (0, 9)]
    for Rb, rows in ((7, [0, 5, 6]), (4, [0, 2, 3]), (3, [0, 1, 2]), (2, [0, 1]), (1, [0])):
        got = plane_sharded._edge_rows([p[:Rb] for p in planes])
        assert all(torch.equal(g, p[rows]) for g, p in zip(got, planes)), Rb


def test_plane_step_variant_6_is_the_composition():
    """``plane_step`` variant 6 written out: the torch predict, the entry's
    rebin with the walk planes, the fused walks, the ids' re-park and
    ``lost``: bit for bit over three frames."""
    spec, raw, _ = _raw(16, "stale", seed=6)
    params = make_params(bounds=GEOMS[16], gravity=300.0)
    ps = resident.PlaneState(*raw, frame=params.shader_delay,
                             lost=torch.zeros((), dtype=torch.int32),
                             n=int((raw[0] < 0.5 * SENTINEL).sum()))
    for _ in range(3):
        got = resident.plane_step(ps, params, spec, variant=6)
        live_before = ps.live.sum(dtype=torch.int32)
        out, counts, walk = R.rebin_planes_walk(resident.predict_planes(ps, params), spec, FILLS)
        px, py, vx, vy = resident.walk_and_integrate(out, walk, spec, params, True)
        idsf = torch.where(out[0] < 0.5 * SENTINEL, out[4], 0.0)
        lost = ps.lost + (live_before - counts.clamp_max(spec.capacity).sum(dtype=torch.int32))
        for f, want in zip(("px", "py", "vx", "vy", "idsf"), (px, py, vx, vy, idsf)):
            assert _bit_equal(getattr(got, f), want), f
        assert torch.equal(got.lost, lost) and got.frame == ps.frame + 1
        ps = got


def test_variant_5_runs_the_torch_predict(monkeypatch):
    """Variant 5 predicts in torch, once a frame; variant 6 hands the rebin
    the state's planes and never calls it."""
    spec, raw, _ = _raw(16, "uniform", seed=7)
    params = make_params(bounds=GEOMS[16], gravity=300.0)
    ps = resident.PlaneState(*raw, frame=params.shader_delay,
                             lost=torch.zeros((), dtype=torch.int32),
                             n=int((raw[0] < 0.5 * SENTINEL).sum()))
    calls = []
    plain = resident.predict_planes
    monkeypatch.setattr(resident, "predict_planes", lambda *a: calls.append(1) or plain(*a))
    a = resident.plane_step(ps, params, spec, variant=5)
    assert len(calls) == 1
    b = resident.plane_step(ps, params, spec, variant=6)
    assert len(calls) == 1
    for f in ("px", "py", "vx", "vy", "idsf", "lost"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_predict_at_load_checks_its_channels():
    spec, raw, predict = _raw(16, "uniform")
    with pytest.raises(ValueError):
        R.rebin_planes_walk(raw[:3], spec, FILLS[:3], predict=predict)


# ---------------- on the card ----------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the rebin kernel K1/K7 runs on a CUDA card only")
    return "cuda"


@pytest.mark.parametrize("kind", list(PLANES))
@pytest.mark.parametrize("capacity", list(GEOMS))
def test_kernel_walk_planes_are_the_mask_of_its_output(card, capacity, kind):
    """K1 asked for the walk planes: they equal ``walk_positions`` of its
    own output bit for bit, and its planes and counts equal K1's not asked
    (the planes and counts it always wrote) and the plain version's."""
    spec, chans = _planes(capacity, kind, seed=capacity + 10, device=card)
    out, counts, (wx, wy) = R.rebin_planes_walk(chans, spec)
    base, base_counts = R.rebin_planes(chans, spec)
    plain, plain_counts = R.rebin_planes_plain([p.cpu() for p in chans], spec)
    mx, my = walk_positions(out[0], out[1], spec)
    torch.cuda.synchronize()
    assert _bit_equal(wx, mx) and _bit_equal(wy, my)
    assert _deferred(out[0], wx) > 0
    assert all(_bit_equal(a, b) for a, b in zip(out, base)) and torch.equal(counts, base_counts)
    assert all(_bit_equal(a.cpu(), b) for a, b in zip(base, plain))
    assert torch.equal(base_counts.cpu(), plain_counts)


@pytest.mark.parametrize("kind", list(PLANES))
@pytest.mark.parametrize("capacity", list(GEOMS))
def test_band_kernel_walk_planes_are_k1s_rows(card, capacity, kind):
    """K7 asked for the walk planes, on slabs at the grid's edges and inside
    it: every output is those rows of K1's on the whole grid, and its walk
    planes ``walk_positions`` of its own output."""
    spec, chans = _planes(capacity, kind, seed=capacity + 20, device=card)
    whole, whole_counts, whole_walk = R.rebin_planes_walk(chans, spec)
    for r0, Rb in _bands(spec.gh):
        slab = [p[r0:r0 + Rb].contiguous() for p in chans]
        ghosts = _ghosts(chans, r0, Rb, spec.gh)
        out, counts, walk = R.rebin_planes_walk(slab, spec, FILLS, r0, ghosts)
        base, base_counts = R.rebin_planes_band(slab, spec, FILLS, r0, *ghosts)
        mx, my = walk_positions(out[0], out[1], spec, r0)
        torch.cuda.synchronize()
        rows = slice(r0, r0 + Rb)
        assert all(_bit_equal(a, b[rows]) for a, b in zip(out, whole)), (r0, Rb)
        assert all(_bit_equal(a, b[rows]) for a, b in zip(walk, whole_walk)), (r0, Rb)
        assert torch.equal(counts, whole_counts[r0 * spec.gw:(r0 + Rb) * spec.gw])
        assert _bit_equal(walk[0], mx) and _bit_equal(walk[1], my)
        assert all(_bit_equal(a, b) for a, b in zip(out, base)) and torch.equal(counts, base_counts)


@pytest.mark.parametrize("kind", list(PLANES) + ["stale", "wide"])
@pytest.mark.parametrize("capacity", list(GEOMS))
def test_kernel_predicts_at_load(card, capacity, kind):
    """K1 handed the raw planes and the predict (``rebin_tile<true>``): its
    planes, counts and walk planes equal ``predict_planes`` on the card
    followed by K1 (``rebin_tile<false>``) bit for bit, and the plain
    version's."""
    spec, raw, predict = _raw(capacity, kind, seed=capacity + 30, device=card)
    got = R.rebin_planes_walk(raw, spec, FILLS, predict=predict)
    want = R.rebin_planes_walk(R.predict_channels(raw, predict), spec, FILLS)
    plain = R.rebin_planes_walk([p.cpu() for p in raw], spec, FILLS, predict=predict)
    torch.cuda.synchronize()
    assert _same_rebin(got, want) and _same_rebin(_cpu(got), plain)


@pytest.mark.parametrize("kind", list(PLANES) + ["stale"])
@pytest.mark.parametrize("capacity", list(GEOMS))
def test_band_kernel_predicts_its_own_rows(card, capacity, kind):
    """K7 handed a band's raw slab and the predict, its ghost rows predicted
    in torch: every output is those rows of K1's, folded, on the whole grid."""
    spec, raw, predict = _raw(capacity, kind, seed=capacity + 40, device=card)
    whole = R.rebin_planes_walk(raw, spec, FILLS, predict=predict)
    pred = R.predict_channels(raw, predict)
    for r0, Rb in _bands(spec.gh):
        slab = [p[r0:r0 + Rb].contiguous() for p in raw]
        out, counts, walk = R.rebin_planes_walk(slab, spec, FILLS, r0,
                                                _ghosts(pred, r0, Rb, spec.gh), predict)
        torch.cuda.synchronize()
        rows = slice(r0, r0 + Rb)
        assert all(_bit_equal(a, b[rows]) for a, b in zip(out, whole[0])), (r0, Rb)
        assert torch.equal(counts, whole[1][r0 * spec.gw:(r0 + Rb) * spec.gw])
        assert all(_bit_equal(a, b[rows]) for a, b in zip(walk, whole[2])), (r0, Rb)
