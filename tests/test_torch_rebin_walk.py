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
crowded and sparse planes; those cases skip without a card.  This module
imports only the port, so on the card it runs with
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
    masked = resident.Slab(0, lambda c, variant: (*R.rebin_planes(c, spec), None))
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
