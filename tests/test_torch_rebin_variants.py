"""Port vs JAX: the rebin's other formulations, through their plain versions.

Variants 4 and 5 (two passes of K9, the separable hole-fill, with the
retention merge for 5) and variants 2 and 3 (K12, the full-window
compaction) against the JAX ``rebin_planes`` in interpret mode and the numpy
oracles of tests/test_rebin.py.  Values only move in a rebin, so every
comparison is bit-for-bit: planes and counts.  K9's band mode is held to
JAX in tests/test_torch_band_rebin.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rebin import _demo_planes, oracle_rebin, oracle_rebin_v4, oracle_rebin_v5

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas.rebin import rebin_planes as jrebin
from rust_particle_system_tpu_torch.ops.cuda.rebin import SENTINEL, hole_fill_pass, rebin_planes
from rust_particle_system_tpu_torch.ops.grid import GridSpec

GEOM = dict(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=7)
ORACLES = {2: oracle_rebin, 3: oracle_rebin, 4: oracle_rebin_v4, 5: oracle_rebin_v5}
FILLS_IDS = (SENTINEL, SENTINEL, -1.0)


@functools.lru_cache(maxsize=None)
def _jax_rebin(geom: tuple, variant: int, fills):
    """The JAX rebin of one geometry and variant, jitted once, so that interpret
    mode traces one program per shape."""
    spec = JGridSpec(**dict(geom))
    return jax.jit(lambda planes: jrebin(planes, spec, fills=fills, interpret=True,
                                         variant=variant))


def _run_both(planes, geom, variant, fills=None):
    """(port planes, port counts, JAX planes, JAX counts) as numpy."""
    got, gc = rebin_planes([torch.from_numpy(np.array(p)) for p in planes],
                           GridSpec(**geom), fills=fills, variant=variant)
    want, wc = _jax_rebin(tuple(sorted(geom.items())), variant, fills)(
        [jnp.asarray(p) for p in planes])
    return ([g.numpy() for g in got], gc.numpy(),
            [np.asarray(w) for w in want], np.asarray(wc))


def _assert_same(got, gc, want, wc):
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"channel {c}")
    np.testing.assert_array_equal(gc, wc)


def _demo(capacity, drift, seed=0, fill=0.6):
    geom = dict(GEOM, capacity=capacity)
    planes = [np.asarray(p) for p in _demo_planes(
        np.random.default_rng(seed), JGridSpec(**geom), capacity, fill, drift, k=5)]
    return geom, planes


@pytest.mark.parametrize("capacity,drift", [(16, 0.9), (16, 1.8), (40, 1.8)])
@pytest.mark.parametrize("variant", [2, 3, 4, 5])
def test_rebin_variant_matches_jax_and_oracle(variant, capacity, drift):
    """C=40 leaves a partial warp in the kernels' blocks."""
    geom, planes = _demo(capacity, drift)
    got, gc, want, wc = _run_both(planes, geom, variant)
    _assert_same(got, gc, want, wc)
    _assert_same(got, gc, *ORACLES[variant](planes, JGridSpec(**geom)))


@pytest.mark.parametrize("capacity", [16, 40])
@pytest.mark.parametrize("drift", [0.4, 0.9, 1.8])
def test_rebin_v5_equals_v6(drift, capacity):
    """tests/test_rebin.py:524-536 in the port: the two passes of K9 with the
    merges reproduce K1 bit for bit."""
    geom, planes = _demo(capacity, drift, seed=1, fill=0.7)
    t = [torch.from_numpy(p.copy()) for p in planes]
    a5, c5 = rebin_planes(t, GridSpec(**geom), variant=5)
    a6, c6 = rebin_planes(t, GridSpec(**geom), variant=6)
    for x, y in zip(a5, a6):
        assert torch.equal(x, y)
    assert torch.equal(c5, c6)


SMALL = dict(x_min=0.0, y_min=0.0, cell_size=10.0, gw=4, gh=2, capacity=4)


def _small_planes():
    """Empty (x, y, ids) planes of the 4 x 2 grid of C=4 on which every
    hand-built case runs (one geometry: JAX traces once per variant)."""
    px = np.full((2, 4, 4), SENTINEL, np.float32)
    return [px, px.copy(), np.full((2, 4, 4), -1.0, np.float32)]


def _crowded():
    """tests/test_rebin.py:196-220: every slot full, heavy cross-cell
    movement."""
    r = np.random.default_rng(3)
    px, py, ids = _small_planes()
    for i, (cy, cx, s) in enumerate(np.ndindex(2, 4, 4)):
        px[cy, cx, s] = np.clip(cx * 10 + r.uniform(-8, 18), 0.1, 39.9)
        py[cy, cx, s] = np.clip(cy * 10 + r.uniform(-8, 18), 0.1, 19.9)
        ids[cy, cx, s] = float(i)
    return [px, py, ids], 32


@pytest.mark.parametrize("variant", [2, 3, 4, 5])
def test_rebin_variant_crowded_grid(variant):
    """Bit-equal to JAX; no particle doubled; variant 5 loses none, the others
    account for what they drop in their counts."""
    planes, nid = _crowded()
    got, gc, want, wc = _run_both(planes, SMALL, variant, FILLS_IDS)
    _assert_same(got, gc, want, wc)
    live = got[0] < 0.5 * SENTINEL
    ids = got[2][live]
    assert len(np.unique(ids)) == len(ids) and np.all(ids >= 0)
    assert len(ids) == int(np.minimum(gc, 4).sum())
    if variant == 5:
        np.testing.assert_array_equal(np.sort(ids), np.arange(nid, dtype=np.float32))
    else:
        assert len(ids) < nid


@pytest.mark.parametrize("variant", [2, 3])
def test_rebin_overflow_counts_report_drops(variant):
    """tests/test_rebin.py:426-440: six candidates of cell (0, 1) at capacity
    4, three from cell (0, 0): counts 6 and four slots filled."""
    px, py, ids = _small_planes()
    px[0, 0, :3], py[0, 0, :3], ids[0, 0, :3] = [12.0, 13.0, 14.0], 5.0, [0, 1, 2]
    px[0, 1, :3], py[0, 1, :3], ids[0, 1, :3] = [15.0, 16.0, 17.0], 5.0, [3, 4, 5]
    got, gc, want, wc = _run_both([px, py, ids], SMALL, variant, FILLS_IDS)
    _assert_same(got, gc, want, wc)
    assert gc[1] == 6 and int(gc.sum()) == 6
    assert np.all(got[0][0, 1] < 0.5 * SENTINEL) and int((got[0] < 0.5 * SENTINEL).sum()) == 4
    np.testing.assert_array_equal(got[2][0, 1], [0, 1, 2, 3])  # window order


@pytest.mark.parametrize("variant", [2, 3, 4, 5])
def test_rebin_variant_no_row_edge_wrap(variant):
    """tests/test_rebin.py:363-389: an in-transit mover in the last column and
    the next row's first cell read each other through the flat shifts.  Every
    variant decides those lanes as JAX does; the lossless one neither
    duplicates nor drops the mover."""
    px, py, ids = _small_planes()
    # Cell (1, 3) full of stayers -> the mover below cannot be adopted in pass Y.
    px[1, 3], py[1, 3], ids[1, 3] = [35.0, 36.0, 37.0, 38.0], 15.0, [1.0, 2.0, 4.0, 5.0]
    px[0, 3, 0], py[0, 3, 0], ids[0, 3, 0] = 37.0, 17.0, 3.0  # resident (0,3), key (1,3)
    got, gc, want, wc = _run_both([px, py, ids], SMALL, variant, FILLS_IDS)
    _assert_same(got, gc, want, wc)
    live = got[0] < 0.5 * SENTINEL
    assert not live[1, 0].any()
    if variant == 5:
        np.testing.assert_array_equal(np.sort(got[2][live]), [1.0, 2.0, 3.0, 4.0, 5.0])
        assert live[0, 3, 0]


def test_rebin_v5_fast_particle_hops():
    """A particle keyed three cells away hops one cell per rebin and stays
    (tests/test_rebin.py:340-360), as in JAX."""
    px, py, ids = _small_planes()
    px[0, 0, 0], py[0, 0, 0], ids[0, 0, 0] = 35.0, 5.0, 7.0
    planes = [px, py, ids]
    for hop in range(1, 5):
        got, gc, want, wc = _run_both(planes, SMALL, 5, FILLS_IDS)
        _assert_same(got, gc, want, wc)
        live = got[0] < 0.5 * SENTINEL
        assert int(live.sum()) == 1 and tuple(np.argwhere(live)[0][:2]) == (0, min(hop, 3))
        planes = got


def test_hole_fill_pass_rejects_bad_inputs():
    spec = GridSpec(**GEOM, capacity=16)
    flats = [torch.full((22, 16), SENTINEL) for _ in range(2)]
    with pytest.raises(ValueError):  # rows past the grid
        hole_fill_pass(flats, spec, None, 11, True, True, row0=6)
    with pytest.raises(ValueError):  # one ghost pair per channel
        hole_fill_pass(flats, spec, None, 11, True, True, [(flats[0][:11], flats[0][:11])])
    with pytest.raises(ValueError):  # a filled slot must read as dead
        hole_fill_pass(flats, spec, (0.0, 0.0), 11, True, True)
