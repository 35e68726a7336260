"""Port vs JAX: the lossless rebin (K1's plain version) against the JAX variant-6
kernel (interpret mode) and the numpy oracle of tests/test_rebin.py.

Values only move in a rebin, so every comparison is bit-for-bit: planes and
counts.  Besides the oracle's random states this covers crowded cells,
>1-cell hops, the row-edge wrap, partial warps (C=40) and states with empty
mid-grid rows and rows turning from air to live.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rebin import _demo_planes, oracle_rebin_v5

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas.rebin import rebin_planes as jrebin
from rust_particle_system_tpu_torch.ops.cuda.rebin import SENTINEL, rebin_planes
from rust_particle_system_tpu_torch.ops.grid import GridSpec


def _run_both(planes, geom, fills=None):
    """(port planes, port counts, JAX planes, JAX counts) as numpy."""
    got, gc = rebin_planes([torch.from_numpy(np.array(p)) for p in planes],
                           GridSpec(**geom), fills=fills)
    want, wc = jrebin([jnp.asarray(p) for p in planes], JGridSpec(**geom),
                      fills=fills, variant=6)
    return ([g.numpy() for g in got], gc.numpy(),
            [np.asarray(w) for w in want], np.asarray(wc))


def _assert_same(got, gc, want, wc):
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"channel {c}")
    np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("capacity", [16, 40])
@pytest.mark.parametrize("drift", [0.4, 0.9, 1.8])
def test_rebin_matches_jax_v6_and_oracle(rng, drift, capacity):
    geom = dict(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=7, capacity=capacity)
    planes = [np.asarray(p) for p in
              _demo_planes(rng, JGridSpec(**geom), capacity, 0.7, drift, k=5)]
    got, gc, want, wc = _run_both(planes, geom)
    _assert_same(got, gc, want, wc)
    oracle, oc = oracle_rebin_v5(planes, JGridSpec(**geom))
    _assert_same(got, gc, oracle, oc)


def test_rebin_matches_jax_at_capacity_128(rng):
    geom = dict(x_min=-27.0, y_min=-18.0, cell_size=9.0, gw=7, gh=5, capacity=128)
    planes = [np.asarray(p) for p in _demo_planes(rng, JGridSpec(**geom), 128, 0.5, 0.9,
                                                  k=5)]
    _assert_same(*_run_both(planes, geom))


@pytest.mark.parametrize("drift", [0.4, 0.9, 1.8])
def test_rebin_air_rows(drift):
    """Rows 0, 3, 4, 5 of 9 start empty: row 4's whole window is air (the JAX
    kernel's skip branch) while rows 3 and 5 turn live from rows 2 and 6."""
    geom = dict(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=9, capacity=16)
    planes = [np.asarray(p).copy() for p in
              _demo_planes(np.random.default_rng(1), JGridSpec(**geom), 16, 0.7, drift,
                           k=5)]
    for r in (0, 3, 4, 5):
        planes[0][r] = planes[1][r] = SENTINEL
        for c in range(2, 5):
            planes[c][r] = 0.0
    got, gc, want, wc = _run_both(planes, geom)
    _assert_same(got, gc, want, wc)
    _assert_same(got, gc, *oracle_rebin_v5(planes, JGridSpec(**geom)))
    live = got[0] < 0.5 * SENTINEL
    assert live[3].any() and live[5].any() and not live[4].any()


def test_rebin_crowded_grid_never_drops():
    """The crowded grid of tests/test_rebin.py: every slot full, heavy movement,
    an ids channel with fill -1.  Bit-equal to JAX, and nothing lost or doubled."""
    geom = dict(x_min=0.0, y_min=0.0, cell_size=10.0, gw=4, gh=2, capacity=4)
    r = np.random.default_rng(3)
    px = np.zeros((2, 4, 4), np.float32)
    py = np.zeros((2, 4, 4), np.float32)
    ids = np.zeros((2, 4, 4), np.float32)
    nid = 0
    for cy in range(2):
        for cx in range(4):
            for s in range(4):
                px[cy, cx, s] = np.clip(cx * 10 + r.uniform(-8, 18), 0.1, 39.9)
                py[cy, cx, s] = np.clip(cy * 10 + r.uniform(-8, 18), 0.1, 19.9)
                ids[cy, cx, s] = float(nid)
                nid += 1
    fills = (SENTINEL, SENTINEL, -1.0)
    got, gc, want, wc = _run_both([px, py, ids], geom, fills)
    _assert_same(got, gc, want, wc)
    live = got[0] < 0.5 * SENTINEL
    np.testing.assert_array_equal(np.sort(got[2][live]), np.arange(nid, dtype=np.float32))
    assert int(gc.sum()) == nid


def test_rebin_fast_particle_hops_toward_destination():
    """A particle keyed four cells away hops one cell per rebin, as in JAX."""
    geom = dict(x_min=0.0, y_min=0.0, cell_size=10.0, gw=6, gh=1, capacity=4)
    px = np.full((1, 6, 4), SENTINEL, np.float32)
    py = np.full((1, 6, 4), SENTINEL, np.float32)
    px[0, 0, 0], py[0, 0, 0] = 45.0, 5.0
    planes = [px, py]
    for hop in range(1, 6):
        got, gc, want, wc = _run_both(planes, geom)
        _assert_same(got, gc, want, wc)
        live = got[0][0] < 0.5 * SENTINEL
        assert int(live.sum()) == 1
        assert int(np.argwhere(live)[0][0]) == min(hop, 4)
        planes = got


def test_rebin_no_row_edge_wrap():
    """An in-transit mover in the last column must not be adopted by the next
    row's first cell (the flat-shift wrap), nor dropped."""
    geom = dict(x_min=0.0, y_min=0.0, cell_size=10.0, gw=3, gh=2, capacity=2)
    px = np.full((2, 3, 2), SENTINEL, np.float32)
    py = np.full((2, 3, 2), SENTINEL, np.float32)
    ids = np.zeros((2, 3, 2), np.float32)
    px[1, 2], py[1, 2], ids[1, 2] = [25.0, 26.0], [15.0, 16.0], [1.0, 2.0]
    px[0, 2, 0], py[0, 2, 0], ids[0, 2, 0] = 27.0, 17.0, 3.0
    got, gc, want, wc = _run_both([px, py, ids], geom, (SENTINEL, SENTINEL, -1.0))
    _assert_same(got, gc, want, wc)
    live = got[0] < 0.5 * SENTINEL
    np.testing.assert_array_equal(np.sort(got[2][live]), [1.0, 2.0, 3.0])
    assert live[0, 2, 0] and not live[1, 0].any()


def test_rebin_rejects_other_variants_and_live_fills():
    spec = GridSpec(x_min=0.0, y_min=0.0, cell_size=10.0, gw=3, gh=2, capacity=2)
    planes = [torch.full((2, 3, 2), SENTINEL) for _ in range(2)]
    for variant in (1, 7):  # JAX's rebin_planes takes 2..6
        with pytest.raises(ValueError, match="variant"):
            rebin_planes(planes, spec, variant=variant)
    with pytest.raises(ValueError):
        rebin_planes(planes, spec, fills=(0.0, 0.0))
