"""Port vs JAX: grid build, plane build (K5's plain version), init spill, round trip.

The same numpy positions go through the JAX package (Pallas in interpret mode
on the CPU) and the PyTorch port on the CPU (its plain versions).  Everything
here is integer bookkeeping and value moves, so the bar is bit-equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.core.state import make_state as jmake_state
from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.grid import build_grid as jbuild_grid
from rust_particle_system_tpu.ops.pallas.plane_build import cell_planes_aos as jcell_planes
from rust_particle_system_tpu.ops.pallas.resident import (
    plane_state_from_particles as jplane_state,
    to_particle_state as jto_particle_state,
)
from rust_particle_system_tpu_torch.core.state import make_state
from rust_particle_system_tpu_torch.ops.cuda.plane_build import cell_planes_aos
from rust_particle_system_tpu_torch.ops.cuda.resident import (
    plane_state_from_particles,
    to_particle_state,
)
from rust_particle_system_tpu_torch.ops.grid import GridSpec, build_grid

BOUNDS = (-90.0, 90.0, -45.0, 45.0)  # gw=21, gh=11 at cell 9
TINY = (-27.0, 27.0, -18.0, 18.0)  # gw=7, gh=5: C=128 stays cheap
PLANES = ("px", "py", "vx", "vy", "idsf")


def _positions(rng, n, bounds, y_std_frac=0.125):
    """Reference-like scatter (uniform x, clipped normal y) plus points exactly
    on cell edges, so the keying's floor is exercised at its boundaries."""
    x_min, x_max, y_min, y_max = bounds
    x = rng.uniform(x_min, x_max, n)
    y = np.clip(rng.normal(0.5 * (y_min + y_max), (y_max - y_min) * y_std_frac, n),
                y_min, y_max)
    edges = np.arange(x_min, x_max, 9.0)[: n // 4]
    x[: len(edges)] = edges
    y[n - len(edges):] = np.resize(np.arange(y_min, y_max, 9.0), len(edges))
    return np.stack([x, y], -1).astype(np.float32)


def _specs(bounds, capacity):
    return (JGridSpec.from_bounds(bounds, 9.0, capacity),
            GridSpec.from_bounds(bounds, 9.0, capacity))


@pytest.mark.parametrize("bounds,n,capacity",
                         [(BOUNDS, 512, 16), (BOUNDS, 3000, 16), (TINY, 700, 128)])
def test_build_grid_matches_jax(rng, bounds, n, capacity):
    js, ts = _specs(bounds, capacity)
    pos = _positions(rng, n, bounds)
    jg = jbuild_grid(js, jnp.asarray(pos), with_table=False)
    tg = build_grid(ts, torch.from_numpy(pos))
    for f in ("perm", "sorted_keys", "starts", "slot"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)
    assert int(tg.overflow) == int(jg.overflow)


def test_cell_planes_plain_matches_jax_kernel(rng):
    """K5's plain version vs the Pallas roll kernel: full, partial, empty and
    over-capacity cells, k=3 channels with distinct fills."""
    nc, C, k = 40, 16, 3
    counts = rng.integers(0, 2 * C, nc)
    counts[:3] = [0, C, C + 5]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rows = rng.standard_normal((int(starts[-1]), k)).astype(np.float32)
    fills = (1e6, -1.0, 0.0)
    want = jcell_planes(jnp.asarray(rows), jnp.asarray(starts), nc, C, fills, True)
    got = cell_planes_aos(torch.from_numpy(rows), torch.from_numpy(starts), nc, C, fills)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bounds,n,capacity",
                         [(BOUNDS, 512, 16), (BOUNDS, 3000, 16), (TINY, 700, 128)])
def test_plane_state_from_particles_matches_jax(rng, bounds, n, capacity):
    """Planes and ``lost`` bit-equal; n=3000 at C=16 packs the centre rows solid,
    so the spill runs and some rows stay lost (the same ones in both)."""
    js, ts = _specs(bounds, capacity)
    pos = _positions(rng, n, bounds)
    vel = rng.standard_normal((n, 2)).astype(np.float32)
    jps = jplane_state(jmake_state(jnp.asarray(pos), jnp.asarray(vel)).with_ids(), js)
    tps = plane_state_from_particles(make_state(pos, vel).with_ids(), ts)
    for f in PLANES:
        np.testing.assert_array_equal(getattr(tps, f).numpy(), np.asarray(getattr(jps, f)),
                                      err_msg=f)
    lost = int(jps.lost)
    assert int(tps.lost) == lost and (lost > 0) == (n == 3000)
    assert tps.n == n and int(tps.live.sum()) == n - lost


def test_init_overflow_spills_to_neighbor_losslessly(rng):
    """The spill case of tests/test_rebin.py: 20 particles in one 16-slot cell
    spill into its ring, bit-equal to JAX; without the spill 4 are lost."""
    js = JGridSpec(x_min=0.0, y_min=0.0, cell_size=9.0, gw=9, gh=9, capacity=16)
    ts = GridSpec(x_min=0.0, y_min=0.0, cell_size=9.0, gw=9, gh=9, capacity=16)
    n = 20
    pos = np.stack([40.5 + rng.uniform(-2, 2, n), 40.5 + rng.uniform(-2, 2, n)],
                   -1).astype(np.float32)
    jps = jplane_state(jmake_state(jnp.asarray(pos)).with_ids(), js)
    tps = plane_state_from_particles(make_state(pos).with_ids(), ts)
    for f in PLANES:
        np.testing.assert_array_equal(getattr(tps, f).numpy(), np.asarray(getattr(jps, f)),
                                      err_msg=f)
    assert int(tps.lost) == 0
    live = tps.live.numpy()
    cnt = live.sum(-1)
    assert cnt[4, 4] == 16 and cnt[3:6, 3:6].sum() - cnt[4, 4] == 4
    assert int(build_grid(ts, torch.from_numpy(pos)).overflow) == 4  # lost unspilled


def test_init_overflow_with_packed_neighborhood_reports_lost():
    """A packed-solid 5x5 neighbourhood cannot take the spill: 3 lost, as JAX."""
    js = JGridSpec(x_min=0.0, y_min=0.0, cell_size=9.0, gw=9, gh=9, capacity=8)
    ts = GridSpec(x_min=0.0, y_min=0.0, cell_size=9.0, gw=9, gh=9, capacity=8)
    pts = []
    for cy in range(2, 7):
        for cx in range(2, 7):
            extra = 3 if (cy, cx) == (4, 4) else 0
            for s in range(8 + extra):
                pts.append([cx * 9.0 + 1.0 + 0.5 * s, cy * 9.0 + 4.5])
    pos = np.asarray(pts, np.float32)
    jps = jplane_state(jmake_state(jnp.asarray(pos)).with_ids(), js)
    tps = plane_state_from_particles(make_state(pos).with_ids(), ts)
    assert int(tps.lost) == int(jps.lost) == 3
    for f in PLANES:
        np.testing.assert_array_equal(getattr(tps, f).numpy(), np.asarray(getattr(jps, f)))


def test_to_particle_state_round_trip(rng):
    """Planes -> id-ordered rows restores the input exactly, and equals JAX."""
    js, ts = _specs(BOUNDS, 16)
    pos = _positions(rng, 600, BOUNDS)
    vel = rng.standard_normal((600, 2)).astype(np.float32)
    tps = plane_state_from_particles(make_state(pos, vel).with_ids(), ts)
    back = to_particle_state(tps)
    np.testing.assert_array_equal(back.ids.numpy(), np.arange(600))
    np.testing.assert_array_equal(back.pos.numpy(), pos)
    np.testing.assert_array_equal(back.vel.numpy(), vel)
    np.testing.assert_array_equal(back.color.numpy(), 1.0)
    jps = jplane_state(jmake_state(jnp.asarray(pos), jnp.asarray(vel)).with_ids(), js)
    jback = jto_particle_state(jps)
    np.testing.assert_array_equal(back.pos.numpy(), np.asarray(jback.pos))
    np.testing.assert_array_equal(back.ids.numpy(), np.asarray(jback.ids))
