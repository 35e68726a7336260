"""Port vs JAX: the density walk (K2's plain version) and the fused force walk
with the frame tail (K3's plain version), against the JAX Pallas walks in
interpret mode.

The last case runs the pair-packed layout (K6's plain version) against the JAX
pack2 walk.  Only the f32 summation order differs, so the bars are the JAX
tests' own: density rtol 1e-5 on live slots; positions rtol/atol 1e-4 and
velocities rtol 1e-4 / atol 1e-2 (tests/test_pallas_sph.py:38-40).  Deferred
and dead slots do not depend on the walk sums and must match exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rebin import _demo_planes

from rust_particle_system_tpu.core.params import make_params as jmake_params
from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas.sph import density_cells_pallas
from rust_particle_system_tpu.ops.pallas.sph_step import _forces_from_cells as jforces
from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.ops.cuda.sph import density_planes
from rust_particle_system_tpu_torch.ops.cuda.sph_step import _forces_from_cells
from rust_particle_system_tpu_torch.ops.grid import GridSpec

SENTINEL = 1e6
GEOMS = {
    16: ((-90.0, 90.0, -45.0, 45.0), 0.5),  # gw=21, gh=11
    128: ((-27.0, 27.0, -18.0, 18.0), 0.3),  # gw=7, gh=5
}


def _state(rng, capacity, drift=0.4, coincident=False):
    """Planes (px, py, vx, vy) with dead slots; ``drift`` puts some particles
    outside their resident cell, which the defer mask then parks."""
    bounds, fill = GEOMS[capacity]
    js = JGridSpec.from_bounds(bounds, 9.0, capacity)
    ts = GridSpec.from_bounds(bounds, 9.0, capacity)
    px, py = (np.asarray(p).copy() for p in _demo_planes(rng, js, capacity, fill, drift,
                                                          k=2))
    if coincident:  # four particles on one point, plus a pair 1e-5 apart
        px[3, 4, :4], py[3, 4, :4] = -50.0, -13.0
        px[3, 4, 4], py[3, 4, 4] = -50.0 + 1e-5, -13.0
    live = px < 0.5 * SENTINEL
    vx = np.where(live, rng.standard_normal(px.shape) * 20, 0).astype(np.float32)
    vy = np.where(live, rng.standard_normal(px.shape) * 20, 0).astype(np.float32)
    return js, ts, bounds, px, py, vx, vy


@functools.lru_cache(maxsize=None)
def _jax_forces(spec):
    """The JAX fused walk for ``spec``, jitted once so that interpret mode
    compiles one program per geometry instead of running op by op."""
    return jax.jit(lambda px, py, vx, vy, params, integ: jforces(
        px, py, vx, vy, spec, params, True, integrate_planes=integ))


def _defer(spec, px, py):
    kx = np.clip(np.floor((px - spec.x_min) / spec.cell_width).astype(int), 0, spec.gw - 1)
    ky = np.clip(np.floor((py - spec.y_min) / spec.cell_size).astype(int), 0, spec.gh - 1)
    own = (kx == np.arange(spec.gw)[None, :, None]) & (ky == np.arange(spec.gh)[:, None, None])
    return (px < 0.5 * SENTINEL) & ~own


@pytest.mark.parametrize("capacity", [16, 128])
def test_density_matches_jax(rng, capacity):
    js, ts, bounds, px, py, _, _ = _state(rng, capacity)
    px[_defer(js, px, py)] = SENTINEL  # walk positions: deferred slots parked
    py[px >= 0.5 * SENTINEL] = SENTINEL
    live = px < 0.5 * SENTINEL
    want = density_cells_pallas(jnp.asarray(px), jnp.asarray(py), spec=js,
                                params=jmake_params(bounds=bounds))
    got = density_planes(torch.from_numpy(px), torch.from_numpy(py),
                         make_params(bounds=bounds))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], rtol=1e-5, atol=0)
        assert np.all(g.numpy()[~live] == 0.0)


@pytest.mark.parametrize("capacity,coincident", [(16, False), (16, True), (128, False)])
def test_force_walk_with_tail_matches_jax(rng, capacity, coincident):
    js, ts, bounds, npx, npy, vx, vy = _state(rng, capacity, coincident=coincident)
    defer = _defer(js, npx, npy)
    assert defer.sum() > 10
    fpx = np.where(defer, SENTINEL, npx).astype(np.float32)
    fpy = np.where(defer, SENTINEL, npy).astype(np.float32)
    jp = jmake_params(bounds=bounds, gravity=300.0)
    want = _jax_forces(js)(*(jnp.asarray(a) for a in (fpx, fpy, vx, vy)), jp,
                           (jnp.asarray(npx), jnp.asarray(npy)))
    got = _forces_from_cells(*(torch.from_numpy(a) for a in (fpx, fpy, vx, vy, npx, npy)),
                             ts, make_params(bounds=bounds, gravity=300.0))
    live = npx < 0.5 * SENTINEL
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert np.all(np.isfinite(g))
        atol = 1e-4 if i < 2 else 1e-2
        np.testing.assert_allclose(g[live], w[live], rtol=1e-4, atol=atol)
        np.testing.assert_array_equal(g[~live | defer], w[~live | defer])


def test_pack2_force_walk_matches_jax_at_c16(rng):
    """The pair-packed walk (K6's plain version) at C=16 on an odd-width grid
    (gw=21: the last pair holds a phantom cell) against the JAX pack2 walk."""
    js, ts, bounds, npx, npy, vx, vy = _state(rng, 16)
    js = dataclasses.replace(js, pack2=True)
    ts = dataclasses.replace(ts, pack2=True)
    assert ts.gw % 2 == 1
    defer = _defer(js, npx, npy)
    fpx = np.where(defer, SENTINEL, npx).astype(np.float32)
    fpy = np.where(defer, SENTINEL, npy).astype(np.float32)
    jp = jmake_params(bounds=bounds, gravity=300.0)
    want = _jax_forces(js)(*(jnp.asarray(a) for a in (fpx, fpy, vx, vy)), jp,
                           (jnp.asarray(npx), jnp.asarray(npy)))
    got = _forces_from_cells(*(torch.from_numpy(a) for a in (fpx, fpy, vx, vy, npx, npy)),
                             ts, make_params(bounds=bounds, gravity=300.0))
    live = npx < 0.5 * SENTINEL
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[live], w[live], rtol=1e-4, atol=1e-4 if i < 2 else 1e-2)
        np.testing.assert_array_equal(g[~live | defer], w[~live | defer])
