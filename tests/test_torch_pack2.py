"""Port vs JAX: the pair-packed layout (pack2, kernel K6's plain version).

The plain walks read the pair window the JAX pack2 walk reads (B[p] and
B[p+1]: cells 2p-1 .. 2p+2, rows r-1 .. r+1), whose extra column contributes
exact zeros, and are held against the JAX pack2 walks in interpret mode at
the JAX tests' own bars: density rtol 1e-5, positions rtol/atol 1e-4,
velocities rtol 1e-4 / atol 1e-2 (tests/test_pallas_sph.py:38-40); deferred
and dead slots do not depend on the walk sums and must match bit for bit.
Steps are held at the pack2 step bars, positions rtol 1e-4 / atol 1e-3 and
velocities rtol 1e-3 / atol 1e-2 (tests/test_pallas_sph.py:99-100).
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
from rust_particle_system_tpu.core.state import make_state as jmake_state
from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas import resident as JR
from rust_particle_system_tpu.ops.pallas.sph import (_own_plane, _pack_a, _pack_b,
                                                      plane_geometry, unpack_pairs)
from rust_particle_system_tpu.ops.pallas.sph import density_planes as jdensity_planes
from rust_particle_system_tpu.ops.pallas.sph_step import _forces_from_cells as jforces
from rust_particle_system_tpu_torch import interop
from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.core.state import make_state
from rust_particle_system_tpu_torch.models.sph import SPHFluid
from rust_particle_system_tpu_torch.ops.cuda import resident as R
from rust_particle_system_tpu_torch.ops.cuda.sph import density_pairs
from rust_particle_system_tpu_torch.ops.cuda.sph_step import (_forces_from_cells,
                                                              _velocities_from_cells)
from rust_particle_system_tpu_torch.ops.grid import GridSpec

SENTINEL = 1e6
# name: (bounds, capacity, cell = smoothing radius, fill fraction)
GEOMS = {
    "c64": ((-36.0, 27.0, -18.0, 18.0), 64, 9.0, 0.3),  # gw=8, gh=5
    "c32": ((-45.0, 36.0, -27.0, 27.0), 32, 9.0, 0.4),  # gw=10: pad lanes in JAX
    "odd": ((-95.0, 95.0, -50.0, 50.0), 64, 9.5, 0.06),  # gw=21, gh=11
}


def _params(geom, jax_side=False, gravity=300.0):
    bounds, _, h, _ = GEOMS[geom]
    make = jmake_params if jax_side else make_params
    return make(bounds=bounds, gravity=gravity, smoothing_radius=h)


def _specs(geom):
    bounds, cap, h, _ = GEOMS[geom]
    return (JGridSpec.from_bounds(bounds, h, cap, pack2=True),
            GridSpec.from_bounds(bounds, h, cap, pack2=True))


def _defer(spec, px, py):
    kx = np.clip(np.floor((px - spec.x_min) / spec.cell_width).astype(int), 0, spec.gw - 1)
    ky = np.clip(np.floor((py - spec.y_min) / spec.cell_size).astype(int), 0, spec.gh - 1)
    own = (kx == np.arange(spec.gw)[None, :, None]) & (ky == np.arange(spec.gh)[:, None, None])
    return (px < 0.5 * SENTINEL) & ~own


def _state(rng, geom, coincident=False):
    """Planes (true px, py, walk fpx, fpy, vx, vy) with dead slots and
    deferred ones (particles drifted out of their resident cell)."""
    js, ts = _specs(geom)
    _, cap, _, fill = GEOMS[geom]
    px, py = (np.asarray(p).copy() for p in _demo_planes(rng, js, cap, fill, 0.4, k=2))
    if coincident:  # four particles on one point, plus a pair 1e-5 apart
        x0 = js.x_min + 3.5 * js.cell_width
        y0 = js.y_min + 2.5 * js.cell_size
        px[2, 3, :4], py[2, 3, :4] = x0, y0
        px[2, 3, 4], py[2, 3, 4] = x0 + 1e-5, y0
    live = px < 0.5 * SENTINEL
    vx = np.where(live, rng.standard_normal(px.shape) * 20, 0).astype(np.float32)
    vy = np.where(live, rng.standard_normal(px.shape) * 20, 0).astype(np.float32)
    defer = _defer(js, px, py)
    fpx = np.where(defer, SENTINEL, px).astype(np.float32)
    fpy = np.where(defer, SENTINEL, py).astype(np.float32)
    return js, ts, px, py, fpx, fpy, vx, vy, defer


@functools.lru_cache(maxsize=None)
def _jax_walks(spec):
    """The JAX pack2 walks for ``spec``, jitted once per geometry (interpret
    mode): density, the fused walk with the tail, and the unfused walk."""
    gh, gw, C = spec.gh, spec.gw, spec.capacity
    np2 = (gw + 1) // 2
    cp, _, wt2 = plane_geometry(np2, 2 * C)

    def density(px, py, params):
        # The B-unit halo planes and A-unit own planes of sph_step.py:99-128.
        def bplane(x):
            b = _pack_b(x, SENTINEL)
            out = jnp.full((gh + 2, wt2 + 2, cp), SENTINEL, jnp.float32)
            return out.at[1: gh + 1, 1: np2 + 2, : b.shape[-1]].set(b)

        def aplane(x):
            return _own_plane(_pack_a(x, SENTINEL), gh, np2, wt2, SENTINEL, cp)

        rho, rhon = jdensity_planes(bplane(px), bplane(py), params, True,
                                    own_planes=[aplane(px), aplane(py)], n_dx=2)
        return unpack_pairs(rho, gw, C), unpack_pairs(rhon, gw, C)

    fused = jax.jit(lambda px, py, vx, vy, params, integ: jforces(
        px, py, vx, vy, spec, params, True, integrate_planes=integ))
    raw = jax.jit(lambda px, py, vx, vy, params: jforces(
        px, py, vx, vy, spec, params, True))
    return jax.jit(density), fused, raw


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("geom", ["c64", "c32", "odd"])
def test_pack2_density_matches_jax(rng, geom):
    js, ts, _, _, fpx, fpy, _, _, _ = _state(rng, geom)
    walk_live = fpx < 0.5 * SENTINEL
    want = _jax_walks(js)[0](jnp.asarray(fpx), jnp.asarray(fpy), _params(geom, True))
    got = density_pairs(*_t(fpx, fpy), _params(geom))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[walk_live], np.asarray(w)[walk_live],
                                   rtol=1e-5, atol=0)
        assert np.all(g.numpy()[~walk_live] == 0.0)


@pytest.mark.parametrize("geom,coincident", [("c64", False), ("c64", True),
                                             ("c32", False), ("odd", False)])
def test_pack2_force_walk_with_tail_matches_jax(rng, geom, coincident):
    js, ts, px, py, fpx, fpy, vx, vy, defer = _state(rng, geom, coincident)
    assert defer.sum() > 5
    want = _jax_walks(js)[1](*(jnp.asarray(a) for a in (fpx, fpy, vx, vy)),
                             _params(geom, True), (jnp.asarray(px), jnp.asarray(py)))
    got = _forces_from_cells(*_t(fpx, fpy, vx, vy, px, py), ts, _params(geom))
    live = px < 0.5 * SENTINEL
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert np.all(np.isfinite(g))
        atol = 1e-4 if i < 2 else 1e-2
        np.testing.assert_allclose(g[live], w[live], rtol=1e-4, atol=atol)
        np.testing.assert_array_equal(g[~live | defer], w[~live | defer])


@pytest.mark.parametrize("geom", ["c64", "c32", "odd"])
def test_pack2_raw_force_walk_matches_jax(rng, geom):
    """The unfused walk (K6's raw sums) through the velocity update it feeds,
    on walk-live slots (elsewhere the values are meaningless in both)."""
    js, ts, _, _, fpx, fpy, vx, vy, _ = _state(rng, geom)
    want = _jax_walks(js)[2](*(jnp.asarray(a) for a in (fpx, fpy, vx, vy)),
                             _params(geom, True))
    got = _velocities_from_cells(*_t(fpx, fpy, vx, vy), ts, _params(geom))
    walk_live = fpx < 0.5 * SENTINEL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[walk_live], np.asarray(w)[walk_live],
                                   rtol=1e-4, atol=1e-2)


def _uniform(rng, n, bounds):
    x_min, x_max, y_min, y_max = bounds
    return np.stack([rng.uniform(x_min, x_max, n), rng.uniform(y_min, y_max, n)],
                    -1).astype(np.float32)


def _by_id(ps):
    s = ps.to_particle_state()
    order = np.argsort(np.asarray(s.ids))
    return np.asarray(s.pos)[order], np.asarray(s.vel)[order], np.asarray(s.ids)[order]


@pytest.mark.parametrize("geom", ["c64", "odd"])
def test_pack2_plane_steps_match_jax_on_carried_state(rng, geom):
    """Three live frames of a pack2 SPHFluid(device="cpu"), each started from
    the JAX state of the frame before (carried across as numpy)."""
    bounds, cap, h, _ = GEOMS[geom]
    js, _ = _specs(geom)
    model = SPHFluid.create(n=300, bounds=bounds, cell_size=h, capacity=cap, pack2=True,
                            device="cpu")
    assert model.grid.pack2 and model.grid.capacity == cap
    jp, tp = _params(geom, True), _params(geom)
    jps = JR.plane_state_from_particles(
        jmake_state(jnp.asarray(_uniform(rng, 300, bounds))).with_ids(), js)
    jps = dataclasses.replace(jps, frame=jnp.asarray(5, jnp.int32))
    step = jax.jit(lambda s: JR.plane_step(s, jp, js))
    for _ in range(3):
        tps = interop.plane_state_from_numpy(
            {f"state/{k}": np.asarray(getattr(jps, k))
             for k in ("px", "py", "vx", "vy", "idsf", "frame", "lost")}, device="cpu")
        jps, tps = step(jps), model.step(tps, tp)
        jpos, jvel, jids = _by_id(jps)
        tpos, tvel, tids = _by_id(tps)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tpos, jpos, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(tvel, jvel, rtol=1e-3, atol=1e-2)
        assert int(tps.lost) == int(jps.lost) == 0
        assert int(tps.live.sum()) == 300


def test_pack2_step_matches_classic_c64(rng):
    """The port's pack2 frame against its classic C=64 frame from the same
    state, frame by frame: the same rebin (slots equal), walks that differ by
    exact zeros and summation order."""
    bounds = GEOMS["c64"][0]
    classic = GridSpec.from_bounds(bounds, 9.0, 64)
    packed = GridSpec.from_bounds(bounds, 9.0, 64, pack2=True)
    tp = make_params(bounds=bounds, gravity=300.0, shader_delay=0)
    ps = R.plane_state_from_particles(make_state(_uniform(rng, 400, bounds)).with_ids(),
                                      packed)
    for _ in range(4):
        a, b = R.plane_step(ps, tp, classic), R.plane_step(ps, tp, packed)
        live = b.live
        assert torch.equal(a.live, live) and torch.equal(a.idsf, b.idsf)
        for f, tol in (("px", dict(rtol=1e-4, atol=1e-3)), ("py", dict(rtol=1e-4, atol=1e-3)),
                       ("vx", dict(rtol=1e-3, atol=1e-2)), ("vy", dict(rtol=1e-3, atol=1e-2))):
            np.testing.assert_allclose(getattr(b, f)[live].numpy(),
                                       getattr(a, f)[live].numpy(), **tol, err_msg=f)
            assert torch.equal(getattr(a, f)[~live], getattr(b, f)[~live])
        assert int(b.lost) == 0 and int(live.sum()) == 400
        ps = b


def test_sph_create_routes_the_layout():
    """capacity=None is the settle-safe classic C=128 (pack2 ignored);
    capacity=64, pack2=True the pair-packed layout; pack2 refuses C > 64."""
    m = SPHFluid.create(pack2=True, device="cpu")
    assert (m.grid.capacity, m.grid.pack2) == (128, False)
    m = SPHFluid.create(capacity=64, pack2=True, device="cpu")
    assert (m.grid.capacity, m.grid.pack2) == (64, True)
    assert not SPHFluid.create(capacity=64, device="cpu").grid.pack2
    with pytest.raises(ValueError, match="capacity <= 64"):
        SPHFluid.create(capacity=128, pack2=True, device="cpu")
