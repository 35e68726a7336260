"""Port vs JAX: the band-sharded plane step in spawned gloo worlds on the CPU.

Mirrors tests/test_plane_sharded.py.  Each world is ``run_bands`` with one
process per band (``device="cpu"``, the plain versions); the ranks run
:func:`_drive`, which imports only the port, and check that jax never got
into their process.  JAX runs here, in the pytest process, on the 8 virtual
CPU devices of conftest.py; this module imports jax only inside the
functions that run it, because every rank imports this module.

Bars: the JAX sharded test's own, pos atol 2e-4 and vel atol 2e-3 after 4
frames (the walks sum in another order; tests/test_plane_sharded.py:75-78),
and atol 2.5e-2 on the sharded frame's image (:208-209).  Conservation is
exact.  Each world has a deadline (WORLD_S): a hang fails its test.
"""

import dataclasses
import multiprocessing
import sys
import time

import numpy as np
import pytest
import torch

from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.core.state import scatter_init
from rust_particle_system_tpu_torch.ops.cuda import resident as R
from rust_particle_system_tpu_torch.ops.cuda.rebin import SENTINEL, rebin_planes, walk_positions
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.parallel import (check_plane_diags, gather_plane_state,
                                                    make_plane_sharded_frame,
                                                    make_plane_sharded_step, run_bands,
                                                    shard_plane_state)
from rust_particle_system_tpu_torch.render import RenderSpec

BOUNDS = (-54.0, 54.0, -36.0, 36.0)  # 12 x 8 cells of 9.0
CHANNELS = ("px", "py", "vx", "vy", "idsf")
WORLD_S = 90.0


def _drive(mesh, planes, frame, n, spec, params, frames, fuse_tail=True, render=None,
           expect=None, rebin_variant=6):
    """One rank: shard the whole state, run ``frames`` sharded steps (then one
    sharded frame with its image if ``render`` = (RenderSpec, bounds)),
    checking the diagnostics after each; gather.  Returns the diagnostics and,
    on band 0, the whole planes and the image."""
    assert "jax" not in sys.modules, "a rank imported jax"
    ps = R.PlaneState(*(torch.from_numpy(p) for p in planes), frame=frame,
                      lost=torch.zeros((), dtype=torch.int32), n=n)
    slab = shard_plane_state(ps, mesh)
    step = make_plane_sharded_step(spec, mesh, rebin_variant, fuse_tail)
    diags, image = [], None
    for _ in range(frames):
        slab, d = step(slab, params)
        diags.append(check_plane_diags(d, expect))
    if render is not None:
        slab, image, d = make_plane_sharded_frame(spec, mesh, *render, rebin_variant,
                                                  fuse_tail)(slab, params)
        diags.append(check_plane_diags(d, expect))
    whole = gather_plane_state(slab, mesh)
    if mesh.rank:
        return {"diags": diags}
    return {"diags": diags, "frame": whole.frame, "lost": int(whole.lost),
            "planes": [getattr(whole, f).numpy() for f in CHANNELS],
            "image": None if image is None else image.numpy()}


def _world(n_bands, *args):
    """Rank 0's result of :func:`_drive` with ``args``, after checking that
    every band saw the same diagnostics."""
    out = run_bands(_drive, n_bands, backend="gloo", device="cpu", timeout=WORLD_S,
                    args=args)
    assert all(o["diags"] == out[0]["diags"] for o in out)
    return out[0]


def _spec(gh=8, capacity=16, pack2=False):
    return dict(x_min=BOUNDS[0], y_min=BOUNDS[2], cell_size=9.0, gw=13, gh=gh,
                capacity=capacity, pack2=pack2)


def _jax_setup(rng, n=320, vmax=30.0, pack2=False):
    """tests/test_plane_sharded.py::_setup: the JAX spec, params and initial
    PlaneState, from numpy positions and velocities."""
    import jax.numpy as jnp

    from rust_particle_system_tpu.core.params import make_params as jmake_params
    from rust_particle_system_tpu.core.state import make_state as jmake_state
    from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
    from rust_particle_system_tpu.ops.pallas.resident import plane_state_from_particles

    spec = JGridSpec(**_spec(pack2=pack2))
    pos = np.stack([rng.uniform(BOUNDS[0], BOUNDS[1] - 1e-3, n),
                    rng.uniform(BOUNDS[2], BOUNDS[3] - 1e-3, n)], axis=-1).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    ps = plane_state_from_particles(jmake_state(jnp.asarray(pos), jnp.asarray(vel))
                                    .with_ids(), spec)
    assert int(ps.lost) == 0
    return spec, jmake_params(bounds=BOUNDS, gravity=120.0, shader_delay=0), ps


def _jax_sharded(spec, params, ps, n_bands, frames, rebin_variant=6):
    """JAX make_plane_sharded_step on the virtual CPU mesh, as particles."""
    import jax

    from rust_particle_system_tpu.ops.pallas.resident import to_particle_state
    from rust_particle_system_tpu.parallel import make_band_mesh
    from rust_particle_system_tpu.parallel.plane_sharded import (
        check_plane_diags as jcheck, make_plane_sharded_step as jstep,
        shard_plane_state as jshard)

    mesh = make_band_mesh(n_bands)
    step = jstep(spec, mesh, rebin_variant=rebin_variant)
    sharded = jshard(ps, mesh)
    for _ in range(frames):
        sharded, diags = step(sharded, params)
        jax.block_until_ready(sharded.px)  # CPU-mesh rendezvous guard
        jcheck(diags)
    return to_particle_state(sharded, params)


def _by_id(pos, vel, ids):
    order = np.argsort(np.asarray(ids))
    return np.asarray(pos)[order], np.asarray(vel)[order], np.asarray(ids)[order]


def _port_particles(out, n, params):
    ps = R.PlaneState(*(torch.from_numpy(p) for p in out["planes"]), frame=out["frame"],
                      lost=torch.zeros((), dtype=torch.int32), n=n)
    return ps, R.to_particle_state(ps, params)


def _initial(jps):
    return [np.array(getattr(jps, f)) for f in CHANNELS]


@pytest.mark.parametrize("n_bands,fuse_tail,pack2", [
    (2, True, False),
    (4, False, False),  # the raw walk (K3b's plain version) and the torch tail
    # 8 bands over gh=8 rows: R = 1, the rebin's row0-2 ghost comes from two
    # bands down by a second hop.
    (8, True, False),
    (4, True, True),  # the pair-packed walks (K6's plain version)
])
def test_sharded_step_matches_jax_sharded(rng, n_bands, fuse_tail, pack2):
    jspec, jparams, jps = _jax_setup(rng, pack2=pack2)
    spec, params = GridSpec(**_spec(pack2=pack2)), make_params(bounds=BOUNDS, gravity=120.0,
                                                               shader_delay=0)
    n = int(jps.n)
    out = _world(n_bands, _initial(jps), int(jps.frame), n, spec, params, 4, fuse_tail,
                 None, n)
    want = _jax_sharded(jspec, jparams, jps, n_bands, 4)
    ps, got = _port_particles(out, n, params)
    assert int(ps.live.sum()) == n
    gp, gv, gi = _by_id(got.pos, got.vel, got.ids)
    wp, wv, wi = _by_id(want.pos, want.vel, want.ids)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=2e-4)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=2e-3)


@pytest.mark.parametrize("n_bands,fuse_tail", [(4, True), (2, False)])
def test_sharded_step_v5_matches_jax_sharded(rng, n_bands, fuse_tail):
    """Rebin variant 5: K9's pass Y with ghost rows, the adoption returned
    across band boundaries, pass X; against JAX's sharded step at variant 5
    (chip_smoke.py holds it to the single-device step bit for bit on the
    card)."""
    jspec, jparams, jps = _jax_setup(rng)
    spec = GridSpec(**_spec())
    params = make_params(bounds=BOUNDS, gravity=120.0, shader_delay=0)
    n = int(jps.n)
    out = _world(n_bands, _initial(jps), int(jps.frame), n, spec, params, 4, fuse_tail,
                 None, n, 5)
    want = _jax_sharded(jspec, jparams, jps, n_bands, 4, rebin_variant=5)
    ps, got = _port_particles(out, n, params)
    assert int(ps.live.sum()) == n
    gp, gv, gi = _by_id(got.pos, got.vel, got.ids)
    wp, wv, wi = _by_id(want.pos, want.vel, want.ids)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=2e-4)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=2e-3)


def test_sharded_step_conserves_across_band_transit(rng):
    """Fast downward flow (gravity 400, |v| up to 60): particles cross band
    boundaries every few frames; the live count stays exact on every band."""
    jspec, _, jps = _jax_setup(rng, n=200, vmax=60.0)
    n_live = int(np.asarray(jps.live).sum())
    params = make_params(bounds=BOUNDS, gravity=400.0, shader_delay=0)
    out = _world(4, _initial(jps), 0, int(jps.n), GridSpec(**_spec()), params, 8, True,
                 None, n_live)
    assert [d["live_after"] for d in out["diags"]] == [n_live] * 8


def _empty_planes(spec):
    return [np.full((spec.gh, spec.gw, spec.capacity), f, np.float32)
            for f in (1e6, 1e6, 0.0, 0.0, 0.0)]


def test_sharded_step_band_crossing_changes_owner():
    """A particle in band 0's top row moving up ~0.9 rows per frame ends up
    resident in band 1's rows."""
    spec = GridSpec(**_spec())
    params = make_params(bounds=BOUNDS, gravity=0.0, shader_delay=0)
    planes = _empty_planes(spec)
    for c, v in enumerate((BOUNDS[0] + 5.5 * 9.0 + 4.0, BOUNDS[2] + 3.5 * 9.0, 0.0,
                           9.0 / params.dt * 0.9, 7.0)):
        planes[c][3, 5, 0] = v
    out = _world(2, planes, 10, 1, spec, params, 3, True, None, 1)
    rows = np.argwhere(out["planes"][0] < 5e5)[:, 0]
    assert len(rows) == 1 and rows[0] >= 4, f"expected band-1 rows, got {rows}"


def test_sharded_step_crowded_boundary_defers_then_delivers(rebin_variant=6):
    """tests/test_plane_sharded.py:129-190 (v6): a full edge cell of band 0
    whose 16 occupants slide right one cell per frame, and a mover in band 1's
    bottom row falling into it.  Frame 1: the mover finds no hole and is
    retained in band 1 (deferred >= 1); frame 2: it crosses into band 0."""
    capacity = 16
    spec = GridSpec(**_spec(gh=4, capacity=capacity))
    params = make_params(bounds=(-54.0, 63.0, -36.0, 0.0), gravity=0.0, shader_delay=0,
                         pressure_multiplier=0.0, viscosity_strength=0.0,
                         near_density_multiplier=0.0)
    dt = params.dt
    planes = _empty_planes(spec)
    for s in range(capacity):
        for c, v in enumerate((-9.0 + (s + 0.5) * (9.0 / capacity), -22.5, 9.0 / dt, 0.0,
                               float(s))):
            planes[c][1, 5, s] = v
    for c, v in enumerate((-5.0, -14.0, 0.0, -9.0 / dt, 99.0)):
        planes[c][2, 5, 0] = v
    out = _world(2, planes, 10, capacity + 1, spec, params, 2, True, None, capacity + 1,
                 rebin_variant)
    deferred = [d["deferred"] for d in out["diags"]]
    assert deferred[0] >= 1, f"mover was not deferred at the full cell: {deferred}"
    px, idsf = out["planes"][0], out["planes"][4]
    rows = np.argwhere((px < 5e5) & (idsf == 99.0))
    assert len(rows) == 1 and rows[0][0] < 2, (
        f"mover not delivered into band 0: slots {rows}, deferred {deferred}")


def test_sharded_step_crowded_boundary_v5():
    """The same at rebin variant 5: the mover's adoption is refused in band 0's
    pass Y, so no acceptance returns and band 1 retains it; then delivered."""
    test_sharded_step_crowded_boundary_defers_then_delivers(rebin_variant=5)


@pytest.mark.parametrize("rebin_variant", [6, 5])
def test_one_band_step_is_plane_step(rebin_variant):
    """One band of a gloo mesh runs the card's frame: the same phases on the
    band's slab (K7's plain version or K9's passes with the adoption
    exchange, the walks with fill rows for ghost rows) give ``plane_step``'s
    planes and ``lost`` bit for bit after two frames, and each frame's
    diagnostics are its live counts and the slots the defer mask parks in
    ``walk_positions`` of the whole grid's rebin."""
    spec = GridSpec(**_spec())
    params = make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)
    gen = torch.Generator().manual_seed(7)
    state = scatter_init(gen, 300, BOUNDS, y_std_frac=0.06)
    state = dataclasses.replace(state, vel=torch.randn(state.vel.shape, generator=gen) * 40.0)
    ps = R.plane_state_from_particles(state, spec)
    out = _world(1, [getattr(ps, f).numpy() for f in CHANNELS], ps.frame, ps.n, spec,
                 params, 2, True, None, ps.n, rebin_variant)
    want, live = [], lambda x: x < 0.5 * SENTINEL
    for _ in range(2):
        rebinned, _ = rebin_planes(R.predict_planes(ps, params), spec, variant=rebin_variant)
        wx, _ = walk_positions(rebinned[0], rebinned[1], spec)
        new = R.plane_step(ps, params, spec, variant=rebin_variant)
        want.append({"live_before": int(ps.live.sum()), "live_after": int(new.live.sum()),
                     "deferred": int((live(rebinned[0]) & ~live(wx)).sum())})
        ps = new
    assert out["diags"] == want and sum(d["deferred"] for d in want) > 0
    assert out["frame"] == ps.frame and out["lost"] == int(ps.lost)
    for f, got in zip(CHANNELS, out["planes"]):
        assert np.array_equal(got.view(np.int32), getattr(ps, f).numpy().view(np.int32)), f


def test_sharded_frame_image_matches_single_device(rng):
    """The all_reduce composite of the bands' accumulators against the
    single-device render_plane_state(plane_step(...)) of the same state."""
    jspec, _, jps = _jax_setup(rng, n=200, vmax=10.0)
    rs = RenderSpec(width=108, height=72, max_radius_px=2)  # 1 world unit = 1 px
    spec = GridSpec(**_spec())
    params = make_params(bounds=BOUNDS, gravity=120.0, shader_delay=0, particle_size=2.0)
    planes = _initial(jps)
    out = _world(4, planes, 0, int(jps.n), spec, params, 0, True, (rs, BOUNDS))
    ps = R.PlaneState(*(torch.from_numpy(p) for p in planes), frame=0,
                      lost=torch.zeros((), dtype=torch.int32), n=int(jps.n))
    single = R.plane_step(ps, params, spec)
    want = R.render_plane_state(single, params, spec, rs, bounds_static=BOUNDS)
    assert out["image"].shape == (72, 108, 4) and float(want[..., :3].max()) > 0
    np.testing.assert_allclose(out["image"], want.numpy(), rtol=0, atol=2.5e-2)
    for got, f in zip(out["planes"], CHANNELS):  # the frame's step, gathered
        torch.testing.assert_close(torch.from_numpy(got)[single.live],
                                   getattr(single, f)[single.live], rtol=0, atol=2e-3)


def _fail_on_band_1(mesh):
    """Band 1 raises; band 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("band 1 gives up")
    mesh.all_reduce(torch.ones(1))


def _hang_on_band_0(mesh):
    if mesh.rank == 0:
        time.sleep(120)


def test_run_bands_fails_on_a_failed_or_hung_rank():
    """A rank that raises fails the world at once, with its traceback; a rank
    that hangs fails it at the deadline; every rank is gone either way."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="band 1 gives up"):
        run_bands(_fail_on_band_1, 2, backend="gloo", device="cpu", timeout=60.0)
    with pytest.raises(RuntimeError, match="deadline"):
        run_bands(_hang_on_band_0, 2, backend="gloo", device="cpu", timeout=5.0)
    assert time.monotonic() - t0 < 50.0
    assert not multiprocessing.active_children()
