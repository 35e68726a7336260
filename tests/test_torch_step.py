"""Port vs JAX: the plane-resident frame (plane_step, variant 6, fused tail).

Warm-up frames are bitwise frozen in both.  Live frames differ only by f32
summation order in the walks, and a drifted position can flip a keying decision
and hence a slot, so states are compared in particle-id order: one live frame at
the tests/test_pallas_sph.py tolerances, four at tests/test_rebin.py:478-481's.
Conservation (lost == 0, the live count) is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.core.params import make_params as jmake_params
from rust_particle_system_tpu.core.state import make_state as jmake_state
from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas import resident as JR
from rust_particle_system_tpu.runtime import checkpoint as jcheckpoint
from rust_particle_system_tpu_torch import interop
from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.core.state import make_state
from rust_particle_system_tpu_torch.ops.cuda import resident as R
from rust_particle_system_tpu_torch.ops.grid import GridSpec

BOUNDS = (-90.0, 90.0, -45.0, 45.0)
PLANES = ("px", "py", "vx", "vy", "idsf")


def _setup(rng, n=512, capacity=16, bounds=BOUNDS, gravity=400.0):
    x_min, x_max, y_min, y_max = bounds
    pos = np.stack([rng.uniform(x_min, x_max, n),
                    np.clip(rng.normal(0.0, (y_max - y_min) / 8, n), y_min, y_max)],
                   -1).astype(np.float32)
    js = JGridSpec.from_bounds(bounds, 9.0, capacity)
    ts = GridSpec.from_bounds(bounds, 9.0, capacity)
    jps = JR.plane_state_from_particles(jmake_state(jnp.asarray(pos)).with_ids(), js)
    tps = R.plane_state_from_particles(make_state(pos).with_ids(), ts)
    return (js, jmake_params(bounds=bounds, gravity=gravity), jps,
            ts, make_params(bounds=bounds, gravity=gravity), tps)


def _by_id(ps):
    s = ps.to_particle_state()
    order = np.argsort(np.asarray(s.ids))
    return (np.asarray(s.pos)[order], np.asarray(s.vel)[order],
            np.asarray(s.ids)[order])


def _compare(jps, tps, pos_tol, vel_tol):
    jpos, jvel, jids = _by_id(jps)
    tpos, tvel, tids = _by_id(tps)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tpos, jpos, **pos_tol)
    np.testing.assert_allclose(tvel, jvel, **vel_tol)
    assert int(tps.lost) == int(jps.lost) == 0
    assert int(tps.live.sum()) == int(np.asarray(jps.live).sum()) == tps.n


def test_warmup_frames_frozen(rng):
    js, jp, jps, ts, tp, tps = _setup(rng)
    start = {f: getattr(tps, f).clone() for f in PLANES}
    for i in range(5):
        jps, tps = JR.plane_step(jps, jp, js), R.plane_step(tps, tp, ts)
        assert tps.frame == int(jps.frame) == i + 1
    for f in PLANES:
        np.testing.assert_array_equal(getattr(tps, f).numpy(), start[f].numpy())
        np.testing.assert_array_equal(getattr(tps, f).numpy(), np.asarray(getattr(jps, f)))


@pytest.mark.parametrize("capacity,bounds,n", [(16, BOUNDS, 512),
                                               (128, (-27.0, 27.0, -18.0, 18.0), 400)])
def test_one_live_frame_matches_jax(rng, capacity, bounds, n):
    js, jp, jps, ts, tp, tps = _setup(rng, n=n, capacity=capacity, bounds=bounds)
    jps = dataclasses.replace(jps, frame=jnp.asarray(5, jnp.int32))
    tps = dataclasses.replace(tps, frame=5)
    jps, tps = JR.plane_step(jps, jp, js), R.plane_step(tps, tp, ts)
    _compare(jps, tps, dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-2))


def test_four_live_frames_match_jax_in_id_order(rng):
    js, jp, jps, ts, tp, tps = _setup(rng)
    for _ in range(9):  # 5 warm-up + 4 live frames
        jps, tps = JR.plane_step(jps, jp, js), R.plane_step(tps, tp, ts)
    _compare(jps, tps, dict(rtol=0, atol=5e-4), dict(rtol=0, atol=5e-3))


def test_fast_movers_stay_lossless_and_match_jax(rng):
    """Every live slot moving three cells in one frame (tests/test_rebin.py:
    493-507): the movers are deferred and hop, none is lost, every particle sits
    in the same slot as in JAX, and the values agree (deferred slots take no
    walk sums; the predict's rounding may differ by an ulp between backends)."""
    js, jp, jps, ts, tp, tps = _setup(rng, gravity=0.0)
    fast = 3.0 * ts.cell_width / tp.dt
    jvx = jnp.where(jps.live, np.float32(fast), np.float32(0))  # strong f32: jit cache hit
    jps = dataclasses.replace(jps, vx=jvx, frame=jnp.asarray(10, jnp.int32))
    tps = dataclasses.replace(tps, vx=torch.where(tps.live, fast, 0.0), frame=10)
    live_before = int(tps.live.sum())
    jps, tps = JR.plane_step(jps, jp, js), R.plane_step(tps, tp, ts)
    assert int(tps.lost) == 0 and int(tps.live.sum()) == live_before
    np.testing.assert_array_equal(tps.idsf.numpy(), np.asarray(jps.idsf))
    np.testing.assert_array_equal(tps.live.numpy(), np.asarray(jps.live))
    _compare(jps, tps, dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-2))


def test_interop_jax_checkpoint_resumes_in_port(rng, tmp_path):
    """A PlaneState saved by the JAX checkpoint.save loads into the port, and
    one live frame in each package agrees; the port's save loads back in JAX."""
    js, jp, jps, ts, tp, tps = _setup(rng)
    jps = dataclasses.replace(jps, frame=jnp.asarray(5, jnp.int32))
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jps, jp)
    state, params = interop.load_npz(path, device="cpu")
    assert params == tp and state.frame == 5 and state.n == tps.n
    for f in PLANES:
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jps, f)))
    _compare(JR.plane_step(jps, jp, js), R.plane_step(state, params, ts),
             dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-2))
    back = str(tmp_path / "port.npz")
    interop.save_npz(back, state, params)
    jstate, jparams = jcheckpoint.load(back, jps, jp)
    for a, b in zip(jax.tree_util.tree_leaves((jstate, jparams)),
                    jax.tree_util.tree_leaves((jps, jp))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_conservation_over_frames(rng):
    """lost stays 0 and the live count exact over many frames, spills included."""
    ts = GridSpec(x_min=0.0, y_min=0.0, cell_size=9.0, gw=9, gh=9, capacity=16)
    n = 20  # 4 over one cell's capacity: spilled at init, deferred until they land
    pos = np.stack([40.5 + rng.uniform(-2, 2, n), 40.5 + rng.uniform(-2, 2, n)],
                   -1).astype(np.float32)
    tps = R.plane_state_from_particles(make_state(pos).with_ids(), ts)
    tp = make_params(bounds=(0.0, 81.0, 0.0, 81.0), gravity=300.0, shader_delay=0)
    for _ in range(30):
        tps = R.plane_step(tps, tp, ts)
        assert int(tps.lost) == 0 and int(tps.live.sum()) == n
    ids = np.sort(tps.idsf.numpy()[tps.live.numpy()].astype(int))
    np.testing.assert_array_equal(ids, np.arange(n))
