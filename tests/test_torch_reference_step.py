"""Port vs JAX and the numpy oracle: the all-pairs oracle ``reference_step``
and the sort-binned ``grid_step``, on the CPU.

Bars are the JAX tests' own: the oracle against tests/numpy_oracle.py at
tests/test_reference_step.py:34-36 (one frame) and :53-54 (five frames);
``grid_step`` against the oracle at tests/test_grid.py:103-105 (one frame)
and :121-126 (eight frames).  Against the JAX functions on the same input the
port is held to the same bars.  Both steps differentiate: the gradient of the
final mean height with respect to a downward velocity kick that enters where
gravity does is finite and negative (tests/test_debug_and_diff.py:62-101).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import numpy_oracle as oracle
from rust_particle_system_tpu.core.params import make_params as jmake_params
from rust_particle_system_tpu.core.state import make_state as jmake_state
from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.grid_step import grid_step as jgrid_step
from rust_particle_system_tpu.ops.reference_step import reference_step as jreference_step
from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.core.state import make_state, scatter_init
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.ops import grid_step as grid_step_mod
from rust_particle_system_tpu_torch.ops.grid_step import grid_physics, grid_step
from rust_particle_system_tpu_torch.ops.reference_step import reference_step

BOUNDS = (-100.0, 100.0, -50.0, 50.0)
ORACLE_1 = (dict(rtol=2e-4, atol=2e-4), dict(rtol=2e-4, atol=2e-3))
ORACLE_5 = (dict(rtol=1e-3, atol=5e-3), dict(rtol=1e-3, atol=5e-2))
GRID_1 = (dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-2))


@functools.lru_cache(maxsize=None)
def _jref():
    return jax.jit(jreference_step)


def _random_state(rng, n, bounds=BOUNDS, vmax=30.0):
    x_min, x_max, y_min, y_max = bounds
    pos = np.stack([rng.uniform(x_min, x_max, n), rng.uniform(y_min, y_max, n)],
                   -1).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    return pos, vel


def _close(state, pos, vel, tol, color=None):
    np.testing.assert_allclose(state.pos.detach().numpy(), np.asarray(pos), **tol[0])
    np.testing.assert_allclose(state.vel.detach().numpy(), np.asarray(vel), **tol[1])
    if color is not None:
        np.testing.assert_allclose(state.color.detach().numpy(), np.asarray(color),
                                   rtol=1e-3, atol=1e-3)


def test_reference_step_matches_jax_and_numpy_oracle(rng):
    pos, vel = _random_state(rng, 64)
    params = make_params(bounds=BOUNDS, gravity=50.0, shader_delay=0)
    out = reference_step(make_state(pos, vel), params)
    assert out.frame == 1
    want_pos, want_vel, want_color = oracle.step(
        pos.astype(np.float64), vel.astype(np.float64),
        oracle.Params(bounds=BOUNDS, gravity=50.0, shader_delay=0), frame=0)
    _close(out, want_pos, want_vel, ORACLE_1, want_color)
    jout = _jref()(jmake_state(pos, vel), jmake_params(bounds=BOUNDS, gravity=50.0,
                                                       shader_delay=0))
    _close(out, jout.pos, jout.vel, ORACLE_1, jout.color)


def test_reference_trajectory_matches_numpy_oracle(rng):
    bounds = (-60.0, 60.0, -40.0, 40.0)
    pos, vel = _random_state(rng, 32, bounds, vmax=10.0)
    params = make_params(bounds=bounds, gravity=100.0, shader_delay=0)
    op = oracle.Params(bounds=bounds, gravity=100.0, shader_delay=0)
    state = make_state(pos, vel)
    np_pos, np_vel = pos.astype(np.float64), vel.astype(np.float64)
    for frame in range(5):
        state = reference_step(state, params)
        np_pos, np_vel, _ = oracle.step(np_pos, np_vel, op, frame=frame)
    _close(state, np_pos, np_vel, ORACLE_5)


@pytest.mark.parametrize("step", ["oracle", "grid"])
def test_warmup_frames_are_identity(step):
    params = make_params(bounds=BOUNDS, shader_delay=5, gravity=500.0)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 32)
    fn = (reference_step if step == "oracle"
          else lambda s, p: grid_step(s, p, spec))
    s0 = scatter_init(torch.Generator().manual_seed(0), 128, BOUNDS)
    s = s0
    for _ in range(5):
        s = fn(s, params)
    assert s.frame == 5
    assert torch.equal(s.pos, s0.pos) and torch.equal(s.vel, s0.vel)
    s2 = fn(s, params)  # frame 5 onwards the physics runs
    assert not torch.allclose(s2.vel, s.vel)


@pytest.mark.parametrize("step", ["oracle", "grid"])
def test_coincident_particles_not_nan(step):
    pos = np.zeros((3, 2), np.float32)
    params = make_params(bounds=BOUNDS, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 8)
    s = make_state(pos)
    out = reference_step(s, params) if step == "oracle" else grid_step(s, params, spec)
    assert bool(torch.isfinite(out.pos).all() and torch.isfinite(out.vel).all())
    assert float(out.vel[:, 1].abs().max()) > 0.0  # the (0, 1) fallback pushed them


def test_reference_stays_in_bounds_many_frames():
    bounds = (-50.0, 50.0, -30.0, 30.0)
    params = make_params(bounds=bounds, gravity=300.0, shader_delay=0)
    state = scatter_init(torch.Generator().manual_seed(1), 256, bounds)
    for _ in range(20):
        state = reference_step(state, params)
    pos = state.pos.numpy()
    assert np.all(pos[:, 0] >= bounds[0]) and np.all(pos[:, 0] <= bounds[1])
    assert np.all(pos[:, 1] >= bounds[2]) and np.all(pos[:, 1] <= bounds[3])
    assert bool(torch.isfinite(state.vel).all())


@pytest.mark.parametrize("n", [64, 300])
def test_grid_step_matches_jax_and_oracle(rng, n, monkeypatch):
    pos, vel = _random_state(rng, n, vmax=20.0)
    params = make_params(bounds=BOUNDS, gravity=80.0, shader_delay=0)
    jparams = jmake_params(bounds=BOUNDS, gravity=80.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 64)
    got = grid_step(make_state(pos, vel), params, spec)
    ref = reference_step(make_state(pos, vel), params)
    _close(got, ref.pos, ref.vel, GRID_1, ref.color)
    jgot = jgrid_step(jmake_state(pos, vel), jparams, JGridSpec.from_bounds(BOUNDS, 9.0, 64))
    _close(got, jgot.pos, jgot.vel, GRID_1, jgot.color)
    assert got.frame == int(jgot.frame) == 1
    # Each row of a tile sums on its own: the chunk size changes no result.
    monkeypatch.setattr(grid_step_mod, "PAIR_BUDGET", 7 * 9 * 64 * 64)  # 7 cells a chunk
    assert grid_step_mod.chunk_size(spec) == 7
    small = grid_step(make_state(pos, vel), params, spec)
    assert torch.equal(small.pos, got.pos) and torch.equal(small.vel, got.vel)


def test_grid_trajectory_matches_oracle(rng):
    pos, vel = _random_state(rng, 128, vmax=10.0)
    params = make_params(bounds=BOUNDS, gravity=150.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 16)  # no cell of this cloud reaches 16
    s_grid = s_ref = make_state(pos, vel)
    for _ in range(8):
        s_grid = grid_step(s_grid, params, spec)
        s_ref = reference_step(s_ref, params)
    _close(s_grid, s_ref.pos, s_ref.vel, ORACLE_5)


def test_grid_physics_reports_overflow():
    pos = np.zeros((32, 2), np.float32) + 0.1
    params = make_params(bounds=BOUNDS, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 4)
    state, overflow = grid_physics(make_state(pos), params, spec)
    assert int(overflow) == 28
    assert bool(torch.isfinite(state.vel).all())


@pytest.mark.parametrize("step", ["oracle", "grid"])
def test_step_is_differentiable(rng, step):
    """d(final mean height)/d(kick) < 0 for a downward kick g*dt applied to
    the velocity before each of 3 frames (the port's params are floats, so
    the kick enters as a tensor where gravity does)."""
    n = 64 if step == "oracle" else 128
    pos = np.stack([rng.uniform(-100, 100, n), rng.uniform(-50, 50, n)], -1).astype(np.float32)
    params = make_params(bounds=BOUNDS, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 32)
    fn = reference_step if step == "oracle" else (lambda s, p: grid_step(s, p, spec))
    g = torch.tensor(100.0, requires_grad=True)
    s = make_state(pos)
    for _ in range(3):
        kick = torch.stack([torch.zeros(()), -g * params.dt])
        s = fn(dataclasses.replace(s, vel=s.vel + kick), params)
    (grad,) = torch.autograd.grad(s.pos[:, 1].mean(), g)
    assert np.isfinite(float(grad)) and float(grad) < 0.0
