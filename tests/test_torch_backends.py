"""The SPH fluid's ``grid`` and ``oracle`` backends through the port's runtime
on the CPU: Simulation, the grid validators, the debug helpers, the CLI's
``--backend`` and a JAX grid-backend checkpoint resumed into the port.

Bars: a grid-backend run against an oracle-backend run from the same state
at tests/test_grid.py:121-126's multi-frame bars; the resumed checkpoint's
frames against the JAX grid step at the same bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.core.params import make_params as jmake_params
from rust_particle_system_tpu.core.state import make_state as jmake_state
from rust_particle_system_tpu.models.sph import SPHFluid as JSPHFluid
from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.grid import build_grid as jbuild_grid
from rust_particle_system_tpu.runtime import checkpoint as jcheckpoint
from rust_particle_system_tpu.runtime import debug as jdebug
from rust_particle_system_tpu_torch import interop
from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.core.state import ParticleState, make_state
from rust_particle_system_tpu_torch.models.sph import SPHFluid
from rust_particle_system_tpu_torch.ops.cuda.resident import PlaneState
from rust_particle_system_tpu_torch.ops.grid import GridSpec, build_grid
from rust_particle_system_tpu_torch.render import to_srgb_u8
from rust_particle_system_tpu_torch.runtime import cli, debug
from rust_particle_system_tpu_torch.runtime.simulation import Simulation
from test_torch_runtime import _read_png

SMALL = (-90.0, 90.0, -45.0, 45.0)
BOUNDS = (-100.0, 100.0, -50.0, 50.0)
TRAJ = (dict(rtol=1e-3, atol=5e-3), dict(rtol=1e-3, atol=5e-2))
GRID_KEYS = ("grid_cells_used", "grid_max_occupancy", "grid_mean_occupancy", "grid_overflow")


def _sim(backend, n=300):
    sim = Simulation(SPHFluid.create(n=n, bounds=SMALL, backend=backend, device="cpu"),
                     seed=0)
    sim.update_params(gravity=400.0)
    return sim


def _close(a, b, tol=TRAJ):
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), **tol[0])
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), **tol[1])


def test_grid_and_oracle_backends_through_simulation():
    """Both backends from the same scatter: 5 warm-up + 7 live frames agree;
    stats validate the grid (grid backend only); the y centre of mass falls;
    renders and step_and_render work on the particle state."""
    grid, oracle = _sim("grid"), _sim("oracle")
    assert grid.model.grid.capacity == 21 and oracle.model.grid is None  # suggest_capacity
    y0 = float(grid.state.pos[:, 1].mean())
    assert torch.equal(grid.state.pos, oracle.state.pos)
    grid.run(12)
    oracle.run(12)
    assert isinstance(grid.state, ParticleState) and grid.state.frame == 12
    _close(grid.state, oracle.state)
    assert float(grid.state.pos[:, 1].mean()) < y0
    gs, os_ = grid.stats(), oracle.stats()
    assert gs["n"] == 300 and gs["frame"] == 12 and "lost" not in gs
    assert gs["grid_overflow"] == 0 and gs["grid_max_occupancy"] >= 1
    assert all(k in gs for k in GRID_KEYS) and not any(k in os_ for k in GRID_KEYS)
    img = grid.render()
    assert tuple(img.shape) == (1080, 1920, 4) and bool(torch.isfinite(img).all())
    assert float(img[..., :3].max()) > 0.0
    s, img2 = grid.model.step_and_render(grid.state, grid.params)
    want = grid.model.step(grid.state, grid.params)
    assert s.frame == 13 and torch.equal(s.pos, want.pos)
    assert torch.equal(img2, grid.model.render(want, grid.params))


def test_update_params_radius_on_gridless_oracle():
    oracle, grid = _sim("oracle"), _sim("grid")
    p = oracle.update_params(smoothing_radius=12.0)  # no grid: no cell-size check
    assert p.smoothing_radius == 12.0
    oracle.run(6)
    assert bool(torch.isfinite(oracle.state.vel).all())
    with pytest.raises(ValueError, match="exceeds the grid cell size"):
        grid.update_params(smoothing_radius=12.0)


def test_backend_selection_and_device_contract():
    assert SPHFluid.create(n=10, device="cpu").backend == "pallas"
    auto = SPHFluid.create(n=50, bounds=SMALL, capacity=16, backend="auto", device="cpu")
    assert isinstance(Simulation(auto).state, PlaneState)
    with pytest.raises(ValueError, match="backend"):
        SPHFluid.create(backend="jnp", device="cpu")
    if not torch.cuda.is_available():
        for backend in ("auto", "pallas", "grid", "oracle"):
            with pytest.raises(RuntimeError, match="cuda"):
                SPHFluid.create(n=10, backend=backend)


def _positions(rng, n=300):
    return np.stack([rng.uniform(-100, 100, n), rng.uniform(-50, 50, n)],
                    -1).astype(np.float32)


def test_validate_grid_matches_jax_and_rejects_tampering(rng):
    pos = _positions(rng)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 32)
    grid = build_grid(spec, torch.from_numpy(pos))
    stats = debug.validate_grid(grid, spec, 300)
    js = JGridSpec.from_bounds(BOUNDS, 9.0, 32)
    assert stats == jdebug.validate_grid(jbuild_grid(js, jnp.asarray(pos)), js, 300)
    assert stats["cells_used"] > 0 and stats["overflow"] == 0

    def tampered(**fields):
        return grid._replace(**fields)

    padding = grid.table.clone()
    padding[-1, 0] = 0
    holed = grid.table.clone()
    cell = int(torch.nonzero((grid.table >= 0).sum(1) >= 2)[0])
    holed[cell, 0] = -1
    twice = grid.perm.clone()
    twice[1] = twice[0]
    unsorted = grid.sorted_keys.flip(0)
    for bad, match in ((tampered(table=padding), "padding row"),
                       (tampered(table=holed), "packed front-first"),
                       (tampered(perm=twice), "permutation"),
                       (tampered(sorted_keys=unsorted), "not sorted"),
                       (tampered(table=grid.table[:0]), "no slot table")):
        with pytest.raises(ValueError, match=match):
            debug.validate_grid(bad, spec, 300)


def test_density_report_matches_jax(rng):
    pos = _positions(rng)
    pos[:40] = 0.1  # a crammed cell: the step overflows
    vel = rng.uniform(-20, 20, (300, 2)).astype(np.float32)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 16)
    got = debug.density_report(make_state(pos, vel), make_params(bounds=BOUNDS), spec)
    js = JGridSpec.from_bounds(BOUNDS, 9.0, 16)
    want = jdebug.density_report(jmake_state(pos, vel), jmake_params(bounds=BOUNDS), js)
    assert got == want and got["step_overflow"] > 0


def test_print_config_matches_jax(capsys):
    p = make_params(gravity=123.4, bounds=SMALL)
    text = debug.print_config(p)
    assert text == jdebug.print_config(jmake_params(gravity=123.4, bounds=SMALL))
    assert text in capsys.readouterr().out
    for name in ("particle_size", "shader_delay", "bounds", "viscosity_kernel_norm"):
        assert name in text
    assert len(text.splitlines()) == 1 + len(p.__dataclass_fields__)


def test_cli_grid_backend_stats_and_render(tmp_path, capsys):
    path = tmp_path / "grid.png"
    assert cli.main(["--backend", "grid", "--device", "cpu", "--n", "300", "--frames", "8",
                     "--set", "gravity=400", "--stats", "--render", str(path)]) == 0
    out = capsys.readouterr().out
    assert "8 frames x 300 particles on cpu" in out and "'grid_overflow': 0" in out
    sim = Simulation(SPHFluid.create(n=300, backend="grid", device="cpu"), seed=0)
    sim.update_params(gravity=400.0)
    sim.run(8)
    np.testing.assert_array_equal(_read_png(path), to_srgb_u8(sim.render()).numpy())


@pytest.mark.parametrize("argv", [["--model", "nbody", "--backend", "jnp"],
                                  ["--model", "sph", "--backend", "tpu"]])
def test_cli_refuses_backends_it_does_not_run(argv, capsys):
    assert cli.main(argv + ["--device", "cpu", "--n", "10", "--frames", "1"]) == 2
    assert "--backend" in capsys.readouterr().err


def test_jax_grid_checkpoint_resumes_with_backend_grid(tmp_path):
    """JAX grid backend: 6 frames, checkpoint.save; the port's CLI resumes it
    with --backend grid, runs 2 frames and saves; the JAX grid step's 2
    frames from the saved state agree at the multi-frame bars."""
    jmodel = JSPHFluid.create(n=300, backend="grid")
    jp = jmake_params(gravity=400.0)
    js = jmodel.init(jax.random.key(0), 300)
    for _ in range(6):
        js = jmodel.step(js, jp)
    path, back = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcheckpoint.save(path, js, jp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            interop.load_npz(path)  # the loaders default to the card
    assert cli.main(["--backend", "grid", "--device", "cpu", "--n", "300", "--frames", "2",
                     "--resume", path, "--save", back]) == 0
    ts, tp = interop.load_npz(back, device="cpu")
    assert ts.frame == 8 and tp.gravity == 400.0
    for _ in range(2):
        js = jmodel.step(js, jp)
    _close(ts, js)
