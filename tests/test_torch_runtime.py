"""The port's core math against the JAX package, and its runtime surface on the
CPU: the model's device contract, the Simulation guards, the CLI, and that the
package never imports jax."""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.core import kernels as jkernels
from rust_particle_system_tpu.core import params as jparams
from rust_particle_system_tpu.ops.pallas.resident import PlaneState as JPlaneState
from rust_particle_system_tpu.runtime import checkpoint as jcheckpoint
from rust_particle_system_tpu_torch import interop
from rust_particle_system_tpu_torch.core import kernels, params
from rust_particle_system_tpu_torch.core.params import kernel_norms
from rust_particle_system_tpu_torch.models.sph import SPHFluid
from rust_particle_system_tpu_torch.ops.cuda import rebin
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.render import to_srgb_u8
from rust_particle_system_tpu_torch.runtime import cli
from rust_particle_system_tpu_torch.runtime.simulation import Simulation

REPO = Path(__file__).resolve().parents[1]
SMALL = (-90.0, 90.0, -45.0, 45.0)


def _sim(n=300, capacity=16):
    return Simulation(SPHFluid.create(n=n, bounds=SMALL, capacity=capacity,
                                      device="cpu"), seed=0)


def test_core_math_matches_jax(rng):
    """Params (f32-rounded, radius-derived norms), the smoothing kernels, the
    abs-damped bounce and the colour ramp equal the JAX package's."""
    jp = jparams.with_smoothing_radius(jparams.make_params(gravity=123.4), 7.5)
    tp = params.with_smoothing_radius(params.make_params(gravity=123.4), 7.5)
    for f in jp._fields:
        want = np.asarray(getattr(jp, f))
        np.testing.assert_array_equal(np.asarray(getattr(tp, f), want.dtype), want, err_msg=f)
    d = np.abs(rng.normal(0, 6, 500)).astype(np.float32)
    for name in ("density_kernel", "density_kernel_derivative", "near_density_kernel",
                 "near_density_kernel_derivative", "viscosity_kernel"):
        want = getattr(jkernels, name)(jnp.asarray(d), 9.0, 0.01)
        got = getattr(kernels, name)(torch.from_numpy(d), 9.0, 0.01)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, err_msg=name)
    pos = rng.uniform(-1100, 1100, (500, 2)).astype(np.float32)
    vel = rng.normal(0, 80, (500, 2)).astype(np.float32)
    bounds = params.DEFAULT_BOUNDS
    jpos, jvel = jkernels.bounce_bounds(jnp.asarray(pos), jnp.asarray(vel),
                                        jnp.asarray(bounds), 0.1)
    tpos, tvel = kernels.bounce_bounds(torch.from_numpy(pos), torch.from_numpy(vel),
                                       bounds, 0.1)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), rtol=1e-6)
    np.testing.assert_allclose(kernels.energy_color(torch.from_numpy(vel), 2000.0).numpy(),
                               np.asarray(jkernels.energy_color(jnp.asarray(vel), 2000.0)),
                               rtol=1e-6, atol=1e-7)


def test_create_defaults_to_the_card_and_fails_loudly_without_it():
    model = SPHFluid.create(device="cpu")
    assert (model.grid.gw, model.grid.gh, model.grid.capacity) == (214, 121, 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SPHFluid.create()


def test_update_params_guards():
    sim = _sim()
    with pytest.raises(ValueError, match="outside the supported range"):
        sim.update_params(gravity=-1.0)
    with pytest.raises(ValueError, match="outside the supported range"):
        sim.update_params(dt=0.5)
    with pytest.raises(ValueError, match="exceeds the grid cell size"):
        sim.update_params(smoothing_radius=12.0)
    with pytest.raises(ValueError, match="unknown parameter"):
        sim.update_params(no_such_field=1.0)
    p = sim.update_params(smoothing_radius=6.0, gravity=250.0)
    assert p.smoothing_radius == 6.0 and p.gravity == 250.0
    assert (p.density_kernel_norm, p.near_density_kernel_norm,
            p.viscosity_kernel_norm) == kernel_norms(6.0)


def test_run_conserves_and_stats_validate():
    sim = _sim()
    sim.update_params(gravity=400.0)
    y0 = float(sim.state.py[sim.state.live].mean())
    sim.run(12)
    stats = sim.stats()
    assert stats["n"] == 300 and stats["lost"] == 0 and stats["frame"] == 12
    assert int(sim.state.live.sum()) == 300
    assert float(sim.state.py[sim.state.live].mean()) < y0
    ps = sim.particle_state()
    np.testing.assert_array_equal(ps.ids.numpy(), np.arange(300))
    assert torch.all(ps.color[:, 3] == 1.0) and not torch.all(ps.color == 1.0)


def test_kernel_wrappers_reject_other_devices():
    planes = [torch.full((2, 3, 2), rebin.SENTINEL, device="meta") for _ in range(2)]
    spec = GridSpec(x_min=0.0, y_min=0.0, cell_size=10.0, gw=3, gh=2, capacity=2)
    with pytest.raises(ValueError, match="unsupported device"):
        rebin.rebin_planes(planes, spec)


def test_cli_runs_on_cpu_and_resumes(tmp_path, capsys):
    assert cli.main(["--device", "cpu", "--n", "200", "--frames", "7", "--stats"]) == 0
    out = capsys.readouterr().out
    assert "7 frames x 200 particles on cpu" in out and "'lost': 0" in out
    sim = Simulation(SPHFluid.create(n=150, device="cpu"), seed=1)
    sim.run(6)
    path = str(tmp_path / "state.npz")
    interop.save_npz(path, sim.state, sim.params)
    assert cli.main(["--device", "cpu", "--n", "150", "--frames", "2",
                     "--resume", path]) == 0
    assert "resumed from" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--video"])
def test_cli_unported_outputs_exit_nonzero(flag, capsys):
    assert cli.main(["--device", "cpu", "--n", "10", "--frames", "1", flag, "x"]) != 0
    assert "not yet ported" in capsys.readouterr().err


def _read_png(path):
    """[H, W, 4] uint8 of an RGBA8 PNG written with filter 0 on every row."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8: pos + 8 + length]
        pos += 12 + length
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 6)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 4 * w)
    assert np.all(rows[:, 0] == 0)
    return rows[:, 1:].reshape(h, w, 4)


@pytest.mark.parametrize("frames", [3, 8])
def test_cli_render_writes_the_final_frame(tmp_path, capsys, frames):
    """--render writes to_srgb_u8(sim.render()) of the final state: white in
    warm-up (3 frames), the energy ramp after (8)."""
    path = tmp_path / "frame.png"
    assert cli.main(["--device", "cpu", "--n", "300", "--frames", str(frames),
                     "--set", "gravity=400", "--render", str(path)]) == 0
    assert f"frame -> {path}" in capsys.readouterr().out
    got = _read_png(path)
    sim = Simulation(SPHFluid.create(n=300, device="cpu"), seed=0)
    sim.update_params(gravity=400.0)
    sim.run(frames)
    want = to_srgb_u8(sim.render()).numpy()
    assert got.shape == want.shape == (1080, 1920, 4)
    np.testing.assert_array_equal(got, want)
    lit = got[..., :3].max(-1) > 128
    assert lit.sum() > 300
    grey = np.all(got[..., 0] == got[..., 2])
    assert grey == (frames <= sim.params.shader_delay)


def test_cli_save_loads_in_jax(tmp_path):
    """--save writes the JAX checkpoint layout: the JAX checkpoint.load reads
    the state and params back."""
    path = str(tmp_path / "state.npz")
    assert cli.main(["--device", "cpu", "--n", "200", "--frames", "7", "--set",
                     "gravity=250", "--save", path]) == 0
    sim = Simulation(SPHFluid.create(n=200, device="cpu"), seed=0)
    sim.update_params(gravity=250.0)
    sim.run(7)
    shape = tuple(sim.state.px.shape)
    like = JPlaneState(*(jnp.zeros(shape, jnp.float32) for _ in range(5)),
                       frame=jnp.int32(0), lost=jnp.int32(0), n=200)
    jstate, jp = jcheckpoint.load(path, like, jparams.make_params())
    assert int(jstate.frame) == 7 and int(jstate.lost) == 0
    for f in ("px", "py", "vx", "vy", "idsf"):
        np.testing.assert_array_equal(np.asarray(getattr(jstate, f)),
                                      getattr(sim.state, f).numpy())
    assert float(jp.gravity) == 250.0 and tuple(np.asarray(jp.bounds)) == sim.params.bounds


def test_package_imports_no_jax():
    code = ("import sys, importlib, pkgutil, rust_particle_system_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k.startswith('rust_particle_system_tpu.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
