"""Port vs JAX: the N-body (K8's plain version), flow-field and attractor
models, their Simulation and CLI runs on the CPU, and their checkpoints
across the two packages.

Bars: K8's plain version against the JAX dense reference and the Pallas
kernel (interpret mode) at rtol 2e-4 / atol 2e-3, and an N-body step at pos
rtol/atol 1e-4, vel rtol 1e-4 / atol 2e-3 (tests/test_pallas_nbody.py:18,
:36-37).  The flow and attractor steps are elementwise in JAX's order of
operations, so the rest is the last-ulp difference of cos and sqrt between
the two CPU libraries: rtol 1e-5 with atol 1e-4 (positions) and 1e-3 (flow
velocities, which carry ~250-unit field terms) on every frame.  Multi-frame
runs carry each frame's JAX state across, so the bars are per frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu import models as jmodels
from rust_particle_system_tpu.core.state import ParticleState as JParticleState
from rust_particle_system_tpu.ops.pallas.nbody import nbody_accel_pallas
from rust_particle_system_tpu.runtime import checkpoint as jcheckpoint
from rust_particle_system_tpu_torch import interop, models
from rust_particle_system_tpu_torch.models.flow_field import curl_velocity
from rust_particle_system_tpu_torch.ops.cuda.nbody import nbody_accel, nbody_accel_plain
from rust_particle_system_tpu_torch.render import to_srgb_u8
from rust_particle_system_tpu_torch.runtime import cli
from rust_particle_system_tpu_torch.runtime.simulation import Simulation
from test_torch_runtime import _read_png

SMALL = (-200.0, 200.0, -100.0, 100.0)
MODELS = {"nbody": (jmodels.NBody, jmodels.nbody_step),
          "flow": (jmodels.FlowField, jmodels.flow_step),
          "attractor": (jmodels.Attractor, jmodels.attractor_step)}
STEPS = {"nbody": models.nbody_step, "flow": models.flow_step,
         "attractor": models.attractor_step}


def _port_params(jp):
    """JAX params -> the port's, through the checkpoint's ``params/`` keys."""
    return interop.params_from_numpy({f"params/{f}": np.asarray(getattr(jp, f))
                                      for f in jp._fields})


def _port_state(js):
    return interop.particle_state_from_numpy(
        {f"state/{f}": np.asarray(getattr(js, f)) for f in ("pos", "vel", "color", "frame")},
        device="cpu")


def _jax_setup(name, n, seed=0):
    cls, step = MODELS[name]
    model = cls.create(bounds=SMALL)
    jp = model.default_params()
    if name == "flow":
        jp = jmodels.make_flow_params(bounds=SMALL, seed=3)  # JAX's own tables
    js = model.init(jax.random.key(seed), n)
    return jax.jit(step), jp, js


@pytest.mark.parametrize("n", [256, 1000])
@pytest.mark.parametrize("reference", ["dense", "pallas"])
def test_nbody_accel_plain_matches_jax(rng, n, reference):
    pos = rng.uniform(-500, 500, (n, 2)).astype(np.float32)
    jp = jmodels.make_nbody_params()
    jaccel = jmodels.nbody_accel if reference == "dense" else nbody_accel_pallas
    want = np.asarray(jaccel(jnp.asarray(pos), jp))
    got = nbody_accel(torch.from_numpy(pos), _port_params(jp))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)


def test_nbody_accel_coincident_particles_finite(rng):
    """Coincident particles: the softening keeps every pair finite and the
    zero offset makes each pair add exactly 0, in both packages."""
    pos = np.zeros((256, 2), np.float32)
    pos[128:] = rng.uniform(-5, 5, (128, 2))
    pos[200:210] = pos[128]
    jp = jmodels.make_nbody_params()
    got = nbody_accel_plain(torch.from_numpy(pos), _port_params(jp)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(jmodels.nbody_accel(jnp.asarray(pos), jp)),
                               rtol=2e-4, atol=2e-3)


def _compare(name, ts, js, frames):
    pos_tol = dict(rtol=1e-4, atol=1e-4) if name == "nbody" else dict(rtol=1e-5, atol=1e-4)
    vel_tol = {"nbody": dict(rtol=1e-4, atol=2e-3), "flow": dict(rtol=1e-5, atol=1e-3),
               "attractor": dict(rtol=1e-5, atol=1e-4)}[name]
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), **pos_tol)
    np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel), **vel_tol)
    np.testing.assert_allclose(ts.color.numpy(), np.asarray(js.color), rtol=1e-4, atol=1e-4)
    assert ts.frame == int(js.frame) == frames


@pytest.mark.parametrize("name", ["nbody", "flow", "attractor"])
def test_steps_match_jax_on_carried_state(name):
    """Five frames, each started from the JAX state of the frame before."""
    step, jp, js = _jax_setup(name, 512)
    tp = _port_params(jp)
    js = js._replace(frame=jnp.asarray(7, jnp.int32))  # the flow field's t != 0
    for k in range(5):
        ts = STEPS[name](_port_state(js), tp)
        js = step(js, jp)
        _compare(name, ts, js, 8 + k)
        assert np.abs(np.asarray(js.vel)).max() > 1.0  # something moves


def test_flow_params_draw_unit_tables_and_curl_matches_jax(rng):
    p = models.make_flow_params(seed=5)
    dirs = np.asarray(p.octave_dirs)
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, rtol=1e-6)
    assert all(0.0 <= ph < 2 * np.pi for ph in p.octave_phases)
    assert all(0.5 <= s < 2.0 for s in p.octave_speeds)
    assert p != models.make_flow_params(seed=6)
    jp = jmodels.make_flow_params(seed=5)
    pos = rng.uniform(-900, 900, (400, 2)).astype(np.float32)
    t = np.float32(0.37)
    want = np.asarray(jmodels.flow_field.curl_velocity(jnp.asarray(pos), t, jp))
    got = curl_velocity(torch.from_numpy(pos), float(t), _port_params(jp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def test_model_families_match_jax():
    assert set(models.MODEL_FAMILIES) == set(jmodels.MODEL_FAMILIES)
    for name in ("nbody", "flow", "attractor"):
        m = models.MODEL_FAMILIES[name].create(device="cpu")
        assert m.device.type == "cpu" and m.bounds == (-960.0, 960.0, -540.0, 540.0)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                models.MODEL_FAMILIES[name].create()


@pytest.mark.parametrize("name", ["nbody", "flow", "attractor"])
def test_simulation_drives_each_model(name):
    sim = Simulation(models.MODEL_FAMILIES[name].create(bounds=SMALL, device="cpu"),
                     n=300, seed=1)
    p0 = sim.state.pos.clone()
    sim.run(6)
    stats = sim.stats()
    assert stats["n"] == 300 and stats["frame"] == 6 and "lost" not in stats
    assert sim.particle_state() is sim.state
    assert float((sim.state.pos - p0).abs().max()) > 0.0
    img = sim.render()
    assert tuple(img.shape) == (1080, 1920, 4) and bool(torch.isfinite(img).all())
    assert float(img[..., :3].max()) > 0.0
    with pytest.raises(ValueError, match="unknown parameter"):
        sim.update_params(smoothing_radius=5.0)
    assert sim.update_params(dt=0.004).dt == np.float32(0.004)


@pytest.mark.parametrize("name", ["nbody", "flow", "attractor"])
def test_cli_runs_each_model(tmp_path, capsys, name):
    """--model with --render, --stats and --save on the CPU; the PNG is the
    final frame of the same run through Simulation."""
    path, ckpt = tmp_path / "frame.png", tmp_path / "state.npz"
    assert cli.main(["--model", name, "--device", "cpu", "--n", "300", "--frames", "4",
                     "--render", str(path), "--stats", "--save", str(ckpt)]) == 0
    out = capsys.readouterr().out
    assert f"{name}: 4 frames x 300 particles on cpu" in out and "'frame': 4" in out
    sim = Simulation(models.MODEL_FAMILIES[name].create(device="cpu"), n=300, seed=0)
    sim.run(4)
    np.testing.assert_array_equal(_read_png(path), to_srgb_u8(sim.render()).numpy())
    state, params = interop.load_npz(str(ckpt), device="cpu")
    assert params == sim.params and state.frame == 4
    np.testing.assert_array_equal(state.pos.numpy(), sim.state.pos.numpy())
    assert cli.main(["--model", name, "--device", "cpu", "--n", "300", "--frames", "1",
                     "--resume", str(ckpt)]) == 0
    assert "resumed from" in capsys.readouterr().out
    other = "flow" if name != "flow" else "nbody"
    with pytest.raises(SystemExit, match="takes"):
        cli.main(["--model", other, "--device", "cpu", "--n", "300", "--frames", "1",
                  "--resume", str(ckpt)])


@pytest.mark.parametrize("name", ["nbody", "flow", "attractor"])
def test_checkpoints_cross_packages(tmp_path, name):
    """JAX checkpoint.save -> the port loads and steps as JAX does; the
    port's save -> JAX checkpoint.load reads back every leaf."""
    step, jp, js = _jax_setup(name, 256, seed=4)
    js = step(js, jp)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, js, jp)
    ts, tp = interop.load_npz(path, device="cpu")
    assert tp == _port_params(jp) and ts.ids is None
    _compare(name, STEPS[name](ts, tp), step(js, jp), 2)
    back = str(tmp_path / "port.npz")
    interop.save_npz(back, ts, tp)
    jstate, jparams = jcheckpoint.load(back, js, jp)
    assert isinstance(jstate, JParticleState)
    for a, b in zip(jax.tree_util.tree_leaves((jstate, jparams)),
                    jax.tree_util.tree_leaves((js, jp))):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
