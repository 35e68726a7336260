"""Port vs JAX: the rendered frame.  ``plane_frame``, ``render_plane_state``,
``plane_step(fuse_tail=False)`` and the model's ``render`` /
``step_and_render`` against the JAX package (Pallas in interpret mode), on
states carried across with ``interop.plane_state_from_numpy``.

Bars: states after a live frame at tests/test_torch_step.py's one-live-frame
bars (positions rtol/atol 1e-4, velocities rtol 1e-4 / atol 1e-2, in id
order); images of a stepped state at 1e-3 (tests/test_plane_frame.py:93-94),
images of one and the same state at the model bar 2e-4
(tests/test_render.py:201); the port's fused against its unfused tail at
tests/test_rebin.py:658-661's bars, and bit for bit when every live slot is
deferred.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_step import _compare

from rust_particle_system_tpu.core.params import make_params as jmake_params
from rust_particle_system_tpu.core.state import make_state as jmake_state
from rust_particle_system_tpu.models.sph import SPHFluid as JSPHFluid
from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas import resident as JR
from rust_particle_system_tpu.render import RenderSpec as JRenderSpec
from rust_particle_system_tpu_torch import interop
from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.models.sph import SPHFluid
from rust_particle_system_tpu_torch.ops.cuda import resident as R
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.render import RenderSpec

BOUNDS = (-96.0, 96.0, -54.0, 54.0)
PLANES = ("px", "py", "vx", "vy", "idsf")


def _carried(jps):
    """The port's copy of a JAX PlaneState."""
    arrays = {f"state/{k}": np.asarray(getattr(jps, k)) for k in PLANES}
    arrays["state/frame"] = np.asarray(jps.frame)
    arrays["state/lost"] = np.asarray(jps.lost)
    return interop.plane_state_from_numpy(arrays, device="cpu")


def _setup(seed, n=300, vmax=10.0, gravity=120.0, shader_delay=0, frame=0, rs=2):
    """(JAX spec, params, state; port spec, params, state; render specs) at
    192x108 px, 9 px cells, C=16 (tests/test_plane_frame.py)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(BOUNDS[0], BOUNDS[1], n),
                    rng.uniform(BOUNDS[2], BOUNDS[3], n)], -1).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    js = JGridSpec.from_bounds(BOUNDS, 9.0, 16)
    jps = JR.plane_state_from_particles(jmake_state(pos, vel).with_ids(), js)
    jps = dataclasses.replace(jps, frame=jnp.asarray(frame, jnp.int32))
    kw = dict(bounds=BOUNDS, gravity=gravity, shader_delay=shader_delay)
    return (js, jmake_params(**kw), jps, GridSpec.from_bounds(BOUNDS, 9.0, 16),
            make_params(**kw), _carried(jps), JRenderSpec(192, 108, rs),
            RenderSpec(192, 108, rs))


def _img(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("rs,shader_delay", [(2, 0), (4, 0), (2, 5)])
def test_plane_frame_matches_jax(rs, shader_delay):
    """A live frame (radius-2 sprites; the coarse-pixel radius 4, whose drift
    margin clamps to the stride) and a warm-up frame, which stays frozen and
    draws the energy ramp, as JAX does."""
    js, jp, jps, ts, tp, tps, jrs, trs = _setup(3, shader_delay=shader_delay, rs=rs)
    jnew, jimg = JR.plane_frame(jps, jp, js, jrs, bounds_static=BOUNDS)
    tnew, timg = R.plane_frame(tps, tp, ts, trs, bounds_static=BOUNDS)
    assert tnew.frame == int(jnew.frame) == 1
    assert timg.shape == (108, 192, 4) and bool(torch.isfinite(timg).all())
    if shader_delay:
        for f in PLANES:
            np.testing.assert_array_equal(getattr(tnew, f).numpy(),
                                          getattr(tps, f).numpy())
        np.testing.assert_allclose(_img(timg), _img(jimg), rtol=0, atol=2e-4)
        # warm-up draws the ramp, not white: slow particles are blue
        r, g, b = timg[..., 0], timg[..., 1], timg[..., 2]
        lit = b > 0.5
        assert bool(lit.any()) and bool(torch.all(b[lit] > 4 * g[lit]))
        assert float(r.max()) < 1e-6
    else:
        _compare(jnew, tnew, dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-2))
        np.testing.assert_allclose(_img(timg), _img(jimg), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("frame", [0, 6])
def test_render_plane_state_matches_jax(frame):
    """White in warm-up (sum rule 3), the ramp after (sum rule 1)."""
    js, jp, jps, ts, tp, tps, jrs, trs = _setup(4, vmax=60.0, shader_delay=5,
                                                frame=frame)
    want = JR.render_plane_state(jps, jp, js, jrs, bounds_static=BOUNDS)
    got = R.render_plane_state(tps, tp, ts, trs, bounds_static=BOUNDS)
    np.testing.assert_allclose(_img(got), _img(want), rtol=0, atol=2e-4)
    rgb = got[..., :3]
    assert bool((rgb.amax(-1) > 0.9).any())
    grey = bool(torch.all((rgb - rgb[..., :1]).abs() < 1e-5))
    assert grey == (frame <= tp.shader_delay)


def test_unfused_tail_matches_jax():
    js, jp, jps, ts, tp, tps, _, _ = _setup(5, gravity=400.0)
    jnew = JR.plane_step(jps, jp, js, fuse_tail=False)
    tnew = R.plane_step(tps, tp, ts, fuse_tail=False)
    _compare(jnew, tnew, dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-2))


def test_fused_tail_matches_unfused_tail():
    """Six live frames each way in the port (tests/test_rebin.py:636-661)."""
    _, _, _, ts, tp, tps, _, _ = _setup(6, n=700, gravity=600.0)
    a = b = tps
    for _ in range(6):
        a = R.plane_step(a, tp, ts, fuse_tail=False)
        b = R.plane_step(b, tp, ts, fuse_tail=True)
    assert int(a.lost) == int(b.lost) == 0
    _compare(a, b, dict(rtol=0, atol=1e-4), dict(rtol=0, atol=1e-3))


def test_fused_tail_bit_equal_when_all_deferred():
    """Every live slot moves three cells: all are deferred, take no walk sums,
    and both tails give the same bits (tests/test_rebin.py:664-683)."""
    _, _, _, ts, tp, tps, _, _ = _setup(7, n=256)
    fast = dataclasses.replace(
        tps, vx=torch.where(tps.live, 3.0 * ts.cell_width / tp.dt, 0.0), frame=10)
    a = R.plane_step(fast, tp, ts, fuse_tail=False)
    b = R.plane_step(fast, tp, ts, fuse_tail=True)
    assert int(b.live.sum()) == int(tps.live.sum())
    for f in PLANES:
        np.testing.assert_array_equal(getattr(b, f).numpy(), getattr(a, f).numpy(),
                                      err_msg=f)


def test_model_render_and_step_and_render_match_jax():
    """SPHFluid.render (the plane route, and the general splat under a camera)
    and step_and_render on device='cpu' against the JAX model on the same
    carried state."""
    _, _, jps, _, _, tps, jrs, trs = _setup(8, gravity=0.0)
    jm = JSPHFluid.create(n=300, bounds=BOUNDS, capacity=16, backend="pallas",
                          render_spec=jrs)
    tm = SPHFluid.create(n=300, bounds=BOUNDS, capacity=16, device="cpu",
                         render_spec=trs)
    assert tm.grid == GridSpec.from_bounds(BOUNDS, 9.0, 16)
    jp = jm.default_params()._replace(particle_size=jnp.float32(1.5))
    tp = tm.default_params().replace(particle_size=1.5)
    np.testing.assert_allclose(_img(tm.render(tps, tp)), _img(jm.render(jps, jp)),
                               rtol=0, atol=2e-4)
    cam = (10.0, 5.0, 1.25)
    np.testing.assert_allclose(
        _img(tm.render(tps, tp, camera=cam)),
        _img(jm.render(jps, jp, camera=jnp.asarray(cam, jnp.float32))), rtol=0, atol=2e-4)
    jps = dataclasses.replace(jps, frame=jnp.asarray(5, jnp.int32))
    tps = dataclasses.replace(tps, frame=5)
    jnew, jimg = jm.step_and_render(jps, jp)
    tnew, timg = tm.step_and_render(tps, tp)
    _compare(jnew, tnew, dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-2))
    np.testing.assert_allclose(_img(timg), _img(jimg), rtol=1e-3, atol=1e-3)
