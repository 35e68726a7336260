"""Port vs JAX: the general splat (render/splat.py) and the plane rasterizer
(render/splat_planes.py, K4's plain version) against the JAX package, the
Pallas rasterizer in interpret mode.

Bars: the general splat agrees with ``splat_jax`` to 1e-5; ``to_srgb_u8``
within 1 LSB; the plane accumulators to rtol/atol 1e-4
(tests/test_pallas_splat.py:111-114), the sum rule at that file's :168-171
bars.  The K10 case is a geometry JAX sends to its v1 kernel (patch height
40 > 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.render import splat_jax as J
from rust_particle_system_tpu.render import splat_planes as JP
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.render import RenderSpec, splat, splat_accumulate, to_srgb_u8
from rust_particle_system_tpu_torch.render import splat_planes as TP

BOUNDS = (-96.0, 96.0, -54.0, 54.0)
SPEC = (192, 108, 4)


def _cloud(rng, n=500):
    pos = np.stack([rng.uniform(-96, 96, n), rng.uniform(-54, 54, n)], -1)
    color = rng.random((n, 4))
    color[:, 3] = 1.0
    return pos.astype(np.float32), color.astype(np.float32)


def _splat_case(name, rng):
    if name == "single":
        return np.zeros((1, 2), np.float32), np.asarray([[1.0, 0.2, 0.1, 1.0]], np.float32)
    if name == "edges_offscreen":
        pos = np.asarray([[-96.0, -54.0], [96.0, 54.0], [1e4, 0.0], [-96.0, 54.0],
                          [-1e4, 0.0], [95.9, -53.9]], np.float32)
        return pos, np.ones((len(pos), 4), np.float32)
    return _cloud(rng)


@pytest.mark.parametrize("case", ["single", "cloud", "edges_offscreen"])
@pytest.mark.parametrize("camera", [None, (5.0, -3.0, 1.5), (10.0, 5.0, 2.0)])
def test_splat_matches_jax(rng, case, camera):
    pos, color = _splat_case(case, rng)
    w, h, r = SPEC
    size = 1.0 if camera is not None and camera[2] > 1.5 else 2.0 if camera else 3.0
    jspec, tspec = J.RenderSpec(w, h, r), RenderSpec(w, h, r)
    jcam = None if camera is None else jnp.asarray(camera, jnp.float32)
    jb = jnp.asarray(BOUNDS, jnp.float32)
    jrgb, ja = J.splat_accumulate(jnp.asarray(pos), jnp.asarray(color), jnp.float32(size),
                                  jb, jspec, jcam)
    trgb, ta = splat_accumulate(torch.from_numpy(pos), torch.from_numpy(color), size,
                                  BOUNDS, tspec, camera)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=0, atol=1e-5)
    got = splat(torch.from_numpy(pos), torch.from_numpy(color), size, BOUNDS, tspec,
                camera=camera)
    # J.splat is jitted, and XLA on the CPU contracts the camera transform
    # into a fused multiply-add (an ulp of px), which the resolve's division
    # by a small coverage amplifies.  The eager composition of the same two
    # JAX functions has no such contraction; the jitted one is held where no
    # contraction can happen (the identity camera).
    want = J.splat_resolve(jrgb, ja)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if camera is None:
        want = J.splat(jnp.asarray(pos), jnp.asarray(color), jnp.float32(size), jb, jspec)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if case == "single" and camera is None:
        np.testing.assert_allclose(got.numpy()[54, 96], [1.0, 0.2, 0.1, 1.0], atol=1e-5)


def test_to_srgb_u8_within_one_lsb(rng):
    img = rng.uniform(-0.1, 1.1, (37, 53, 4)).astype(np.float32)
    img[0, :4, :3] = np.asarray([0.0, 0.0031308, 0.5, 1.0])[:, None]  # the knee
    want = np.asarray(J.to_srgb_u8(jnp.asarray(img))).astype(int)
    got = to_srgb_u8(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and got.shape == img.shape
    assert np.abs(got.numpy().astype(int) - want).max() <= 1


def _binned(rng, h, w, n, C=8):
    """Particles binned by hand into [gh, gw, C] planes (test_pallas_splat.py
    convention), four image edges and the left margin columns covered."""
    spec = JGridSpec.from_bounds((0.0, float(w), 0.0, float(h)), 9.0, capacity=C)
    pos = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1).astype(np.float32)
    pos[:8] = [[0.4, 0.4], [0.4, h - 0.4], [w - 0.4, 0.4], [w - 0.4, h - 0.4],
               [1.5, h / 2], [w / 2, 1.5], [0.1, 7.0], [6.9, 0.1]]
    ppx = np.full((spec.gh, spec.gw, C), 1.0e6, np.float32)
    ppy = np.full_like(ppx, 1.0e6)
    occ = np.zeros((spec.gh, spec.gw), np.int32)
    for x, y in pos:
        cx = min(int(x / spec.cell_width), spec.gw - 1)
        cy = min(int(y / spec.cell_size), spec.gh - 1)
        k = occ[cy, cx]
        if k < C:
            ppx[cy, cx, k], ppy[cy, cx, k] = x, y
            occ[cy, cx] = k + 1
    return ppx, ppy


def _both_planes(ppx, ppy, bounds, rs, colors, **kw):
    """(port, JAX) splat_from_planes accumulators on the same planes."""
    live = ppx < 0.5e6
    z = np.zeros_like(ppx)
    js = JGridSpec.from_bounds(bounds, 9.0, capacity=ppx.shape[-1])
    ts = GridSpec.from_bounds(bounds, 9.0, ppx.shape[-1])
    jkw = dict(kw)
    if kw.get("color_sum") is not None:
        jkw["color_sum"] = jnp.float32(kw["color_sum"])
    want = JP.splat_from_planes(
        jnp.asarray(ppx), jnp.asarray(ppy), jnp.asarray(z), jnp.asarray(z),
        jnp.asarray(live), 2.0, 300.0, bounds_static=bounds, grid_spec=js,
        render_spec=J.RenderSpec(*rs), resolve=False,
        colors=tuple(jnp.asarray(c) for c in colors), **jkw)
    got = TP.splat_from_planes(
        torch.from_numpy(ppx), torch.from_numpy(ppy), torch.from_numpy(z),
        torch.from_numpy(z), torch.from_numpy(live), 2.0, 300.0, bounds_static=bounds,
        grid_spec=ts, render_spec=RenderSpec(*rs), resolve=False,
        colors=tuple(torch.from_numpy(c) for c in colors), **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("h,w,rs,margin", [
    (45, 90, (90, 45, 2), 2),    # 13 px patches (JAX v2, 16-lane rows)
    (45, 90, (90, 45, 2), 4),    # 17 px patches (JAX v2, 32-lane rows)
    (45, 90, (90, 180, 2), 2),   # sy = 36, ph = 40 > 32: JAX v1 (K10)
])
def test_splat_from_planes_matches_jax(rng, h, w, rs, margin):
    ppx, ppy = _binned(rng, h, w, 300)
    col = np.where(ppx < 0.5e6, 0.6, 0.0).astype(np.float32)
    bounds = (0.0, float(w), 0.0, float(h))
    (trgb, ta), (jrgb, ja) = _both_planes(ppx, ppy, bounds, rs, (col, col, col),
                                          margin=margin)
    assert ta.shape == (rs[1], rs[0]) and ta.sum() > 100.0
    np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(trgb, jrgb, rtol=1e-4, atol=1e-4)
    # ... and both against the scatter-add oracle on the binned particles
    kept = ppx.reshape(-1) < 0.5e6
    pos = np.stack([ppx.reshape(-1)[kept], ppy.reshape(-1)[kept]], -1)
    colk = np.broadcast_to(np.asarray([0.6, 0.6, 0.6, 1.0], np.float32), (len(pos), 4))
    orgb, oa = splat_accumulate(torch.from_numpy(pos), torch.from_numpy(colk.copy()),
                                  2.0, bounds, RenderSpec(*rs))
    np.testing.assert_allclose(ta, oa.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(trgb, orgb.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("color_sum", [1.0, 3.0])
def test_sum_rule_matches_jax(rng, color_sum):
    """The 3-channel sum rule against JAX's and against the port's 4-channel
    accumulators (bars of test_pallas_splat.py:168-171)."""
    ppx, ppy = _binned(rng, 45, 90, 400)
    live = ppx < 0.5e6
    r = rng.uniform(0, color_sum, ppx.shape).astype(np.float32)
    g = (rng.uniform(0, 1.0, ppx.shape) * (color_sum - r)).astype(np.float32)
    b = (color_sum - r - g).astype(np.float32)
    cols = tuple(np.where(live, c, 0.0).astype(np.float32) for c in (r, g, b))
    bounds = (0.0, 90.0, 0.0, 45.0)
    (trgb3, ta3), (jrgb3, ja3) = _both_planes(ppx, ppy, bounds, (90, 45, 2), cols,
                                              margin=2, color_sum=color_sum)
    (trgb4, ta4), _ = _both_planes(ppx, ppy, bounds, (90, 45, 2), cols, margin=2)
    np.testing.assert_allclose(ta3, ja3, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trgb3, jrgb3, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(ta3, ta4, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trgb3, trgb4, rtol=1e-4, atol=2e-5)


def test_clamp_drift_preserves_sprite_mass():
    """A sprite binned into cell (2, 4) but drifted 5 px left of it renders
    clipped at its patch edge without clamp_drift and whole (displaced to the
    patch's edge) with it, as in JAX (test_pallas_splat.py:184-222)."""
    shape = (5, 10, 8)
    ppx = np.full(shape, 1.0e6, np.float32)
    ppy = np.full_like(ppx, 1.0e6)
    ppx[2, 4, 0], ppy[2, 4, 0] = 31.0, 22.5
    ref_x, ref_y = np.full_like(ppx, 1.0e6), np.full_like(ppy, 1.0e6)
    ref_x[2, 3, 0], ref_y[2, 3, 0] = 35.0, 22.5
    bounds = (0.0, 90.0, 0.0, 45.0)
    masses = {}
    for key, (x, y, clamp) in {"full": (ref_x, ref_y, False), "clipped": (ppx, ppy, False),
                               "clamped": (ppx, ppy, True)}.items():
        col = np.where(x < 0.5e6, 1.0, 0.0).astype(np.float32)
        (_, ta), (_, ja) = _both_planes(x, y, bounds, (90, 45, 2), (col, col, col),
                                        margin=3, clamp_drift=clamp)
        np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-4)
        masses[key] = float(ta.sum())
    assert masses["clipped"] < 0.8 * masses["full"]
    np.testing.assert_allclose(masses["clamped"], masses["full"], rtol=1e-5)


GEOMS = [  # (bounds, cell, capacity, render spec)
    ((-96.0, 96.0, -54.0, 54.0), 9.0, 16, (192, 108, 4)),
    ((-96.0, 96.0, -54.0, 54.0), 9.0, 16, (192, 108, 2)),
    ((-96.0, 96.0, -54.0, 54.0), 9.0, 16, (384, 216, 2)),   # 18 px strides
    ((-96.0, 96.0, -54.0, 54.0), 9.0, 16, (100, 60, 2)),    # non-integral
    ((-960.0, 960.0, -540.0, 540.0), 9.0, 128, (1920, 1080, 4)),
    ((-960.0, 960.0, -540.0, 540.0), 9.0, 128, (1920, 1080, 5)),
    ((0.0, 90.0, 0.0, 45.0), 9.0, 8, (90, 180, 2)),
    ((0.0, 90.0, 0.0, 45.0), 3.0, 8, (90, 45, 1)),          # 3 px strides
]


@pytest.mark.parametrize("bounds,cell,cap,rs", GEOMS)
def test_planes_compatible_and_margin_match_jax(bounds, cell, cap, rs):
    js = JGridSpec.from_bounds(bounds, cell, cap)
    ts = GridSpec.from_bounds(bounds, cell, cap)
    jr, tr = J.RenderSpec(*rs), RenderSpec(*rs)
    for margin in range(0, 6):
        assert TP.planes_compatible(ts, tr, bounds, margin) == \
            JP.planes_compatible(js, jr, bounds, margin)
    for pm in (None, 1, 2, 4, 6):
        assert TP.drifted_patch_margin(ts, tr, bounds, pm) == \
            JP.drifted_patch_margin(js, jr, bounds, pm)


def test_raster_rejects_other_devices():
    z = torch.zeros((2, 3, 4), device="meta")
    geometry = TP.render_geometry(BOUNDS, GridSpec.from_bounds(BOUNDS, 9.0, 4),
                                  RenderSpec(*SPEC), 4, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        TP.raster_planes(z, z, z, z, geometry, 1.0)
