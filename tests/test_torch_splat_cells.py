"""Port vs JAX: the cell-binned splat ``splat_cells`` (K11's plain version on
the CPU) against ``splat_pallas`` (the Pallas kernel in interpret mode).

The geometry is tests/test_pallas_splat.py's: 192 x 108 pixels, capacity 16.
Bars: rtol/atol 1e-5 against ``splat_pallas`` with an equal overflow count,
and 1e-4 against the port's scatter ``splat`` where nothing overflowed (the
JAX test's own bar, tests/test_pallas_splat.py:38).  Under a camera, JAX's
jit contracts the pixel transform ``w/2 + (x - cx) * s`` into a fused
multiply-add, 1 ulp away from the op-by-op value; the camera case draws
positions on a 1/64 lattice, where the transform is exact both ways.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.render import RenderSpec as JRenderSpec
from rust_particle_system_tpu.render.splat_pallas import splat_pallas
from rust_particle_system_tpu_torch.render import RenderSpec, splat, splat_cells
from rust_particle_system_tpu_torch.render.splat_cells import raster_cells

BOUNDS = (-96.0, 96.0, -54.0, 54.0)
SPEC = RenderSpec(width=192, height=108, max_radius_px=4)
CAMERA = (5.0, -3.0, 1.5)


@functools.lru_cache(maxsize=None)
def _jbounds():
    return jnp.asarray(BOUNDS, jnp.float32)


def _check(pos, color, size=3.0, camera=None, capacity=16):
    """Port vs splat_pallas (and vs splat when nothing overflowed); returns
    the overflow count."""
    pos, color = np.asarray(pos, np.float32), np.asarray(color, np.float32)
    jcam = None if camera is None else jnp.asarray(camera, jnp.float32)
    want, jover = splat_pallas(jnp.asarray(pos), jnp.asarray(color), jnp.float32(size),
                               _jbounds(), JRenderSpec(192, 108, 4), capacity=capacity,
                               return_overflow=True, camera=jcam)
    got, over = splat_cells(torch.from_numpy(pos), torch.from_numpy(color), size, BOUNDS,
                            SPEC, capacity=capacity, return_overflow=True, camera=camera)
    assert tuple(got.shape) == (108, 192, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert int(over) == int(jover)
    if int(over) == 0:
        scatter = splat(torch.from_numpy(pos), torch.from_numpy(color), size, BOUNDS, SPEC,
                        camera=camera)
        np.testing.assert_allclose(got.numpy(), scatter.numpy(), rtol=1e-4, atol=1e-4)
    return int(over)


def _cloud(rng, n, lo=(-96.0, -54.0), hi=(96.0, 54.0)):
    pos = np.stack([rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n)], -1)
    color = rng.random((n, 4))
    color[:, 3] = 1.0
    return pos, color


def test_single_particle():
    assert _check([[0.0, 0.0]], [[1.0, 0.2, 0.1, 1.0]]) == 0


def test_random_cloud(rng):
    assert _check(*_cloud(rng, 500)) == 0


def test_edge_and_offscreen_particles():
    pos = [[-96.0, -54.0], [96.0, 54.0], [1e4, 0.0], [-96.0, 54.0], [-200.0, -80.0]]
    assert _check(pos, np.ones((5, 4))) == 0


def test_cell_boundaries():
    """Particles exactly on 8-pixel render-cell boundaries (x) and on pixel
    centres and edges (y)."""
    xs = np.linspace(-96, 96, 25)[:-1]
    pos = np.stack([xs, np.resize([0.0, 0.4, 8.0, -8.0], xs.size)], -1)
    assert _check(pos, np.tile([[0.3, 0.8, 0.5, 1.0]], (xs.size, 1))) == 0


def test_camera(rng):
    """Camera (5, -3, 1.5) (tests/test_render.py:170-173), a cloud inside
    the view plus a few particles outside it, on a 1/64 lattice."""
    pos, color = _cloud(rng, 400, (-55.0, -33.0), (64.0, 30.0))
    pos[:3] = [[200.0, 0.0], [-70.0, 40.0], [5.0, -3.0]]
    pos = np.round(pos * 64.0) / 64.0
    assert _check(pos, color, size=2.0, camera=CAMERA) == 0


def test_crammed_cell_overflow_counted(rng):
    """40 particles inside one render cell at capacity 16: 24 are left out,
    in sort order, as JAX leaves them out."""
    pos = np.float32([0.1, 0.1]) + rng.uniform(0.0, 0.6, (40, 2))
    color = rng.random((40, 4))
    assert _check(pos, color) == 24


def test_radius_beyond_margin_raises():
    with pytest.raises(ValueError, match="margin"):
        splat_cells(torch.zeros((1, 2)), torch.ones((1, 4)), 3.0, BOUNDS,
                    RenderSpec(width=192, height=108, max_radius_px=5))


def test_kernel_wrapper_rejects_other_devices():
    px = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        raster_cells(px, px, torch.zeros((3, 4), device="meta"), None, None, 8, 8,
                     (2.4, 0.6))
