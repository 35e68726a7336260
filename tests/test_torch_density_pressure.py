"""The density walk with the pressure terms in its epilogue.

``density_pressure_planes`` (K2's pressure epilogue) and
``density_pressure_pairs`` (K6's) give the force walk's per-slot terms
(P1, NPo, NPn) straight from the walk.  They must be ``pressure_terms`` of
``density_planes`` / ``density_pairs`` bit for bit: the kernel rounds the
terms op by op in torch's order, so the frame's trajectory is the one the
composition gave.

On the CPU the fused wrappers run the plain composition, and the frame's
``_neighbour_side`` (which walks through them) is held to the explicit
composition on one device and on a two-band gloo mesh.  On a card the
kernels are held to the composition of the card's own density walk and
torch's terms, over both layouts, ghost rows or none, C in {16, 128, 1024}
and uniform, crowded and sparse planes with dead and deferred slots; those
cases skip without a card.  This module imports only the port (the mesh's
ranks import it), so on the card it runs with
``python -m pytest --noconftest tests/test_torch_density_pressure.py``.
"""

import functools

import numpy as np
import pytest
import torch

from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.ops.cuda import sph
from rust_particle_system_tpu_torch.ops.cuda.rebin import SENTINEL
from rust_particle_system_tpu_torch.ops.cuda.resident import walk_positions
from rust_particle_system_tpu_torch.ops.cuda.sph_step import _neighbour_side
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.parallel import run_bands
from rust_particle_system_tpu_torch.parallel.halo import halo_rows

H = 9.0
GEOMS = {  # C: bounds (gw x gh cells of 9.0)
    16: (-90.0, 90.0, -45.0, 45.0),  # 21 x 11
    128: (-54.0, 54.0, -36.0, 36.0),  # 13 x 9
    1024: (-18.0, 18.0, -18.0, 18.0),  # 5 x 5
}
PLANES = {  # name: (share of slots live, drift in cells)
    "uniform": (0.4, 0.3),
    "crowded": (1.0, 0.05),
    "sparse": (0.05, 0.3),
}
LAYOUTS = {False: (sph.density_planes, sph.density_pressure_planes),
           True: (sph.density_pairs, sph.density_pressure_pairs)}


def _planes(capacity, kind, seed=0, device="cpu"):
    """(spec, params, npx, npy, vx, vy, wx, wy): planes whose slots are live
    at the share ``kind`` gives (the rest dead), each particle in its cell
    jittered by up to the drift, so some sit outside it; the walk planes
    (wx, wy) park those (deferred)."""
    bounds = GEOMS[capacity]
    fill, drift = PLANES[kind]
    spec = GridSpec.from_bounds(bounds, H, capacity)
    params = make_params(bounds=bounds, gravity=300.0)
    rng = np.random.default_rng(seed)
    shape = (spec.gh, spec.gw, capacity)
    live = rng.random(shape) < fill
    jitter = lambda: (rng.random(shape) * 2 - 1) * drift
    cx = np.arange(spec.gw)[None, :, None] + rng.random(shape) + jitter()
    cy = np.arange(spec.gh)[:, None, None] + rng.random(shape) + jitter()
    x = np.clip(spec.x_min + cx * spec.cell_width, bounds[0], bounds[1])
    y = np.clip(spec.y_min + cy * spec.cell_size, bounds[2], bounds[3])
    npx, npy, vx, vy = (torch.as_tensor(a.astype(np.float32), device=device) for a in (
        np.where(live, x, SENTINEL), np.where(live, y, SENTINEL),
        np.where(live, rng.standard_normal(shape) * 20, 0.0),
        np.where(live, rng.standard_normal(shape) * 20, 0.0)))
    wx, wy = walk_positions(npx, npy, spec)
    return spec, params, npx, npy, vx, vy, wx, wy


def _slab(p, r0, R, fill):
    """Rows [r0 - 1, r0 + R] of ``p``: a band's own rows with a ghost row on
    each side, the fill past the grid's edges."""
    edge = torch.full_like(p[0], fill)
    lo = p[r0 - 1] if r0 >= 1 else edge
    hi = p[r0 + R] if r0 + R < p.shape[0] else edge
    return torch.cat([lo[None], p[r0:r0 + R], hi[None]])


def _walk_planes(wx, wy, ghost):
    """The walk planes as given, or the lower band's slab (its top ghost row
    a row of the grid, its bottom one the fill)."""
    if not ghost:
        return wx, wy
    R = max(1, wx.shape[0] // 2)
    return _slab(wx, 0, R, SENTINEL), _slab(wy, 0, R, SENTINEL)


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32, i
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f"plane {i}"


@pytest.mark.parametrize("ghost", [False, True])
@pytest.mark.parametrize("pair", [False, True])
def test_fused_wrapper_is_the_composition_on_cpu(pair, ghost):
    """For CPU tensors the fused wrapper runs ``pressure_terms`` of the plain
    density walk; dead and deferred slots get the terms of rho = rhon = 0."""
    _, params, npx, _, _, _, wx, wy = _planes(16, "uniform")
    assert bool(((npx < 0.5 * SENTINEL) & ~(wx < 0.5 * SENTINEL)).any())  # some deferred
    density, fused = LAYOUTS[pair]
    px, py = _walk_planes(wx, wy, ghost)
    got = fused(px, py, params, ghost=ghost)
    _assert_bit_equal(got, sph.pressure_terms(*density(px, py, params, ghost=ghost), params))
    parked = ~((px[1:-1] if ghost else px) < 0.5 * SENTINEL)
    zero = sph.pressure_terms(torch.zeros(1), torch.zeros(1), params)
    for g, z in zip(got, zero):
        assert torch.equal(g[parked], z.expand(int(parked.sum())))


def _composed_neighbour_side(wx, wy, vx, vy, pack2, params, halo):
    """``_neighbour_side`` written out: the walk planes grown by the halo,
    the density walk, ``pressure_terms``, then P1 and NPn grown."""
    grown = (lambda planes, fills: list(planes)) if halo is None else halo
    gx, gy, gvx, gvy = grown((wx, wy, vx, vy), (SENTINEL, SENTINEL, 0.0, 0.0))
    rho, rhon = LAYOUTS[pack2][0](gx, gy, params, ghost=halo is not None)
    P1, NPo, NPn = sph.pressure_terms(rho, rhon, params)
    P1, NPn = grown((P1, NPn), (0.0, 0.0))
    return [gx, gy, P1, NPn, gvx, gvy, NPo]


@pytest.mark.parametrize("pack2", [False, True])
def test_neighbour_side_is_the_composition(pack2):
    """One device: the force walk's six neighbour-side planes and NPo."""
    _, params, _, _, vx, vy, wx, wy = _planes(16, "uniform", seed=1)
    spec = GridSpec.from_bounds(GEOMS[16], H, 16, pack2=pack2)
    nbr, NPo = _neighbour_side(wx, wy, vx, vy, spec, params, None)
    _assert_bit_equal([*nbr, NPo],
                      _composed_neighbour_side(wx, wy, vx, vy, pack2, params, None))


def _band_neighbour_side(mesh, planes):
    """One rank of a two-band gloo world: its rows of the walk planes through
    ``_neighbour_side`` with the mesh's halo, and through the composition
    written out with the same halo, in both layouts."""
    wx, wy, vx, vy = planes
    R = wx.shape[0] // mesh.size
    rows = slice(mesh.rank * R, (mesh.rank + 1) * R)
    own = [p[rows].contiguous() for p in (wx, wy, vx, vy)]
    params = make_params(bounds=GEOMS[16], gravity=300.0)
    halo = functools.partial(halo_rows, mesh=mesh)
    out = {}
    for pack2 in (False, True):
        spec = GridSpec.from_bounds(GEOMS[16], H, 16, pack2=pack2)
        nbr, NPo = _neighbour_side(*own, spec, params, halo)
        out[pack2] = ([*nbr, NPo], _composed_neighbour_side(*own, pack2, params, halo))
    return out


def test_neighbour_side_is_the_composition_on_two_gloo_bands():
    """On a two-band gloo mesh each rank's planes (own rows, ghost rows from
    the exchanges) equal the composition's, and the ghost rows are the other
    band's edge rows: the halo still grows P1 and NPn."""
    spec, _, _, _, vx, vy, wx, wy = _planes(16, "uniform", seed=2)
    R = spec.gh // 2  # two bands of R rows: the grid's last row left out if gh is odd
    planes = tuple(p[:2 * R] for p in (wx, wy, vx, vy))
    outs = run_bands(_band_neighbour_side, 2, backend="gloo", device="cpu", timeout=90.0,
                     args=(planes,))
    for pack2 in (False, True):
        for got, want in (out[pack2] for out in outs):
            _assert_bit_equal(got, want)
            assert got[2].shape[0] == R + 2 and got[6].shape[0] == R
        lower, upper = outs[0][pack2][0], outs[1][pack2][0]
        for i in (0, 1, 2, 3, 4, 5):  # px, py, P1, NPn, vx, vy
            assert torch.equal(lower[i][-1], upper[i][1])  # the lower band's top ghost row
            assert torch.equal(upper[i][0], lower[i][-2])  # the upper band's bottom one


# ---------------- on the card ----------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the density walk's pressure epilogue runs on a CUDA card only")
    return "cuda"


@pytest.mark.parametrize("kind", list(PLANES))
@pytest.mark.parametrize("capacity", list(GEOMS))
@pytest.mark.parametrize("ghost", [False, True])
@pytest.mark.parametrize("pair", [False, True])
def test_pressure_epilogue_is_bit_equal_on_the_card(card, pair, ghost, capacity, kind):
    """The kernel's (P1, NPo, NPn) equal ``pressure_terms`` of the card's own
    density walk on the same planes, bit for bit, dead and deferred slots
    included."""
    _, params, npx, _, _, _, wx, wy = _planes(capacity, kind, seed=capacity, device=card)
    live = npx < 0.5 * SENTINEL
    walk_live = wx < 0.5 * SENTINEL
    assert bool((live & ~walk_live).any())  # deferred slots
    assert kind == "crowded" or bool((~live).any())  # dead slots
    density, fused = LAYOUTS[pair]
    px, py = _walk_planes(wx, wy, ghost)
    got = fused(px, py, params, ghost=ghost)
    want = sph.pressure_terms(*density(px, py, params, ghost=ghost), params)
    torch.cuda.synchronize()
    _assert_bit_equal(got, want)
