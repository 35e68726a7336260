"""Port vs JAX: the band rebin K7 (its plain version) against the JAX
``_rebin_v6_band`` in interpret mode, K9's band mode (the variant-5 passes
with ghost rows, a global row offset and adoption from the neighbour bands)
against the JAX ``_hole_fill_pass`` and ``_retention_merge``, and the walks
on a band's slab with ghost rows against the port's walks on the whole plane.

Values only move in a rebin, so K7 is held bit for bit: to JAX per band, and
to the port's K1 on the whole plane once the bands are put together.  Edge
bands get ghost rows past the grid's edges; whatever those hold (zeros, as a
ppermute delivers, the fills, as the port's mesh delivers, or arbitrary
values) must not change a bit.  The walks on a slab sum over other chunk
lengths than on the whole plane, so they are held at the JAX tests' bars:
density rtol 1e-5, positions rtol/atol 1e-4, velocities rtol 1e-4 / atol 1e-2
(tests/test_pallas_sph.py:38-40); parked and dead slots exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rebin import _demo_planes

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas.rebin import (_hole_fill_pass, _rebin_v6_band,
                                                       _retention_merge)
from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.ops.cuda import sph
from rust_particle_system_tpu_torch.ops.cuda.rebin import (
    SENTINEL, hole_fill_pass, rebin_planes_band, rebin_planes_plain, retention_merge)
from rust_particle_system_tpu_torch.ops.cuda.resident import walk_positions
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.parallel import BandMesh, make_plane_sharded_step

GEOM = dict(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=8, capacity=16)
FILLS = (SENTINEL, SENTINEL, 0.0, 0.0, 0.0)


@functools.lru_cache(maxsize=None)
def _jax_band_rebin(R: int):
    """JAX ``_rebin_v6_band`` for ``R``-row slabs of GEOM, jitted once (row0
    traced), so that interpret mode compiles one program per slab height."""
    spec = JGridSpec(**GEOM)
    return jax.jit(lambda slab, row0, lo2, lo1, hi1: _rebin_v6_band(
        slab, spec, FILLS, row0, lo2, lo1, hi1, interpret=True))


def _planes(rng, drift, empty_rows=()):
    planes = [np.asarray(p).copy() for p in
              _demo_planes(rng, JGridSpec(**GEOM), GEOM["capacity"], 0.7, drift, k=5)]
    for r in empty_rows:
        for c, f in enumerate(FILLS):
            planes[c][r] = f
    return planes


def _ghosts(planes, r0, R, edge):
    """(lo2, lo1, hi1) of the band at rows [r0, r0 + R): the true rows, or
    ``edge(c)`` past the grid's edges."""
    gh = planes[0].shape[0]
    row = lambda c, r: planes[c][r] if 0 <= r < gh else edge(c)
    return ([row(c, r0 - 2) for c in (0, 1)],
            [row(c, r0 - 1) for c in range(len(planes))],
            [row(c, r0 + R) for c in range(len(planes))])


def _port_band(planes, r0, R, ghosts):
    t = lambda rows: [torch.from_numpy(np.ascontiguousarray(a)) for a in rows]
    out, counts = rebin_planes_band(t([p[r0:r0 + R] for p in planes]), GridSpec(**GEOM),
                                    FILLS, r0, *(t(g) for g in ghosts))
    return [o.numpy() for o in out], counts.numpy()


def _check_bands(planes, n_bands):
    """Every band of K7 (plain) bit-equal to JAX's band rebin and, put
    together, to the port's K1 on the whole plane.  Returns the K1 planes."""
    full, fcounts = rebin_planes_plain([torch.from_numpy(p) for p in planes],
                                       GridSpec(**GEOM), FILLS)
    R = GEOM["gh"] // n_bands
    zeros = np.zeros((GEOM["gw"], GEOM["capacity"]), np.float32)
    got, got_counts = [], []
    for b in range(n_bands):
        r0 = b * R
        ghosts = _ghosts(planes, r0, R, lambda c: zeros)
        out, counts = _port_band(planes, r0, R, ghosts)
        want, wcounts = _jax_band_rebin(R)(
            [jnp.asarray(p[r0:r0 + R]) for p in planes], jnp.asarray(r0, jnp.int32),
            *([jnp.asarray(a) for a in g] for g in ghosts))
        for c in range(len(planes)):
            np.testing.assert_array_equal(out[c], np.asarray(want[c]),
                                          err_msg=f"band {b} channel {c}")
        np.testing.assert_array_equal(counts, np.asarray(wcounts))
        got.append(out)
        got_counts.append(counts)
    for c in range(len(planes)):
        np.testing.assert_array_equal(np.concatenate([g[c] for g in got]), full[c].numpy())
    np.testing.assert_array_equal(np.concatenate(got_counts), fcounts.numpy())
    return [f.numpy() for f in full]


@pytest.mark.parametrize("drift", [0.4, 0.9, 1.8])
@pytest.mark.parametrize("n_bands", [2, 4, 8])
def test_band_rebin_matches_jax_and_k1(rng, drift, n_bands):
    """tests/test_rebin.py:598-633 in the port, plus 8 bands of one row each
    (R = 1: the row0-2 ghost lives two bands down)."""
    _check_bands(_planes(rng, drift), n_bands)


@pytest.mark.parametrize("n_bands", [2, 4])
def test_band_rebin_air_rows(n_bands):
    """Rows 2, 3 and 5 of 8 start empty: with 4 bands one band is all air and
    rows 2 and 3 turn live from their neighbour bands' edge rows; row 5 turns
    live from rows 4 and 6 inside a band or across a boundary."""
    planes = _planes(np.random.default_rng(1), 0.9, empty_rows=(2, 3, 5))
    out = _check_bands(planes, n_bands)
    live = out[0] < 0.5 * SENTINEL
    assert live[2].any() and live[3].any() and live[5].any()


@pytest.mark.parametrize("n_bands", [2, 8])
def test_band_rebin_edge_ghosts_never_read(rng, n_bands):
    """The edge bands' ghost rows past the grid hold zeros, the fills, or
    arbitrary values (positions inside the grid, large velocities): K7's
    output is the same to the bit, and JAX agrees with arbitrary ghosts."""
    planes = _planes(rng, 1.8)
    R = GEOM["gh"] // n_bands
    shape = (GEOM["gw"], GEOM["capacity"])
    junk_rng = np.random.default_rng(7)
    junk = [junk_rng.uniform(-100.0, 100.0, shape).astype(np.float32) for _ in range(5)]
    edges = {"zeros": lambda c: np.zeros(shape, np.float32),
             "fills": lambda c: np.full(shape, FILLS[c], np.float32),
             "arbitrary": lambda c: junk[c]}
    for r0 in (0, GEOM["gh"] - R):  # the two edge bands
        results = {k: _port_band(planes, r0, R, _ghosts(planes, r0, R, e))
                   for k, e in edges.items()}
        for k in ("fills", "arbitrary"):
            for a, b in zip(results[k][0] + [results[k][1]],
                            results["zeros"][0] + [results["zeros"][1]]):
                np.testing.assert_array_equal(a, b, err_msg=f"{k} ghosts at row {r0}")
        ghosts = _ghosts(planes, r0, R, edges["arbitrary"])
        want, wcounts = _jax_band_rebin(R)(
            [jnp.asarray(p[r0:r0 + R]) for p in planes], jnp.asarray(r0, jnp.int32),
            *([jnp.asarray(a) for a in g] for g in ghosts))
        for a, b in zip(results["arbitrary"][0], want):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(results["arbitrary"][1], np.asarray(wcounts))


def test_band_rebin_rejects_bad_slabs():
    spec = GridSpec(**GEOM)
    row = torch.zeros((GEOM["gw"], GEOM["capacity"]))
    slab = [torch.full((2, GEOM["gw"], GEOM["capacity"]), SENTINEL) for _ in range(5)]
    with pytest.raises(ValueError):  # rows past the grid
        rebin_planes_band(slab, spec, FILLS, GEOM["gh"] - 1, [row] * 2, [row] * 5, [row] * 5)
    with pytest.raises(ValueError):  # lo2 carries x and y only
        rebin_planes_band(slab, spec, FILLS, 0, [row] * 5, [row] * 5, [row] * 5)


def test_sharded_rebin_variant_5_names_k9():
    """The sharded step runs rebin variants 5 (K9) and 6 (K7); any other raises."""
    mesh = BandMesh(group=None, size=2, rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="variant 5 or 6"):
        make_plane_sharded_step(GridSpec(**GEOM), mesh, rebin_variant=4)


# ---------------- K9 in band mode (the sharded step's variant 5) ----------------

BAND_R = 2
BAND_NC = BAND_R * GEOM["gw"]
BAND_PAD = 128 - BAND_NC  # JAX pads the flat planes to 128 cells


@functools.lru_cache(maxsize=None)
def _jax_band_passes(lossless: bool):
    """JAX pass Y on a BAND_R-row band (ghost rows, row0 traced, pad cells
    masked by nc_valid) and, lossless, its retention merge with adoption from
    elsewhere, then pass X and its adoption mask; jitted once per mode."""
    spec, gw = JGridSpec(**GEOM), GEOM["gw"]

    def run(flats, ghosts, row0, extra):
        mid, cnt, acc = _hole_fill_pass(flats, spec, FILLS, gw, True, True, lossless,
                                        ghosts=ghosts, row_offset=row0, nc_valid=BAND_NC)
        if not lossless:
            return mid, cnt
        merged = _retention_merge(flats, mid, acc, spec, gw, True, row_offset=row0,
                                  extra_adopted=extra)
        out, cnt2, acc2 = _hole_fill_pass(merged, spec, FILLS, 1, False, True, True,
                                          row_offset=row0, nc_valid=BAND_NC)
        return mid, cnt, acc, merged, out, cnt2, acc2

    return jax.jit(run)


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("row0", [0, 2, 6])
def test_band_hole_fill_pass_matches_jax(rng, lossless, row0):
    """K9's pass Y (plain) on rows [row0, row0 + 2) of 8, its ghost rows the
    true neighbour rows (the fills past the grid, as the port's mesh gives
    them), then, lossless, the retention merge with adoption made elsewhere
    and the band-local pass X: planes, counts and adoption masks bit-equal to
    JAX on the band padded to 128 cells."""
    gw, C = GEOM["gw"], GEOM["capacity"]
    planes = _planes(rng, 1.8)
    ghosts = _ghosts(planes, row0, BAND_R, lambda c: np.full((gw, C), FILLS[c], np.float32))
    pairs = list(zip(ghosts[1], ghosts[2]))  # (row0 - 1, row0 + R) of each channel
    flats = [p[row0:row0 + BAND_R].reshape(BAND_NC, C) for p in planes]
    extra = np.random.default_rng(3).random((BAND_NC, C)) < 0.5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    spec = GridSpec(**GEOM)
    want = _jax_band_passes(lossless)(
        [jnp.concatenate([jnp.asarray(f), jnp.full((BAND_PAD, C), fl, jnp.float32)])
         for f, fl in zip(flats, FILLS)],
        [(jnp.asarray(lo), jnp.asarray(hi)) for lo, hi in pairs],
        jnp.asarray(row0, jnp.int32),
        jnp.concatenate([jnp.asarray(extra, jnp.float32), jnp.zeros((BAND_PAD, C))]))
    want = [np.asarray(w)[:BAND_NC] for w in jax.tree_util.tree_leaves(want)]
    got_mid, got_cnt, got_acc = hole_fill_pass(
        [t(f) for f in flats], spec, FILLS, gw, True, lossless,
        [(t(lo), t(hi)) for lo, hi in pairs], row0)
    got = [*got_mid, got_cnt]
    if lossless:
        merged = retention_merge([t(f) for f in flats], got_mid, got_acc, spec, gw, True,
                                 row0, t(extra))
        out, cnt, acc = hole_fill_pass(merged, spec, FILLS, 1, False, True, None, row0)
        got += [got_acc, *merged, *out, cnt, acc]
        want = [w > 0.5 if w.shape[-1] == 2 * C else w for w in want]
    else:
        assert got_acc is None
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")


# ---------------- walks on a band's slab with ghost rows ----------------

WALK_BOUNDS = (-90.0, 90.0, -36.0, 36.0)  # 21 x 9 cells of 9.0


def _walk_inputs(rng, pack2: bool):
    """Rebinned-looking planes (some particles deferred) and the walks' full
    inputs on the whole plane: walk positions, pressure terms, velocities."""
    spec = GridSpec.from_bounds(WALK_BOUNDS, 9.0, 16, pack2=pack2)
    params = make_params(bounds=WALK_BOUNDS, gravity=300.0)
    js = JGridSpec.from_bounds(WALK_BOUNDS, 9.0, 16)
    npx, npy = (torch.from_numpy(np.asarray(p).copy())
                for p in _demo_planes(rng, js, 16, 0.5, 0.4, k=2))
    live = npx < 0.5 * SENTINEL
    vx = torch.where(live, torch.from_numpy(rng.standard_normal(npx.shape)).float() * 20, 0.0)
    vy = torch.where(live, torch.from_numpy(rng.standard_normal(npx.shape)).float() * 20, 0.0)
    fpx, fpy = walk_positions(npx, npy, spec)
    density = sph.density_pairs if pack2 else sph.density_planes
    P1, NPo, NPn = sph.pressure_terms(*density(fpx, fpy, params), params)
    return spec, params, dict(px=fpx, py=fpy, P1=P1, NPn=NPn, vx=vx, vy=vy, NPo=NPo,
                              npx=npx, npy=npy)


def _with_ghosts(p, r0, R, fill):
    """Rows [r0 - 1, r0 + R] of ``p``, the fill past the grid's edges."""
    gh = p.shape[0]
    edge = torch.full_like(p[0], fill)
    lo = p[r0 - 1] if r0 >= 1 else edge
    hi = p[r0 + R] if r0 + R < gh else edge
    return torch.cat([lo[None], p[r0:r0 + R], hi[None]])


@pytest.mark.parametrize("walk", ["density", "fused", "raw"])
@pytest.mark.parametrize("pack2", [False, True])
def test_band_walks_match_whole_plane(rng, walk, pack2):
    """Each band's walk over its slab with the true ghost rows (the fills past
    the edges) equals the whole-plane walk on its rows: 3 bands of 3 rows and
    9 bands of 1 row over gh = 9, classic (K2/K3/K3b) and pair-packed (K6)."""
    spec, params, x = _walk_inputs(rng, pack2)
    assert spec.gh == 9 and spec.gw % 2 == 1
    nbr_fills = dict(px=SENTINEL, py=SENTINEL, P1=0.0, NPn=0.0, vx=0.0, vy=0.0)
    own_names = {"density": (), "fused": ("NPo", "npx", "npy"), "raw": ("NPo",)}[walk]
    nbr_names = ("px", "py") if walk == "density" else tuple(nbr_fills)
    fn = {("density", False): sph.density_planes, ("density", True): sph.density_pairs,
          ("fused", False): sph.force_planes_integrated,
          ("fused", True): sph.force_pairs_integrated,
          ("raw", False): sph.force_planes, ("raw", True): sph.force_pairs}[walk, pack2]
    whole = fn(*(x[k] for k in nbr_names + own_names), params)
    walk_live = x["px"] < 0.5 * SENTINEL
    live = x["npx"] < 0.5 * SENTINEL
    for R in (3, 1):
        for r0 in range(0, spec.gh, R):
            rows = slice(r0, r0 + R)
            band = fn(*(_with_ghosts(x[k], r0, R, nbr_fills[k]) for k in nbr_names),
                      *(x[k][rows] for k in own_names), params, ghost=True)
            for i, (b, w) in enumerate(zip(band, whole)):
                w, wl, lv = w[rows], walk_live[rows], live[rows]
                assert b.shape == w.shape
                if walk == "density":
                    torch.testing.assert_close(b[wl], w[wl], rtol=1e-5, atol=0)
                    assert torch.equal(b[~wl], w[~wl])
                elif walk == "fused":
                    atol = 1e-4 if i < 2 else 1e-2
                    torch.testing.assert_close(b[lv], w[lv], rtol=1e-4, atol=atol)
                    parked = ~lv | ~wl  # dead and deferred slots take no walk sums
                    assert torch.equal(b[parked], w[parked])
                else:  # the raw sums through the velocity update they feed
                    scal = sph.force_scalars(params)
                    scale = scal[2] if i < 2 else scal[3]
                    torch.testing.assert_close(b[wl] * scale, w[wl] * scale,
                                               rtol=1e-4, atol=1e-2)
                    assert torch.equal(b[~wl], w[~wl])


def test_walk_ghost_shapes_checked(rng):
    spec, params, x = _walk_inputs(rng, False)
    with pytest.raises(ValueError):  # own-side planes must be the own rows
        sph.force_planes(*(x[k][:5] for k in ("px", "py", "P1", "NPn", "vx", "vy")),
                         x["NPo"][:5], params, ghost=True)


@pytest.mark.parametrize("n_bands,pack2", [(4, False), (8, True), (1, False)])
def test_make_shard_spec_matches_jax_grid(n_bands, pack2):
    """The grid padded to the bands equals the ``grid`` of JAX make_shard_spec
    (its stream-mesh fields are not ported)."""
    from rust_particle_system_tpu.parallel.shard import make_shard_spec as jshard_spec
    from rust_particle_system_tpu_torch.parallel import make_shard_spec

    bounds = (-960.0, 960.0, -540.0, 540.0)
    cap = 64 if pack2 else 128
    got = make_shard_spec(bounds, 9.0, cap, n_bands, pack2=pack2)
    want = jshard_spec(bounds, 9.0, 1000, n_bands, capacity=cap, pack2=pack2).grid
    assert got.gh % n_bands == 0 and got.gh - n_bands < 121 <= got.gh
    for f in ("x_min", "y_min", "cell_size", "gw", "gh", "capacity", "cell_w", "pack2"):
        assert getattr(got, f) == getattr(want, f), f
