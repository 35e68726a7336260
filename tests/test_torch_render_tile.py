"""K4, the plane render (csrc/splat_planes.cu), on the CPU.

The kernel runs only on the card.  Its geometry is fixed in its source, and
these tests read it from there (the tile and block constants, the grid, the
block-to-pixel mapping, the cell windows, the rounds' slot count and the
shared bytes), as tests/test_torch_strip_walk.py reads csrc/sph.cu, and hold
it on the CPU at the main path's 1920x1080 at 9-px strides, radius 2 with
margin 3, the v1 geometry (90x180, sy = 36), a grid that ends left of the
image's right edge and an odd-sized image: every image pixel is owned by
exactly one lane, a block's window holds every cell whose patch meets one of
its pixels, and a block's shared bytes fit one H100 block for every C.

Then numpy models of the kernel's arithmetic, each rounded op by op in
float32 as the kernel's _rn intrinsics round it: the staged values are
bit-equal to what the plain version stages (``raster_inputs``); the cull
keeps every (slot, pixel) pair whose plain alpha is non-zero, and the model's
walk over the culled lists gives the plain accumulators; alpha is exactly 0
at and above r^2, checked densely with nextafter.  Last, the entry (``raster_planes``, its plain
composition here) against the JAX package's ``splat_from_planes`` in
interpret mode, in the three colour modes and both epilogues, at
tests/test_torch_render.py's bars.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.render import splat_jax as J
from rust_particle_system_tpu.render import splat_planes as JP
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.render import RenderSpec
from rust_particle_system_tpu_torch.render import splat_planes as TP

SRC = (Path(TP.__file__).resolve().parent.parent / "csrc" / "splat_planes.cu").read_text()
SHMEM_LIMIT = 232_448  # shared bytes one H100 block may use
F = np.float32


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


CONSTS = {n: _const(n) for n in ("kTileW", "kTileH", "kBlockTilesX", "kBlockTilesY",
                                 "kMaxRoundSlots")}
CONSTS["kWarps"] = CONSTS["kBlockTilesX"] * CONSTS["kBlockTilesY"]
CONSTS["kBlockW"] = CONSTS["kBlockTilesX"] * CONSTS["kTileW"]
CONSTS["kBlockH"] = CONSTS["kBlockTilesY"] * CONSTS["kTileH"]
SHMEM_BUDGET = eval(re.search(r"constexpr int kShmemBudget = (.*?);", SRC).group(1))


def _py(expr: str) -> str:
    """A C integer expression of the kernel as Python: the struct prefixes
    and casts dropped, '/' as the floor division it is on these operands."""
    expr = re.sub(r"static_cast<\w+>", "", expr)
    expr = re.sub(r"\b(k|a)\.", "", expr).replace("blockIdx.", "block_")
    return "(" + " ".join(expr.replace("/", "//").split()) + ")"


def _one(pattern: str) -> str:
    found = re.findall(pattern, SRC, re.S)
    assert len(found) == 1, (pattern, found)
    return found[0]


def _c_div(a, b):
    """C's integer division (truncates toward zero)."""
    q = np.abs(a) // np.abs(b)
    return np.where((np.asarray(a) < 0) != (np.asarray(b) < 0), -q, q)


FLOOR_DIV = _one(r"inline int floor_div\(int a, int b\) \{\s*// b > 0\s*return (.*?);")
assert FLOOR_DIV == "a >= 0 ? a / b : -((b - 1 - a) / b)"


def floor_div(a, b):
    a = np.asarray(a)
    return np.where(a >= 0, _c_div(a, b), -_c_div(b - 1 - a, b))


def ceil_div(a, b):
    assert "return -floor_div(-a, b);" in SRC
    return -floor_div(-np.asarray(a), b)


RANGES = {name: _py(_one(rf"inline int {name}\(int (?:lo|hi), const Render& k\) \{{\s*"
                         r"return (.*?);"))
          for name in ("first_col", "last_col", "first_row", "last_row")}
GRID = [_py(e) for e in _one(r"const dim3 grid\((.*?), (.*?)\);")]
BX0, BY0 = (_py(e) for e in _one(r"const int bx0 = (.*?), by0 = (.*?);"))
TX0, TY0 = _py(_one(r"const int tx0 = (.*?);")), _py(_one(r"const int ty0 = (.*?);"))
PX, PY = (_py(e) for e in _one(r"const int x = (tx0 .*?), y = (ty0 .*?);"))
MY, NCX, NCY = (_py(_one(rf"k\.{n} = (.*?);")) for n in ("my", "ncx", "ncy"))
TILE_CELLS = _py(_one(r"const int tile_cells = (.*?);"))
SHMEM = _py(_one(r"size_t render_shmem\(int ncol, int nwin, int S, int list_cap\) \{\s*"
                 r"return (.*?);"))


class Geometry:
    """One render geometry and the kernel's launch quantities for it, each
    evaluated from the expression the source holds."""

    def __init__(self, H, W, sx, sy, m, gh, gw):
        self.H, self.W, self.sx, self.sy, self.m, self.gh, self.gw = H, W, sx, sy, m, gh, gw
        self.pw, self.ph = sx + 2 * m, sy + 2 * m
        env = self.env()
        self.my = eval(MY, {}, env)
        env = self.env()
        self.ncx, self.ncy = eval(NCX, {}, env), eval(NCY, {}, env)
        self.tile_cells = eval(TILE_CELLS, {}, env)

    def env(self, **kw):
        return dict(CONSTS, H=self.H, W=self.W, sx=self.sx, sy=self.sy, m=self.m,
                    gh=self.gh, gw=self.gw, pw=self.pw, ph=self.ph,
                    my=getattr(self, "my", None), floor_div=floor_div, ceil_div=ceil_div,
                    **kw)

    def cells(self, name, v):
        return eval(RANGES[name], {}, self.env(lo=v, hi=v))

    def round_slots(self, C: int, ncol: int) -> int:
        """S as the launch picks it (the two loops of rps_splat_planes)."""
        assert "while (S > 1 && S / 2 >= a.C) S /= 2;" in SRC
        assert ("while (S > 1 && render_shmem(ncol, k.ncx * k.ncy, S, tile_cells * S) > "
                "kShmemBudget) S /= 2;") in SRC
        S = CONSTS["kMaxRoundSlots"]
        while S > 1 and S // 2 >= C:
            S //= 2
        while S > 1 and self.shmem(ncol, S) > SHMEM_BUDGET:
            S //= 2
        return S

    def shmem(self, ncol: int, S: int) -> int:
        return eval(SHMEM, {}, dict(CONSTS, ncol=ncol, nwin=self.ncx * self.ncy, S=S,
                                    list_cap=self.tile_cells * S))


GEOMETRIES = {  # (H, W, sx, sy, margin, gh, gw)
    "main 1080p, 9-px strides": (1080, 1920, 9, 9, 4, 121, 214),
    "radius 2, margin 3": (1080, 1920, 9, 9, 3, 121, 214),
    "v1 90x180, sy 36": (180, 90, 9, 36, 3, 5, 10),
    "grid ends left of the right edge": (45, 100, 9, 9, 4, 5, 10),
    "odd-sized image": (37, 53, 9, 9, 4, 5, 6),
    "3-px strides": (45, 90, 3, 3, 1, 15, 30),
}


def test_floor_div_floors():
    a = np.arange(-50, 51)
    for b in (1, 2, 3, 9, 36):
        assert np.array_equal(floor_div(a, b), a // b)
        assert np.array_equal(ceil_div(a, b), -((-a) // b))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_every_pixel_is_owned_by_one_lane(name):
    g = Geometry(*GEOMETRIES[name])
    gx, gy = (eval(e, {}, g.env()) for e in GRID)
    bx, by, warp, lane = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(CONSTS["kWarps"]),
                                     np.arange(32), indexing="ij")
    env = g.env(block_x=bx, block_y=by, warp=warp, lane=lane)
    env["bx0"], env["by0"] = eval(BX0, {}, env), eval(BY0, {}, env)
    env["tx0"], env["ty0"] = eval(TX0, {}, env), eval(TY0, {}, env)
    x, y = eval(PX, {}, env), eval(PY, {}, env)
    inside = (x < g.W) & (y < g.H)
    owned = np.zeros((g.H, g.W), int)
    np.add.at(owned, (y[inside], x[inside]), 1)
    assert np.all(owned == 1), np.argwhere(owned != 1)[:5]


def _meeting(lo: int, hi: int, n: int, stride: int, shift: int, size: int) -> list:
    """By brute force, the cells c in 0..n-1 (and beyond, to show the range
    formula's clip) whose patch [c*stride - shift, c*stride - shift + size)
    meets [lo, hi]."""
    return [c for c in range(-3, n + 3) if c * stride - shift <= hi
            and c * stride - shift + size - 1 >= lo]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_windows_hold_every_cell_that_reaches_a_pixel(name):
    """The column and row ranges of the source are exactly the cells whose
    patches meet a block or a tile; a block's window (ncx x ncy cells from
    its first) holds them, and a tile's cells fit its list (tile_cells)."""
    g = Geometry(*GEOMETRIES[name])
    bw = CONSTS["kBlockW"]
    for bx0 in range(0, g.W, bw):
        want = _meeting(bx0, bx0 + bw - 1, g.gw, g.sx, g.m, g.pw)
        lo, hi = g.cells("first_col", bx0), g.cells("last_col", bx0 + bw - 1)
        assert list(range(lo, hi + 1)) == want and hi - lo + 1 <= g.ncx
        for tx0 in range(bx0, bx0 + bw, CONSTS["kTileW"]):
            tlo = g.cells("first_col", tx0)
            thi = g.cells("last_col", tx0 + CONSTS["kTileW"] - 1)
            assert tlo >= lo and thi <= hi
    ncy_tile = (CONSTS["kTileH"] + g.ph - 2) // g.sy + 1
    ncx_tile = (CONSTS["kTileW"] + g.pw - 2) // g.sx + 1
    assert g.tile_cells == ncx_tile * ncy_tile
    for by0 in range(0, g.H, CONSTS["kBlockH"]):
        by1 = by0 + CONSTS["kBlockH"] - 1
        want = _meeting(by0, by1, g.gh, g.sy, g.my, g.ph)
        lo, hi = g.cells("first_row", by0), g.cells("last_row", by1)
        assert list(range(lo, hi + 1)) == want and hi - lo + 1 <= g.ncy
        for ty0 in range(by0, by1 + 1, CONSTS["kTileH"]):
            tlo = g.cells("first_row", ty0)
            thi = g.cells("last_row", ty0 + CONSTS["kTileH"] - 1)
            assert thi - tlo + 1 <= ncy_tile and tlo >= lo and thi <= hi
    for tx0 in range(0, g.W, CONSTS["kTileW"]):
        tlo = g.cells("first_col", tx0)
        assert g.cells("last_col", tx0 + CONSTS["kTileW"] - 1) - tlo + 1 <= ncx_tile
    # Top-down row tr has its patch top at tr*sy - my: world row gh-1-tr's
    # H - (wr+1)*sy - m.
    for tr in range(g.gh):
        assert tr * g.sy - g.my == g.H - (g.gh - tr) * g.sy - g.m


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_shared_bytes_fit_for_every_capacity(name):
    """Every C >= 1 launches: the rounds' slot count S halves until a block's
    shared bytes fit the budget, which is below what one H100 block may use;
    and the 16-bit list entries address every staged slot."""
    g = Geometry(*GEOMETRIES[name])
    assert SHMEM_BUDGET <= SHMEM_LIMIT
    assert "if (shmem > 227 * 1024 || k.ncx * k.ncy * S > 65536)" in SRC
    for ncol in (0, 2, 3):  # white, sum rule, four channels
        for C in list(range(1, 300)) + [512, 1000, 1024, 4096, 100_000]:
            S = g.round_slots(C, ncol)
            assert 1 <= S <= CONSTS["kMaxRoundSlots"] and (S >= min(C, 64) or
                                                           g.shmem(ncol, 2 * S) > SHMEM_BUDGET)
            assert g.shmem(ncol, S) <= SHMEM_LIMIT and g.ncx * g.ncy * S <= 65536


def test_main_path_shape():
    """At the main path a block stages 16 cells of 64 slots a round and takes
    ~34 KB, so shared memory leaves room for several blocks an SM."""
    g = Geometry(*GEOMETRIES["main 1080p, 9-px strides"])
    assert (g.ncx, g.ncy, g.tile_cells) == (4, 4, 9)
    assert g.round_slots(128, 2) == 64 and g.shmem(2, 64) < 40_000


# ---------------------------------------------------------------------------
# numpy models of the kernel's arithmetic

def _geo(bounds, cell, C, rs, margin, size):
    spec = GridSpec.from_bounds(bounds, cell, C)
    return spec, TP.render_geometry(bounds, spec, rs, margin, size)


def _planes(rng, spec, fill, drift, vmax=40.0):
    """[gh, gw, C] planes: each slot live with probability ``fill``, at a
    position in its cell jittered by up to ``drift`` cells; dead slots at
    SENTINEL.  Live slots are not packed at the front."""
    gh, gw, C = spec.gh, spec.gw, spec.capacity
    live = rng.random((gh, gw, C)) < fill
    cx = np.arange(gw)[None, :, None] + rng.random((gh, gw, C))
    cy = np.arange(gh)[:, None, None] + rng.random((gh, gw, C))
    x = spec.x_min + (cx + (rng.random((gh, gw, C)) * 2 - 1) * drift) * spec.cell_width
    y = spec.y_min + (cy + (rng.random((gh, gw, C)) * 2 - 1) * drift) * spec.cell_size
    v = rng.standard_normal((2, gh, gw, C)) * vmax
    return [np.where(live, a, b).astype(F) for a, b in
            ((x, TP.FAR), (y, TP.FAR), (v[0], 0.0), (v[1], 0.0))]


def _stage(planes, geometry, max_energy, clamp):
    """The kernel's staging of every slot: (live, qx, qy, x0, y0, r, g, b),
    each [gh, gw, C], rounded op by op as csrc/splat_planes.cu rounds it."""
    px, py, vx, vy = planes
    (H, W, sx, sy, m), (radius, _, _), (x_min, y_max, sxs, sys_) = geometry
    gh, gw, _ = px.shape
    my = gh * sy - H + m
    live = px < F(0.5) * F(TP.FAR)
    x0 = (np.arange(gw) * sx - m).astype(F)[None, :, None]
    y0 = ((gh - 1 - np.arange(gh)) * sy - my).astype(F)[:, None, None]
    with np.errstate(over="ignore", invalid="ignore"):
        qx = (px - F(x_min)) * F(sxs) - x0
        qy = (F(y_max) - py) * F(sys_) - y0
        if clamp:
            r = F(radius)
            qx = np.where(qx > F(0.1) * F(TP.FAR), qx,
                          np.minimum(np.maximum(qx, r), F(sx + 2 * m) - r))
            qy = np.where(qy > F(0.1) * F(TP.FAR), qy,
                          np.minimum(np.maximum(qy, r), F(sy + 2 * m) - r))
        s = vx * vx + vy * vy
        t = np.clip(F(0.5) * s / F(max_energy), F(0), F(1))
        lo, hi = t * F(2), (t - F(0.5)) * F(2)
        low = t < F(0.5)
        rgb = (np.where(low, F(0), hi), np.where(low, lo, F(1) - hi),
               np.where(low, F(1) - lo, F(0)))
    xb, yb = np.broadcast_to(x0, px.shape), np.broadcast_to(y0, px.shape)
    return live, qx, qy, xb, yb, rgb


def _plain_alpha(d2, scal):
    """raster_planes_plain's alpha of float32 d^2 values, by the same torch
    ops."""
    _, edge0, inv_w = scal
    d = torch.sqrt(torch.from_numpy(np.asarray(d2, F)))
    tt = ((d - edge0) * inv_w).clamp(0.0, 1.0)
    alpha = 1.0 - tt * tt * (3.0 - 2.0 * tt)
    return torch.where(alpha < 0.01, 0.0, alpha).numpy()


CASES = {  # bounds, cell, C, render spec, margin, particle size
    "9-px cells, r 3, m 4": ((0.0, 90.0, 0.0, 45.0), 9.0, 24, RenderSpec(90, 45, 4), 4, 3.0),
    "r 2, m 3": ((0.0, 90.0, 0.0, 45.0), 9.0, 24, RenderSpec(90, 45, 2), 3, 2.0),
    "v1, sy 36": ((0.0, 90.0, 0.0, 45.0), 9.0, 24, RenderSpec(90, 180, 2), 3, 2.0),
    "odd image, scale 0.5": ((0.0, 106.0, 0.0, 74.0), 18.0, 24, RenderSpec(53, 37, 4), 4, 5.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_staged_values_equal_the_plain_inputs(case, rng):
    """The model of the kernel's staging (world -> pixel, then patch
    coordinates; the energy ramp with a true division) is bit-equal to
    raster_inputs' pixel planes and colours at every live slot."""
    bounds, cell, C, rs, margin, size = CASES[case]
    spec, geometry = _geo(bounds, cell, C, rs, margin, size)
    planes = _planes(rng, spec, 0.5, 0.9)
    live, qx, qy, x0, y0, rgb = _stage(planes, geometry, 300.0, clamp=False)
    t = [torch.from_numpy(p) for p in planes]
    ppx, ppy, cols, _, _ = TP.raster_inputs(
        *t, torch.from_numpy(live), size, 300.0, bounds_static=bounds, grid_spec=spec,
        render_spec=rs, margin=margin)
    assert live.sum() > 100
    _, _, (x_min, y_max, sxs, sys_) = geometry
    mx = (planes[0] - F(x_min)) * F(sxs)
    my_ = (F(y_max) - planes[1]) * F(sys_)
    assert np.array_equal(mx[live].view(np.int32), ppx.numpy()[live].view(np.int32))
    assert np.array_equal(my_[live].view(np.int32), ppy.numpy()[live].view(np.int32))
    assert np.array_equal((mx - x0)[live].view(np.int32), qx[live].view(np.int32))
    for c, want in zip(rgb, cols):
        assert np.array_equal(c[live].view(np.int32), want.numpy()[live].view(np.int32))


def _tile_of(x, y):
    return x // CONSTS["kTileW"] * CONSTS["kTileW"], y // CONSTS["kTileH"] * CONSTS["kTileH"]


def _pairs(stage, geometry):
    """Every (slot, patch pixel inside the image) pair of the live slots:
    flat slot index, image x, y, dx, dy (float32, as the plain version forms
    them), and the plain alpha."""
    live, qx, qy, x0, y0, _ = stage
    (H, W, sx, sy, m), scal, _ = geometry
    ph, pw = sy + 2 * m, sx + 2 * m
    idx = np.flatnonzero(live)
    j, i = np.meshgrid(np.arange(pw), np.arange(ph))
    X = x0.reshape(-1)[idx, None, None].astype(int) + j
    Y = y0.reshape(-1)[idx, None, None].astype(int) + i
    dx = (j + F(0.5)).astype(F) - qx.reshape(-1)[idx, None, None]
    dy = (i + F(0.5)).astype(F) - qy.reshape(-1)[idx, None, None]
    inside = (X >= 0) & (X < W) & (Y >= 0) & (Y < H)
    s = np.broadcast_to(idx[:, None, None], X.shape)
    d2 = dx * dx + dy * dy
    return s[inside], X[inside], Y[inside], d2[inside], _plain_alpha(d2[inside], scal)


def _kept(stage, geometry, slots, X, Y):
    """The kernel's cull: does the tile of pixel (X, Y) keep slot ``slots``?
    The slot's cell must have a patch meeting the tile (its staged list), and
    the squared distance from the slot's centre to the box of the tile's
    pixel centres must be below cull2, in float32."""
    _, qx, qy, x0, y0, _ = stage
    (H, W, sx, sy, m), (radius, _, _), _ = geometry
    tw, th = CONSTS["kTileW"], CONSTS["kTileH"]
    tx0, ty0 = _tile_of(X, Y)
    cx0, cy0 = x0.reshape(-1)[slots].astype(int), y0.reshape(-1)[slots].astype(int)
    pw, ph = sx + 2 * m, sy + 2 * m
    meets = ((cx0 <= tx0 + tw - 1) & (cx0 + pw - 1 >= tx0)
             & (cy0 <= ty0 + th - 1) & (cy0 + ph - 1 >= ty0))
    assert "k.cull2 = k.r2 * (1.0f + 1.0f / 1024.0f);" in SRC
    cull2 = F(radius) * F(radius) * (F(1) + F(1) / F(1024))
    gx, gy = qx.reshape(-1)[slots], qy.reshape(-1)[slots]
    ux0 = (tx0 - cx0).astype(F) + F(0.5)
    uy0 = (ty0 - cy0).astype(F) + F(0.5)
    bx = gx - np.minimum(np.maximum(gx, ux0), ux0 + F(tw - 1))
    by = gy - np.minimum(np.maximum(gy, uy0), uy0 + F(th - 1))
    with np.errstate(over="ignore", invalid="ignore"):
        return meets & (bx * bx + by * by < cull2)


@pytest.mark.parametrize("drift", [0.3, 1.7])
@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_the_cull_keeps_every_pair_that_draws(case, clamp, drift, rng):
    """Centres clamped and not, with drift past the margin: every (slot,
    pixel) pair whose plain alpha is non-zero is kept by the pixel's tile and
    has d^2 < r^2; with clamping, every pair with d^2 < r^2 lies in the
    slot's patch (so the walk needs no patch test there)."""
    bounds, cell, C, rs, margin, size = CASES[case]
    spec, geometry = _geo(bounds, cell, C, rs, margin, size)
    stage = _stage(_planes(rng, spec, 0.4, drift), geometry, 300.0, clamp)
    slots, X, Y, d2, alpha = _pairs(stage, geometry)
    r2 = F(geometry[1][0]) * F(geometry[1][0])
    draws = alpha != 0
    assert draws.sum() > 1000
    assert np.all(d2[draws] < r2)
    assert np.all(_kept(stage, geometry, slots[draws], X[draws], Y[draws]))
    kept = _kept(stage, geometry, slots, X, Y)
    assert kept.mean() < 0.7  # the cull drops most of the patch
    if clamp:
        # every pixel centre within the radius of a clamped centre lies in
        # the slot's patch: d^2 >= r^2 on the 3-px ring around the patch
        live, qx, qy, _, _, _ = stage
        (_, _, sx, sy, m), _, _ = geometry
        pw, ph = sx + 2 * m, sy + 2 * m
        j, i = np.meshgrid(np.arange(-3, pw + 3), np.arange(-3, ph + 3))
        ring = (j < 0) | (j >= pw) | (i < 0) | (i >= ph)
        dx = (j[ring] + F(0.5)).astype(F)[None] - qx[live][:, None]
        dy = (i[ring] + F(0.5)).astype(F)[None] - qy[live][:, None]
        assert np.all(dx * dx + dy * dy >= r2)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_the_walk_over_culled_lists_gives_the_plain_accumulators(case, clamp, rng):
    """The model of the walk: each pixel sums, over its tile's kept slots,
    the alpha of those with d^2 < r^2 and, without clamping, only inside the
    slot's patch.  Its alpha and colour accumulators agree with
    raster_planes_plain's."""
    bounds, cell, C, rs, margin, size = CASES[case]
    spec, geometry = _geo(bounds, cell, C, rs, margin, size)
    planes = _planes(rng, spec, 0.4, 1.2)
    stage = _stage(planes, geometry, 300.0, clamp)
    (H, W, sx, sy, m), scal, _ = geometry
    slots, X, Y, d2, _ = _pairs(stage, geometry)
    hit = _kept(stage, geometry, slots, X, Y) & (d2 < F(scal[0]) * F(scal[0]))
    a = _plain_alpha(d2, scal)[hit]
    acc = np.zeros((2, H, W))
    np.add.at(acc[1], (Y[hit], X[hit]), a)
    np.add.at(acc[0], (Y[hit], X[hit]), a * stage[5][0].reshape(-1)[slots[hit]])
    want = TP.raster_planes_composed(*(torch.from_numpy(p) for p in planes), geometry, 300.0,
                                     color_sum=1.0, clamp_drift=clamp, background=None)
    assert want[2].sum() > 100
    np.testing.assert_allclose(acc[1], want[2].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(acc[0], want[0].numpy(), rtol=1e-5, atol=1e-5)


def _ulps(v, n: int, step: int) -> np.ndarray:
    """``v`` (a positive float32) and the ``n`` float32 values after it, up
    (``step`` 1) or down (-1)."""
    return (np.asarray(v, F).view(np.int32) + step * np.arange(n + 1, dtype=np.int32)).view(F)


@pytest.mark.parametrize("size,scale", [(2.0, 1.0), (3.0, 1.0), (4.0, 1.0), (3.0, 1.37),
                                        (2.5, 0.75)])
def test_alpha_is_zero_from_r2(size, scale):
    """With raster_scalars' radius, edge and width, the plain alpha is exactly
    0 for every d^2 at or above r^2 (the walk's early-out), densely above r^2
    and on a sweep to 40 r^2; below r^2 it is not 0 everywhere."""
    scal = TP.raster_scalars(size, scale)
    r = F(scal[0])
    r2 = r * r
    assert "k.r2 = a.radius * a.radius;" in SRC
    above = np.concatenate([_ulps(r2, 200_000, 1),
                            np.geomspace(float(r2), float(r2) * 40, 10_000).astype(F)])
    above = above[above >= r2]
    assert np.all(_plain_alpha(above, scal) == 0)
    assert np.all(_plain_alpha(_ulps(np.nextafter(r2, F(0)), 2_000, -1), scal) == 0)
    assert _plain_alpha(np.asarray([r2 * F(0.9)]), scal)[0] > 0


# ---------------------------------------------------------------------------
# the entry against JAX

def _binned(rng, h, w, n, C=8):
    """Particles binned by hand into [gh, gw, C] planes (the
    tests/test_torch_render.py convention), four image edges covered, with
    velocities for the ramp."""
    spec = JGridSpec.from_bounds((0.0, float(w), 0.0, float(h)), 9.0, capacity=C)
    pos = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1).astype(F)
    pos[:4] = [[0.4, 0.4], [0.4, h - 0.4], [w - 0.4, 0.4], [w - 0.4, h - 0.4]]
    planes = [np.full((spec.gh, spec.gw, C), TP.FAR, F) for _ in range(2)]
    planes += [np.zeros((spec.gh, spec.gw, C), F) for _ in range(2)]
    occ = np.zeros((spec.gh, spec.gw), np.int32)
    vel = rng.standard_normal((n, 2)).astype(F) * 25.0
    for (x, y), (u, v) in zip(pos, vel):
        cx = min(int(x / spec.cell_width), spec.gw - 1)
        cy = min(int(y / spec.cell_size), spec.gh - 1)
        k = occ[cy, cx]
        if k < C:
            for p, val in zip(planes, (x, y, u, v)):
                p[cy, cx, k] = val
            occ[cy, cx] = k + 1
    return planes


MODES = {"ramp": (None, 1.0), "white": (TP.WHITE, 3.0), "given": ("given", None)}


@pytest.mark.parametrize("epilogue", ["image", "accumulators"])
@pytest.mark.parametrize("mode", list(MODES))
def test_the_entry_matches_jax(mode, epilogue, rng):
    """raster_planes (its plain composition on the CPU) against JAX
    splat_from_planes: the ramp under sum rule 1, white under sum rule 3,
    given colours in four channels; the image, or the accumulators (JAX
    resolve=False); drift clamped.  Bars: tests/test_torch_render.py's 1e-4."""
    h, w, rs, margin = 45, 90, (90, 45, 2), 3
    planes = _binned(rng, h, w, 300)
    live = planes[0] < 0.5 * TP.FAR
    bounds = (0.0, float(w), 0.0, float(h))
    colors, color_sum = MODES[mode]
    if colors == "given":
        colors = tuple(np.where(live, rng.random(live.shape), 0.0).astype(F) for _ in range(3))
    jcols = (tuple(np.ones_like(planes[0]) for _ in range(3)) if colors is TP.WHITE
             else colors)
    want = JP.splat_from_planes(
        *(jnp.asarray(p) for p in planes), jnp.asarray(live), 2.0, 300.0,
        bounds_static=bounds, grid_spec=JGridSpec.from_bounds(bounds, 9.0, capacity=8),
        render_spec=J.RenderSpec(*rs), margin=margin, resolve=epilogue == "image",
        colors=None if jcols is None else tuple(jnp.asarray(c) for c in jcols),
        color_sum=None if color_sum is None else jnp.float32(color_sum), clamp_drift=True)
    geometry = TP.render_geometry(bounds, GridSpec.from_bounds(bounds, 9.0, 8),
                                  RenderSpec(*rs), margin, 2.0)
    got = TP.raster_planes(
        *(torch.from_numpy(p) for p in planes), geometry, 300.0,
        colors=colors if not isinstance(colors, tuple) else
        tuple(torch.from_numpy(c) for c in colors), color_sum=color_sum, clamp_drift=True,
        background=TP.BLACK if epilogue == "image" else None)
    if epilogue == "accumulators":
        assert tuple(got.shape) == (3 if color_sum else 4, h, w)
        got = TP.accumulators(got, color_sum)
        pairs = list(zip(got, want))
    else:
        assert tuple(got.shape) == (h, w, 4)
        pairs = [(got, want)]
    assert float(pairs[-1][0].sum()) > 50.0
    for g_, w_ in pairs:
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-4)


def test_splat_from_planes_parks_slots_outside_live(rng):
    """splat_from_planes honours its live mask (it parks the other slots at
    FAR before K4, which keys liveness on px), as JAX does."""
    h, w, rs = 45, 90, (90, 45, 2)
    planes = _binned(rng, h, w, 300)
    live = (planes[0] < 0.5 * TP.FAR) & (rng.random(planes[0].shape) < 0.5)
    bounds = (0.0, float(w), 0.0, float(h))
    want = JP.splat_from_planes(
        *(jnp.asarray(p) for p in planes), jnp.asarray(live), 2.0, 300.0,
        bounds_static=bounds, grid_spec=JGridSpec.from_bounds(bounds, 9.0, capacity=8),
        render_spec=J.RenderSpec(*rs), margin=2, color_sum=jnp.float32(1.0))
    got = TP.splat_from_planes(
        *(torch.from_numpy(p) for p in planes), torch.from_numpy(live), 2.0, 300.0,
        bounds_static=bounds, grid_spec=GridSpec.from_bounds(bounds, 9.0, 8),
        render_spec=RenderSpec(*rs), margin=2, color_sum=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
