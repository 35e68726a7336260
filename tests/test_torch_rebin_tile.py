"""The rebin kernel's tile (K1 and K7; csrc/rebin.cu), on the CPU.

The kernel runs only on the card.  Its geometry is fixed in its source, and
these tests read it from there (the warps, the tile's columns for each C, the
shared bytes, the grid, the block-to-column mapping of both phases) and hold
it: every own column of every own row is served exactly once (widths that are
not a multiple of the tile, gw = 1, 2 and 3, a band's slab), each block's
phase Y writes every column its phase X reads, a block's shared memory stays
within what one H100 block may use for every C the kernel takes, and the
kernel and the wrapper take the C range they took before.

The kernel tests keys against cuts, the least float that reaches a cell
(no division per slot): a cut is checked against the keying it stands for,
at its boundary and on NaN and the infinities.  Then a numpy model of the
tile's composition, block by block as the kernel runs it: phase Y's word per
mid slot of each column (its source, and its class for pass X from the cuts),
phase X's composed source (out slot <- mid slot <- input slot), and the
gather that moves each value once.  It is held bit for bit against the port's plain
version and the JAX ``rebin_planes`` (variant 6, interpret mode), at the
kernel's tile width and at the narrowest one (so that small grids have tile
edges), on the geometries of tests/test_torch_rebin.py plus a width of two
tiles, with air rows, and on band slabs with their ghost rows.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rebin import _demo_planes

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas.rebin import rebin_planes as jrebin
from rust_particle_system_tpu_torch.ops.cuda import rebin as R
from rust_particle_system_tpu_torch.ops.grid import GridSpec

SRC = (Path(R.__file__).resolve().parents[2] / "csrc" / "rebin.cu").read_text()
SHMEM_LIMIT = 232_448  # shared bytes one H100 block may use
SENTINEL = R.SENTINEL
F32 = np.float32


def _py(expr: str) -> str:
    """A C expression of rebin.cu as Python (integer division, no casts)."""
    expr = re.sub(r"static_cast<\w+>", "", expr).replace("&&", " and ")
    return expr.replace("a.", "").replace("g.", "").replace("/", "//")


def _one(pattern: str) -> str:
    found = re.findall(pattern, SRC)
    assert len(found) == 1, (pattern, found)
    return found[0]


CONSTS = {name: int(_one(rf"constexpr int {name} = (\d+);"))
          for name in ("kTileWarps", "kMaxC", "kBallots")}
CONSTS["kTileThreads"] = eval(_py(_one(r"constexpr int kTileThreads = (.*?);")), {}, CONSTS)
_TILE_COLS = _py(_one(r"constexpr int tile_cols\(int C\) \{ return (.*?); \}"))
_SHMEM = _py(" ".join(re.search(r"constexpr size_t tile_shmem\(int C\) \{\s*return (.*?);\s*\}",
                                 SRC, re.S).group(1).split()))
_T_HOST = _py(_one(r"const int T = (.*?);"))
_GRID_X = _py(_one(r"const dim3 grid\((.*?), a\.rows\);"))
_C0 = _py(_one(r"c0 = (blockIdx\.x \* T);"))
# The kernel's two phases: (first j, end of j, column of j, guard, phase).
_PHASES = [tuple(map(_py, m[:4])) + (m[4],) for m in re.findall(
    r"for \(int j = (.+?); j < (.+?); j \+= kTileWarps\) \{\s*const int c = (.+?);\s*"
    r"if \((.+?)\) (column_[xy])", SRC)]


def clamp_int(v, lo, hi):
    return max(lo, min(hi, v))


def tile_cols(C: int) -> int:
    return eval(_TILE_COLS, {"clamp_int": clamp_int}, {"C": C})


def tile_shmem(C: int) -> int:
    return eval(_SHMEM, {"tile_cols": tile_cols}, dict(CONSTS, C=C))


def tile_width(C: int) -> int:
    """T, the own columns of a block at C slots a cell (the launch's)."""
    return eval(_T_HOST, {"tile_cols": tile_cols}, {"C": C})


def _blocks(gw: int, C: int):
    """Per block x: {phase: [columns each warp's loop visits]} as the kernel
    maps them."""
    T = tile_width(C)
    out = []
    for bx in range(eval(_GRID_X, {}, {"gw": gw, "T": T})):
        c0 = eval(_C0, {}, {"blockIdx": type("B", (), {"x": bx}), "T": T})
        cols = {"column_y": [], "column_x": []}
        for j0, j1, col, guard, phase in _PHASES:
            for warp in range(CONSTS["kTileWarps"]):
                env = dict(CONSTS, warp=warp, ncols=tile_cols(C), T=T, c0=c0, gw=gw)
                j = eval(j0, {}, env)
                while j < eval(j1, {}, env):
                    c = eval(col, {}, dict(env, j=j))
                    if eval(guard, {}, dict(env, c=c)):
                        cols[phase].append(c)
                    j += CONSTS["kTileWarps"]
        out.append(cols)
    return out


def test_the_source_has_both_phases_and_two_syncs():
    assert sorted(p[4] for p in _PHASES) == ["column_x", "column_y"], _PHASES
    kernel = SRC[SRC.index("__global__ void"):SRC.index("}  // namespace")]
    assert kernel.count("__syncthreads()") == 2, "one after the cuts, one between the phases"
    assert "rebin_pass_y" not in SRC and "rebin_pass_x" not in SRC
    record = re.search(r"struct rps_rebin_args \{(.*?)\};", SRC, re.S).group(1)
    assert "mid" not in record, "pass Y's result stays in shared memory, not in a device scratch"
    assert SRC.count("<<<") == 1, "one launch a call"
    assert "const size_t shmem = tile_shmem(a.C);" in SRC
    assert CONSTS["kTileThreads"] == 32 * CONSTS["kTileWarps"]


@pytest.mark.parametrize("gw", [1, 2, 3, 11, 13, 14, 29, 30, 31, 214])
@pytest.mark.parametrize("C", [16, 128, 200, 1024])
def test_every_own_column_is_served_once(gw, C):
    """Every column of a row is served by exactly one phase-X warp of one
    block, and that block's phase Y wrote each column c-2..c+1 inside the grid,
    each once."""
    served = np.zeros(gw, dtype=int)
    for blk in _blocks(gw, C):
        ys = blk["column_y"]
        assert len(ys) == len(set(ys)) and all(0 <= c < gw for c in ys), ys
        for c in blk["column_x"]:
            served[c] += 1
            need = {d for d in range(c - 2, c + 2) if 0 <= d < gw}
            assert need <= set(ys), (c, need, ys)
    assert np.all(served == 1), served


_GRID_Y = _py(_one(r"const dim3 grid\(.*?, (a\.rows)\);"))
_ROW = _py(_one(r"const int r = (g\.row0 \+ blockIdx\.y)"))


@pytest.mark.parametrize("gh, rows, row0", [(7, 7, 0), (124, 31, 31), (8, 1, 7)])
def test_grid_rows_are_the_launch_rows(gh, rows, row0):
    """Block row y serves global row row0 + y, and the grid has exactly the
    launch's rows: K1's whole grid, or a band's slab (rows R at row0), whose
    ghost rows no block serves."""
    served = [eval(_ROW, {}, {"row0": row0, "blockIdx": type("B", (), {"y": y})})
              for y in range(eval(_GRID_Y, {}, {"rows": rows}))]
    assert served == list(range(row0, row0 + rows))
    assert all(0 <= r < gh for r in served)


def test_shared_bytes_fit_one_block_for_every_capacity():
    sizes = [tile_shmem(C) for C in range(1, CONSTS["kMaxC"] + 1)]
    assert max(sizes) <= SHMEM_LIMIT
    assert all(tile_width(C) >= 1 for C in range(1, CONSTS["kMaxC"] + 1))
    assert tile_width(128) >= 8, "a block of the main path owns at least 8 columns"


def test_kernel_takes_the_capacities_it_took():
    """The C entry still refuses only C outside 1..1024, as before the tile."""
    assert CONSTS["kMaxC"] == 1024
    assert "a.C < 1 || a.C > kMaxC" in SRC


@pytest.mark.parametrize("C", [1, 33, 1024])
def test_wrapper_takes_every_capacity_on_the_cpu(C):
    spec = GridSpec(x_min=0.0, y_min=0.0, cell_size=10.0, gw=3, gh=2, capacity=C)
    planes = [torch.full((2, 3, C), SENTINEL) for _ in range(2)]
    planes[0][1, 2, C - 1], planes[1][1, 2, C - 1] = 5.0, 5.0  # keyed to (0, 0)
    out, counts = R.rebin_planes(planes, spec)
    assert int(counts.sum()) == 1 and [o.shape for o in out] == [(2, 3, C)] * 2


# ---------------- the key cuts and the numpy model of the tile ----------------


def cut(j: int, w: float, n: int):
    """The kernel's Cut for "key >= j", key = clip(floor(RN(a / w)), 0, n - 1):
    True (always), False (never) or the least float32 t_j that reaches j,
    found as the kernel's least_reaching finds it."""
    if j <= 0:
        return True
    if j >= n:
        return False
    w = F32(w)
    reaches = lambda a: np.floor(F32(a) / w) >= j
    step = lambda t, d: np.array([t], F32).view(np.int32).__add__(d).view(F32)[0]
    t = F32(j) * w
    while reaches(step(t, -1)):
        t = step(t, -1)
    while not reaches(t):
        t = step(t, 1)
    return t


def at(k, a):
    """The cut ``k`` applied to the float32 array ``a``."""
    if k is True or k is False:
        return np.full(np.shape(a), k)
    return a >= k


def _key(a, w, n):
    """clip(floor(RN(a / w)), 0, n - 1), with a NaN keyed to 0, as cell_of and
    the plain version's cell_index key it."""
    f = np.floor(a / F32(w))
    return np.where(np.isnan(f), 0, np.clip(np.nan_to_num(f, posinf=n, neginf=-1), 0, n - 1))


# 5.403036594390869 and 0.8290607333183289: widths at which j * w falls short
# of t_j for some j < 40 (j = 7, 13), so the walk up is taken.
@pytest.mark.parametrize("w", [9.0, 9.5, 0.1, 3.7, 1.0e-3, 5.403036594390869,
                               0.8290607333183289])
def test_a_cut_is_the_key_compare(w):
    """For every j, at(cut(j), a) == (key(a) >= j): at each t_j and its
    neighbours, on random values, zeros, NaN and the infinities."""
    n = 40
    rng = np.random.default_rng(int(w * 1000))
    w = float(F32(w))
    a = np.concatenate([rng.uniform(-2 * w, (n + 2) * w, 4000).astype(F32),
                        np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e30, -1e30], F32)])
    for j in range(-2, n + 3):
        k = cut(j, w, n)
        vals = a
        if not isinstance(k, bool):
            near = np.array([k], F32).view(np.int32) + np.arange(-3, 4, dtype=np.int32)
            vals = np.concatenate([a, near.view(F32)])
        np.testing.assert_array_equal(at(k, vals), _key(vals, w, n) >= j, err_msg=f"j={j}")


def test_the_kernel_finds_cuts_as_modelled():
    """The kernel's least_reaching walks from j * w by whole floats (bit
    pattern -+ 1), down while the float below still reaches j, then up until
    it reaches j; cut_of gives always for j <= 0 and never for j >= n."""
    body = re.search(r"float least_reaching\(int j, float w\) \{(.*?)\n\}", SRC, re.S).group(1)
    assert "static_cast<float>(j) * w" in body
    assert "__int_as_float(__float_as_int(v) + d)" in body
    assert "while (reaches(step(t, -1), w, j)) t = step(t, -1);" in body
    assert "while (!reaches(t, w, j)) t = step(t, 1);" in body
    assert "floorf(a / w) >= static_cast<float>(j)" in SRC
    assert "Cut{j >= 1 && j < n ? *t_j : 0.0f, j <= 0, j >= n}" in SRC


def _source(dr: int, dc: int, slot: int) -> int:
    return slot + 1024 * ((dr + 1) + 3 * (dc + 1))


def _excl_rank(mask):
    return np.cumsum(mask) - mask


class _Rows:
    """Rows of a launch by GLOBAL row: the own planes [row0, row0 + rows),
    ghost rows lo2 (x/y), lo1 and hi1.  Reading a row outside the grid
    fails: the kernel must never do it."""

    def __init__(self, planes, gh, row0, ghosts):
        self.planes, self.gh, self.row0 = planes, gh, row0
        self.rows = planes[0].shape[0]
        self.lo2, self.lo1, self.hi1 = ghosts if ghosts else (None, None, None)

    def __call__(self, ch: int, rr: int):
        assert 0 <= rr < self.gh, f"read of row {rr} outside the grid"
        if self.row0 <= rr < self.row0 + self.rows:
            return self.planes[ch][rr - self.row0]
        if rr == self.row0 - 1:
            return self.lo1[ch]
        if rr == self.row0 + self.rows:
            return self.hi1[ch]
        assert rr == self.row0 - 2 and ch < 2, (rr, ch)
        return self.lo2[ch]


LEFT, RIGHT = 1, 2  # a mid word's class: moves left / right in its row


def model_rebin(planes, spec: GridSpec, fills, T: int, row0: int = 0, ghosts=None):
    """K1 (K7 with ``row0`` and ``ghosts``) as the tile kernel composes it:
    phase Y's mid words (source << 2 | class, -1 a fill) per column from the
    key cuts, phase X's composed sources from the classes, then the gather."""
    rows, gw, C = planes[0].shape
    gh, k = spec.gh, len(planes)
    row = _Rows(planes, gh, row0, ghosts)
    live = lambda x: x < 0.5 * SENTINEL
    dy = lambda y: y - F32(spec.y_min)
    dx = lambda x: x - F32(spec.x_min)

    def column_y(r, c):
        ky_up, ky_row, ky_below = (cut(j, spec.cell_size, gh) for j in (r - 1, r, r + 1))
        kx_col, kx_right = (cut(j, spec.cell_width, gw) for j in (c, c + 1))

        def cls(x, y):
            in_row = at(ky_row, dy(y)) & ~at(ky_below, dy(y))
            return np.where(in_row, np.where(~at(kx_col, dx(x)), LEFT,
                                             np.where(at(kx_right, dx(x)), RIGHT, 0)), 0)

        x0, y0 = row(0, r)[c], row(1, r)[c]
        live0 = live(x0)
        z = np.zeros(C, bool)
        xy = lambda rr: (row(0, rr)[c], row(1, rr)[c])
        up = xy(r - 1) if r >= 1 else None
        dn = xy(r + 1) if r <= gh - 2 else None
        up2 = xy(r - 2) if r >= 2 else None
        keep_m1 = z if up is None else live(up[0]) & at(ky_row, dy(up[1]))
        keep_p1 = z if dn is None else live(dn[0]) & ~at(ky_below, dy(dn[1]))
        dead_m1 = z if up is None else ~live(up[0])
        dead_p1 = z if dn is None else ~live(dn[0])
        keep_m2 = z if up2 is None else live(up2[0]) & at(ky_up, dy(up2[1]))
        into_m1 = live0 & (r >= 1) & ~at(ky_row, dy(y0))
        into_p1 = live0 & (r <= gh - 2) & at(ky_below, dy(y0))
        adopted = ((into_m1 & (keep_m2.sum() + _excl_rank(into_m1) < dead_m1.sum()))
                   | (into_p1 & (_excl_rank(into_p1) < dead_p1.sum())))
        arrivals = ([(-1, w) for w in np.flatnonzero(keep_m1)]
                    + [(1, w) for w in np.flatnonzero(keep_p1)])
        mid = np.where(live0, (np.arange(C) + 1024 * 4) << 2 | cls(x0, y0), -1)
        hrank = _excl_rank(~live0)
        for s in range(C):
            if not live0[s] and hrank[s] < len(arrivals):
                dr, w = arrivals[hrank[s]]
                x, y = xy(r + dr)
                mid[s] = _source(dr, 0, w) << 2 | int(cls(x[w:w + 1], y[w:w + 1])[0])
            elif adopted[s]:
                mid[s] = -1
        return mid

    def column_x(c, mid):
        """The composed source of each out slot of column c (mid: the tile's
        phase-Y words by column)."""
        m = mid[c]
        z = np.zeros(C, bool)
        moves = lambda w, way: (w & 3) == way
        kg0 = z if c < 1 else moves(mid[c - 1], RIGHT)
        kg1 = z if c > gw - 2 else moves(mid[c + 1], LEFT)
        dead_l = z if c < 1 else mid[c - 1] < 0
        dead_r = z if c > gw - 2 else mid[c + 1] < 0
        g0_of_l = z if c < 2 else moves(mid[c - 2], RIGHT)
        into_l = (c >= 1) & moves(m, LEFT)
        into_r = (c <= gw - 2) & moves(m, RIGHT)
        adopted = ((into_l & (g0_of_l.sum() + _excl_rank(into_l) < dead_l.sum()))
                   | (into_r & (_excl_rank(into_r) < dead_r.sum())))
        arrivals = ([(-1, w) for w in np.flatnonzero(kg0)]
                    + [(1, w) for w in np.flatnonzero(kg1)])
        dead = m < 0
        hrank = _excl_rank(dead)
        out = np.full(C, -1)
        for s in range(C):
            if not dead[s] and not adopted[s]:
                out[s] = m[s] >> 2
            elif dead[s] and hrank[s] < len(arrivals):
                dc, w = arrivals[hrank[s]]
                assert mid[c + dc][w] >= 0, "pass X moved a dead mid slot"
                out[s] = (mid[c + dc][w] >> 2) + dc * 3 * 1024
        return out

    outs = [np.empty_like(p) for p in planes]
    counts = np.zeros(rows * gw, np.int32)
    for y in range(rows):
        r = row0 + y
        for c0 in range(0, gw, T):
            mid = {c: column_y(r, c) for c in range(max(c0 - 2, 0), min(c0 + T + 1, gw))}
            for c in range(c0, min(c0 + T, gw)):
                src = column_x(c, mid)
                counts[y * gw + c] = int((src >= 0).sum())
                for s, cd in enumerate(src):
                    if cd < 0:
                        for ch in range(k):
                            outs[ch][y, c, s] = fills[ch]
                        continue
                    t, slot = cd >> 10, cd & 1023
                    dr, dc = t % 3 - 1, t // 3 - 1
                    for ch in range(k):
                        outs[ch][y, c, s] = row(ch, r + dr)[c + dc][slot]
    return outs, counts


@functools.lru_cache(maxsize=None)
def _jax_rebin(geom: tuple, k: int):
    spec = JGridSpec(**dict(geom))
    return jax.jit(lambda *p: jrebin(list(p), spec, variant=6))


def _geom(gw: int, gh: int, C: int) -> dict:
    return dict(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=gw, gh=gh, capacity=C)


def _check_model(planes, geom, widths):
    """The model at each tile width in ``widths`` against the plain version
    and JAX, bit for bit (planes and counts)."""
    spec = GridSpec(**geom)
    fills = R._fills(planes, None)
    plain, pc = R.rebin_planes_plain([torch.from_numpy(p.copy()) for p in planes], spec)
    jout, jc = _jax_rebin(tuple(sorted(geom.items())), len(planes))(
        *[jnp.asarray(p) for p in planes])
    for T in widths:
        got, gc = model_rebin(planes, spec, fills, T)
        for c, (g, p, j) in enumerate(zip(got, plain, jout)):
            np.testing.assert_array_equal(g, p.numpy(), err_msg=f"T={T} channel {c}")
            np.testing.assert_array_equal(g, np.asarray(j), err_msg=f"T={T} channel {c} (JAX)")
        np.testing.assert_array_equal(gc, pc.numpy())
        np.testing.assert_array_equal(gc, np.asarray(jc))
    return plain


def _planes(seed, geom, fill, drift, k=5):
    return [np.asarray(p).copy() for p in _demo_planes(np.random.default_rng(seed),
                                                        JGridSpec(**geom), geom["capacity"],
                                                        fill, drift, k=k)]


@pytest.mark.parametrize("capacity", [16, 64])
@pytest.mark.parametrize("drift", [0.4, 0.9, 1.8])
def test_model_matches_plain_and_jax(drift, capacity):
    """gw 11 (one tile at the kernel's width; three at the narrowest)."""
    geom = _geom(11, 7, capacity)
    _check_model(_planes(capacity + int(10 * drift), geom, 0.7, drift), geom,
                 (tile_width(capacity), 5))


def test_model_across_kernel_tiles():
    """A width of two tiles at the kernel's own T (C=16: gw = T + 4), so the
    kernel's tile edge itself is crossed, and a crowded C=128 grid."""
    T = tile_width(16)
    geom = _geom(T + 4, 3, 16)
    _check_model(_planes(5, geom, 0.8, 1.8), geom, (T, T - 1))
    geom = _geom(7, 5, 128)
    _check_model(_planes(6, geom, 0.9, 0.9), geom, (tile_width(128), 5))


@pytest.mark.parametrize("drift", [0.4, 0.9, 1.8])
def test_model_air_rows(drift):
    """Rows 0, 3, 4, 5 of 9 start empty (row 4's window is all air); rows 3
    and 5 turn live from rows 2 and 6."""
    geom = _geom(11, 9, 16)
    planes = _planes(1, geom, 0.7, drift)
    for r in (0, 3, 4, 5):
        planes[0][r] = planes[1][r] = SENTINEL
        for c in range(2, 5):
            planes[c][r] = 0.0
    got = _check_model(planes, geom, (tile_width(16), 5))
    live = got[0].numpy() < 0.5 * SENTINEL
    assert live[3].any() and live[5].any() and not live[4].any()


@pytest.mark.parametrize("n_bands", [3, 9])
def test_model_band_slabs_read_ghost_rows_in_place(n_bands):
    """K7: each band of a 9-row grid with its ghost rows as separate rows
    (live particles past the grid's edges, which no decision may read: the
    model fails on a read there), against the band's plain version and K1's
    rows of the whole grid."""
    geom = _geom(11, 9, 16)
    spec = GridSpec(**geom)
    planes = _planes(7, geom, 0.7, 1.8)
    fills = R._fills(planes, None)
    whole, wc = R.rebin_planes_plain([torch.from_numpy(p.copy()) for p in planes], spec)
    Rb = 9 // n_bands
    past = np.full((11, 16), 1.5, np.float32)
    row = lambda c, r: planes[c][r] if 0 <= r < 9 else past
    for b in range(n_bands):
        r0 = b * Rb
        ghosts = ([row(c, r0 - 2) for c in (0, 1)], [row(c, r0 - 1) for c in range(5)],
                  [row(c, r0 + Rb) for c in range(5)])
        slab = [p[r0:r0 + Rb] for p in planes]
        got, gc = model_rebin(slab, spec, fills, 5, r0, ghosts)
        t = lambda rows_: [torch.from_numpy(np.asarray(x).copy()) for x in rows_]
        plain, pc = R.rebin_planes_band_plain(t(slab), spec, None, r0, *map(t, ghosts))
        for g, p, w in zip(got, plain, whole):
            np.testing.assert_array_equal(g, p.numpy())
            np.testing.assert_array_equal(g, w.numpy()[r0:r0 + Rb])
        np.testing.assert_array_equal(gc, pc.numpy())
        np.testing.assert_array_equal(gc, wc.numpy()[r0 * 11:(r0 + Rb) * 11])


# ---------------- the walk planes: phase X's defer test by the cuts ----------------


def model_walk(outs, spec: GridSpec, row0: int = 0):
    """Phase X's walk stores, asked for: each out slot's x/y, or SENTINEL
    where it is live and not home, "home" tested by the block's cuts of its
    row r and its column c (``Cuts::home``)."""
    x, y = outs[0], outs[1]
    rows, gw, _ = x.shape
    wx, wy = x.copy(), y.copy()
    for yy in range(rows):
        r = row0 + yy
        ky_row, ky_below = (cut(j, spec.cell_size, spec.gh) for j in (r, r + 1))
        for c in range(gw):
            kx_col, kx_right = (cut(j, spec.cell_width, gw) for j in (c, c + 1))
            ax, ay = x[yy, c] - F32(spec.x_min), y[yy, c] - F32(spec.y_min)
            home = at(ky_row, ay) & ~at(ky_below, ay) & at(kx_col, ax) & ~at(kx_right, ax)
            defer = (x[yy, c] < 0.5 * SENTINEL) & ~home
            wx[yy, c] = np.where(defer, F32(SENTINEL), x[yy, c])
            wy[yy, c] = np.where(defer, F32(SENTINEL), y[yy, c])
    return wx, wy


def test_the_kernel_defers_by_the_home_test():
    """The walk stores park a slot that is live and not home, home being
    the key row's two cuts and the key column's two, as modelled."""
    home = re.search(r"bool home\(float x, float y\) const \{(.*?)\n  \}", SRC, re.S).group(1)
    assert "return row.at(ay) && !below.at(ay) && col.at(ax) && !right.at(ax);" in home
    assert "const bool defer = v[0] < kLiveBelow && !k.home(v[0], v[1]);" in SRC
    assert "walk.x[o] = defer ? rps::kSentinel : v[0];" in SRC
    assert "walk.x[o] = fills.v[0];" in SRC
    assert "k.col = cut_of(c, g.gw, xcut);" in SRC


@pytest.mark.parametrize("drift", [0.4, 1.8])
@pytest.mark.parametrize("geom", [_geom(11, 7, 16), _geom(7, 5, 128)])
def test_model_walk_planes_are_walk_positions(geom, drift):
    """On the rebin's output, whole grid and each row as a band's slab, the
    cut-tested walk planes equal ``walk_positions``' keyed mask bit for bit,
    with deferred slots among them."""
    spec = GridSpec(**geom)
    planes = _planes(geom["capacity"] + int(10 * drift), geom, 0.8, drift)
    out, _ = R.rebin_planes_plain([torch.from_numpy(p.copy()) for p in planes], spec)
    out = [o.numpy() for o in out]
    wx, wy = model_walk(out, spec)
    mx, my = R.walk_positions(*(torch.from_numpy(o) for o in out[:2]), spec)
    np.testing.assert_array_equal(wx.view(np.int32), mx.numpy().view(np.int32))
    np.testing.assert_array_equal(wy.view(np.int32), my.numpy().view(np.int32))
    assert ((out[0] < 0.5 * SENTINEL) & (wx == SENTINEL)).any()
    for r0 in range(spec.gh):
        bx, by = model_walk([o[r0:r0 + 1] for o in out], spec, r0)
        np.testing.assert_array_equal(bx, wx[r0:r0 + 1])
        np.testing.assert_array_equal(by, wy[r0:r0 + 1])


@pytest.mark.parametrize("w", [9.0, 5.403036594390869, 0.8290607333183289])
def test_model_walk_home_test_at_the_cuts(w):
    """Positions on each cut t_j and the floats around it, on the grid's
    outer edges, NaN and the infinities: parked exactly where the key (the
    card's saturating cast, as ``_key`` keys) is not the slot's cell."""
    gw, gh, C = 9, 6, 8
    spec = GridSpec(x_min=-7.25, y_min=3.5, cell_size=w, gw=gw, gh=gh, capacity=C)
    rng = np.random.default_rng(int(w * 1e3))
    near = lambda t, n: (np.array([t], F32).view(np.int32)
                         + rng.integers(-2, 3, n).astype(np.int32)).view(F32)

    def coord(lo, n, idx, shape):
        vals = np.empty(shape, F32)
        for i in np.ndindex(shape):
            j = int(idx[i]) + int(rng.integers(-1, 3))
            k = cut(j, w, n)
            t = k if not isinstance(k, (bool, np.bool_)) else F32(j * w)
            vals[i] = F32(lo) + near(t, 1)[0]
        odd = rng.random(shape) < 0.08
        vals[odd] = rng.choice(np.array([np.nan, np.inf, -np.inf, 0.0, -1e30, 1e30], F32),
                               int(odd.sum()))
        return vals

    shape = (gh, gw, C)
    x = coord(spec.x_min, gw, np.broadcast_to(np.arange(gw)[None, :, None], shape), shape)
    y = coord(spec.y_min, gh, np.broadcast_to(np.arange(gh)[:, None, None], shape), shape)
    x[rng.random(shape) < 0.1] = SENTINEL
    wx, wy = model_walk([x, y], spec)
    kx, ky = _key(x - F32(spec.x_min), w, gw), _key(y - F32(spec.y_min), w, gh)
    home = (kx == np.arange(gw)[None, :, None]) & (ky == np.arange(gh)[:, None, None])
    defer = (x < 0.5 * SENTINEL) & ~home
    assert defer.any() and ((x < 0.5 * SENTINEL) & home).any()
    np.testing.assert_array_equal(wx, np.where(defer, F32(SENTINEL), x))
    np.testing.assert_array_equal(wy, np.where(defer, F32(SENTINEL), y))
