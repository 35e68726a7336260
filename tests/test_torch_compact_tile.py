"""The full-window compaction's tile (K12; csrc/rebin_compact.cu), on the CPU.

The kernel runs only on the card.  Its geometry is fixed in its source, and
these tests read it from there (the warps, the own cells of a block for each
C, the shared bytes, the grid, the staging's and the ranking's mappings) and
hold it: every destination cell is served exactly once (gw = 1, 2 and 3, a
grid smaller than one tile, cell counts that are not a multiple of it), the
words a ranking warp reads are the ones staged for the source cell its group
names, a block's shared memory stays within what one H100 block may use for
every C the kernel takes, and the kernel takes the C range it took before.

Then a numpy model of the kernel, block by block: the staging (three flat
source ranges, the group guard, one word per slot: the flat cell its key
names if it is live, or -1; keyed as tests/test_torch_rebin_tile.py keys), and
the warp ranking by 32-slot ballots with its moves and fills.  It is held bit
for bit against the port's plain version and the JAX ``rebin_planes``
(variants 2 and 3, interpret mode) on the geometries of
tests/test_torch_rebin_variants.py: C = 16 and 64 at three drifts, air rows,
the crowded grid, the overflow and the row-edge wrap, at the kernel's own
tile width and at a narrow one, so that small grids cross tile edges.
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
from test_torch_rebin_tile import _key

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.pallas.rebin import rebin_planes as jrebin
from rust_particle_system_tpu_torch.ops.cuda import rebin as R
from rust_particle_system_tpu_torch.ops.grid import GridSpec

SRC = (Path(R.__file__).resolve().parents[2] / "csrc" / "rebin_compact.cu").read_text()
SHMEM_LIMIT = 232_448  # shared bytes one H100 block may use
SENTINEL = R.SENTINEL
F32 = np.float32


def _py(expr: str) -> str:
    """A C expression of rebin_compact.cu as Python (integer division, no casts)."""
    expr = re.sub(r"static_cast<\w+>", "", expr).replace("&&", " and ").replace("||", " or ")
    return expr.replace("g.", "").replace("/", "//")


def _one(pattern: str, flags=0) -> str:
    found = re.findall(pattern, SRC, flags)
    assert len(found) == 1, (pattern, found)
    return found[0]


def clamp_int(v, lo, hi):
    return max(lo, min(hi, v))


CONSTS = {name: int(_one(rf"constexpr int {name} = (\d+);"))
          for name in ("kCompactWarps", "kMaxC", "kCompactMinBlocks", "kStageChunks")}
CONSTS["kCompactThreads"] = eval(_py(_one(r"constexpr int kCompactThreads = (.*?);")), {},
                                 CONSTS)
_TILE = _py(_one(r"constexpr int tile_cells\(int C\) \{ return (.*?); \}"))
_SHMEM = _py(" ".join(_one(r"constexpr size_t compact_shmem\(int C\) \{\s*return (.*?);\s*\}",
                           re.S).split()))
_T_HOST = _py(_one(r"const int T = (tile_cells\(C\));"))
_T_KERNEL, _S_KERNEL = map(_py, _one(r"const int C = g\.C, T = (.*?), S = (.*?);"))
_GRID = _py(_one(r"rebin_compact<<<(.*?), kCompactThreads, shmem,"))
_F0 = _py(_one(r"const int f0 = (blockIdx\.x \* T);"))
# The staging loop: (first w, end of w), its (dy, u) and its (j, m).
_STAGE = tuple(map(_py, _one(r"for \(int w = (warp); w < (.*?); w \+= kCompactWarps\)")))
_DY_U = tuple(map(_py, _one(r"const int dy = (.*?), u = (.*?);")))
_J_M = tuple(map(_py, _one(r"const int j = (f0 - 1 \+ u), m = (j \+ dy \* g\.gw);")))
_GUARD = _py(_one(r"if \((j < 0 \|\| j >= g\.nc \|\| m < 0 \|\| m >= g\.nc)\) \{"))
# The ranking loop: (first t, end of t), its cell, its stop, the word row it
# reads for group (dy, dx) and the source cell it moves from.
_RANK = tuple(map(_py, _one(r"for \(int t = (warp); t < (T); t \+= kCompactWarps\)")))
_CELL = _py(_one(r"const int i = (f0 \+ t);\n    if \(i >= g\.nc\) break;"))
_ROW = _py(_one(r"const int\* word = words \+ \((\(dy \+ 1\) \* S \+ t \+ dx \+ 1)\) \* C;"))
_GROUP = tuple(map(_py, _one(r"const int dy = (grp / 3 - 1), dx = (grp % 3 - 1);")))
_FROM = _py(_one(r"const size_t from = static_cast<size_t>\((i \+ dx \+ dy \* g\.gw)\) \* C"))


def tile_cells(C: int) -> int:
    return eval(_TILE, {"clamp_int": clamp_int}, {"C": C})


def compact_shmem(C: int) -> int:
    return eval(_SHMEM, {"tile_cells": tile_cells}, {"C": C})


def _ev(expr, **env):
    return eval(expr, {"min": min, "max": max, "tile_cells": tile_cells}, env)


def _blocks(gw: int, nc: int, C: int):
    """Per block: its f0, the (word row, j, m, guarded) of each staged row
    its warps write, and the (cell, [(dy, dx, word row, source)]) each
    ranking warp serves, as the kernel maps them."""
    T = _ev(_T_HOST, C=C)
    assert T == _ev(_T_KERNEL, C=C)
    S = _ev(_S_KERNEL, T=T)
    blocks = []
    for bx in range(_ev(_GRID, nc=nc, T=T)):
        f0 = _ev(_F0, blockIdx=type("B", (), {"x": bx}), T=T)
        staged, served = [], []
        for warp in range(CONSTS["kCompactWarps"]):
            w = _ev(_STAGE[0], warp=warp)
            while w < _ev(_STAGE[1], S=S):
                dy, u = (_ev(e, w=w, S=S) for e in _DY_U)
                j = _ev(_J_M[0], f0=f0, u=u)
                m = _ev(_J_M[1], j=j, dy=dy, gw=gw)
                staged.append((w, j, m, _ev(_GUARD, j=j, m=m, nc=nc)))
                w += CONSTS["kCompactWarps"]
            t = _ev(_RANK[0], warp=warp)
            while t < _ev(_RANK[1], T=T):
                i = _ev(_CELL, f0=f0, t=t)
                if i >= nc:
                    break
                groups = []
                for grp in range(9):
                    dy, dx = (_ev(e, grp=grp) for e in _GROUP)
                    groups.append((dy, dx, _ev(_ROW, dy=dy, dx=dx, S=S, t=t),
                                   _ev(_FROM, i=i, dx=dx, dy=dy, gw=gw)))
                served.append((i, groups))
                t += CONSTS["kCompactWarps"]
        blocks.append((f0, staged, served))
    return T, S, blocks


def test_the_source_is_the_tiled_design():
    kernel = SRC[SRC.index("__global__ void"):SRC.index("}  // namespace")]
    assert kernel.count("__syncthreads()") == 1, "one, after the staging"
    assert "block_count" not in SRC, "no block-wide count"
    staging = kernel[:kernel.index("__syncthreads()")]
    assert kernel.count("cell_of(") == staging.count("cell_of(") == 2, "keyed in the staging"
    assert "__launch_bounds__(kCompactThreads, kCompactMinBlocks)" in SRC
    assert kernel.count("__ballot_sync") == 1, "one ballot a chunk of a group"
    assert SRC.count("<<<") == 1, "one launch a call"
    assert "const size_t shmem = compact_shmem(C);" in SRC
    assert CONSTS["kCompactThreads"] == 32 * CONSTS["kCompactWarps"]


@pytest.mark.parametrize("gw, gh", [(1, 1), (1, 37), (2, 9), (3, 5), (3, 7), (11, 7), (4, 2),
                                    (214, 3)])
@pytest.mark.parametrize("C", [1, 16, 40, 128, 1024])
def test_every_destination_cell_is_served_once(gw, gh, C):
    """Every cell is served by exactly one ranking warp of one block; each
    group it walks reads the word row its block staged for source cell
    i + dx + dy*gw (staged once, with the group's guard), and every staged
    row lies in the block's shared words."""
    nc = gw * gh
    T, S, blocks = _blocks(gw, nc, C)
    served = np.zeros(nc, dtype=int)
    for f0, staged, cells in blocks:
        rows = {w: (j, m, guarded) for w, j, m, guarded in staged}
        assert len(rows) == len(staged) == 3 * S and set(rows) == set(range(3 * S))
        for i, groups in cells:
            assert f0 <= i < f0 + T
            served[i] += 1
            for dy, dx, row, src in groups:
                j, m, guarded = rows[row]
                assert (j, m) == (i + dx, src), (i, dy, dx, j, m)
                assert guarded == (not (0 <= i + dx < nc and 0 <= src < nc))
    assert np.all(served == 1), served


def test_shared_bytes_fit_one_block_for_every_capacity():
    sizes = [compact_shmem(C) for C in range(1, CONSTS["kMaxC"] + 1)]
    assert max(sizes) <= SHMEM_LIMIT
    assert all(tile_cells(C) >= 1 for C in range(1, CONSTS["kMaxC"] + 1))
    assert tile_cells(128) == 16 and compact_shmem(128) == 3 * 18 * 128 * 4
    # The launch bounds ask for kCompactMinBlocks resident blocks an SM: their
    # threads must fit the SM's 2048 and their shared bytes its 228 KB at the
    # main path's C = 128.
    blocks = CONSTS["kCompactMinBlocks"]
    assert blocks * CONSTS["kCompactThreads"] <= 2048
    assert blocks * (compact_shmem(128) + 1024) <= 228 * 1024


def test_kernel_takes_the_capacities_it_took():
    """The C entry refuses only C outside 1..1024, as before the tile."""
    assert CONSTS["kMaxC"] == 1024
    assert "C < 1 || C > kMaxC" in SRC


@pytest.mark.parametrize("C", [1, 33, 1024])
def test_wrapper_takes_every_capacity_on_the_cpu(C):
    spec = GridSpec(x_min=0.0, y_min=0.0, cell_size=10.0, gw=3, gh=2, capacity=C)
    planes = [torch.full((2, 3, C), SENTINEL) for _ in range(2)]
    planes[0][1, 2, C - 1], planes[1][1, 2, C - 1] = 15.0, 5.0  # keyed to (0, 1)
    out, counts = R.rebin_compact(planes, spec)
    assert counts.tolist() == [0, 1, 0, 0, 0, 0] and out[0][0, 1, 0] == 15.0


# ---------------- the numpy model of the tile ----------------

def test_the_kernel_keys_as_modelled():
    """A staged word is the flat cell ky * gw + kx of a live slot, each key by
    cell_of on its own axis, or -1."""
    src = " ".join(SRC.split())
    assert ("const int kc = cell_of(y[b], g.y_min, g.cell_h, g.gh) * g.gw + "
            "cell_of(x[b], g.x_min, g.cell_w, g.gw);") in src
    assert "word[s0 + 32 * b] = x[b] < kLiveBelow ? kc : -1;" in src


def _flat_key(x, y, spec: GridSpec):
    """The flat cell ky * gw + kx of each slot, keyed as the kernel keys."""
    kx = _key(x - F32(spec.x_min), spec.cell_width, spec.gw)
    ky = _key(y - F32(spec.y_min), spec.cell_size, spec.gh)
    return (ky * spec.gw + kx).astype(np.int64)


@pytest.mark.parametrize("w", [9.0, 0.1, 5.403036594390869])
def test_the_model_keys_as_the_plain_version(w):
    """The model's flat key equals the plain version's cell_index keys on
    random values, cell edges, zeros, NaN and -inf, and huge negatives."""
    spec = GridSpec(x_min=-3.0, y_min=7.0, cell_size=float(F32(w)), gw=40, gh=40, capacity=1)
    rng = np.random.default_rng(int(w * 1000))
    edges = (np.arange(-2, 43, dtype=F32) * F32(w)).view(np.int32)
    edges = (edges[:, None] + np.arange(-2, 3, dtype=np.int32)).view(F32).ravel()
    # Not +inf nor +1e30: PyTorch on the CPU casts their floor to INT_MIN (key
    # 0) where the card's cast saturates (key n - 1, as _key keys them).
    special = np.array([0.0, -0.0, np.nan, -np.inf, -1e30], F32)
    a = np.concatenate([rng.uniform(-2 * w, 42 * w, 2000).astype(F32), edges, special])
    x, y = a + F32(-3.0), rng.permutation(a) + F32(7.0)
    kx, ky = R._keys(torch.from_numpy(x), torch.from_numpy(y), spec)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(_flat_key(x, y, spec), (ky * 40 + kx).numpy())


def model_compact(planes, spec: GridSpec, fills, T: int):
    """K12 as the tile kernel computes it, block by block: the staged words
    of the three flat source ranges, then a warp per own cell ranking its nine
    groups by 32-slot ballots and moving each candidate of rank < C once."""
    gh, gw, C = planes[0].shape
    nc, k, S = gh * gw, len(planes), T + 2
    flats = [p.reshape(nc, C) for p in planes]
    outs = [np.empty((nc, C), F32) for _ in planes]
    counts = np.zeros(nc, np.int32)
    below = np.arange(32)
    for f0 in range(0, nc, T):
        words = np.full((3, S, C), -1, np.int64)
        for dy in (-1, 0, 1):
            for u in range(S):
                j = f0 - 1 + u
                m = j + dy * gw
                if not (0 <= j < nc and 0 <= m < nc):
                    continue
                x, y = flats[0][m], flats[1][m]
                with np.errstate(invalid="ignore"):
                    words[dy + 1, u] = np.where(x < 0.5 * SENTINEL, _flat_key(x, y, spec), -1)
        for t in range(T):
            i = f0 + t
            if i >= nc:
                break
            before = 0
            for grp in range(9):
                dy, dx = grp // 3 - 1, grp % 3 - 1
                word = words[dy + 1, t + dx + 1]
                for s0 in range(0, C, 32):
                    cand = np.zeros(32, bool)
                    n = min(32, C - s0)
                    cand[:n] = word[s0:s0 + n] == i
                    ranks = before + np.array([cand[:lane].sum() for lane in below])
                    for lane in np.flatnonzero(cand & (ranks < C)):
                        src = i + dx + dy * gw
                        for ch in range(k):
                            outs[ch][i, ranks[lane]] = flats[ch][src, s0 + lane]
                    before += int(cand.sum())
            for ch in range(k):
                outs[ch][i, min(before, C):] = fills[ch]
            counts[i] = before
    return [o.reshape(gh, gw, C) for o in outs], counts


@functools.lru_cache(maxsize=None)
def _jax_rebin(geom: tuple, variant: int, fills):
    """The JAX rebin of one geometry and variant, jitted once, so that
    interpret mode traces one program per shape."""
    spec = JGridSpec(**dict(geom))
    return jax.jit(lambda planes: jrebin(planes, spec, fills=fills, interpret=True,
                                         variant=variant))


def _check(planes, geom, widths, fills=None, with_jax=True):
    """The model at each tile width against the plain version and (variants
    2 and 3) JAX, bit for bit: planes and counts."""
    spec = GridSpec(**geom)
    f = R._fills(planes, fills)
    plain, pc = R.rebin_compact_plain([torch.from_numpy(p.copy()) for p in planes], spec, f)
    refs = [([p.numpy() for p in plain], pc.numpy())]
    if with_jax:
        for v in (2, 3):
            want, wc = _jax_rebin(tuple(sorted(geom.items())), v, fills)(
                [jnp.asarray(p) for p in planes])
            refs.append(([np.asarray(w) for w in want], np.asarray(wc)))
    for T in widths:
        got, gc = model_compact(planes, spec, f, T)
        for n, (want, wc) in enumerate(refs):
            for c, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g, w, err_msg=f"T={T} ref {n} channel {c}")
            np.testing.assert_array_equal(gc, wc, err_msg=f"T={T} ref {n} counts")
    return refs[0]


GEOM = dict(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=7)
SMALL = dict(x_min=0.0, y_min=0.0, cell_size=10.0, gw=4, gh=2, capacity=4)
FILLS_IDS = (SENTINEL, SENTINEL, -1.0)


def _demo(capacity, drift, seed=0, fill=0.6, **geom):
    geom = dict(GEOM, capacity=capacity, **geom)
    planes = [np.asarray(p).copy() for p in _demo_planes(
        np.random.default_rng(seed), JGridSpec(**geom), capacity, fill, drift, k=5)]
    return geom, planes


@pytest.mark.parametrize("capacity", [16, 64])
@pytest.mark.parametrize("drift", [0.4, 0.9, 1.8])
def test_model_matches_plain_and_jax(drift, capacity):
    """77 cells: not a multiple of the kernel's tile (16 at C <= 128), nor of
    the narrow one (5)."""
    geom, planes = _demo(capacity, drift, seed=capacity + int(10 * drift))
    _check(planes, geom, (tile_cells(capacity), 5))


def test_model_air_rows():
    """Rows 0, 3, 4 and 5 of 7 emptied: row 4's windows hold nothing live,
    so its cells write only fills; rows 2 and 6 still feed what keys into
    rows 3 and 5."""
    geom, planes = _demo(16, 1.8, seed=4, fill=0.8)
    for r in (0, 3, 4, 5):
        planes[0][r] = planes[1][r] = SENTINEL
        for c in range(2, 5):
            planes[c][r] = 0.0
    _, counts = _check(planes, geom, (tile_cells(16), 3))
    rows = counts.reshape(7, 11)
    assert not rows[4].any() and rows[3].any() and rows[5].any()


def _small_planes():
    px = np.full((2, 4, 4), SENTINEL, np.float32)
    return [px, px.copy(), np.full((2, 4, 4), -1.0, np.float32)]


def test_model_crowded_grid():
    """tests/test_torch_rebin_variants.py's crowded grid: every slot full,
    counts above C, at the kernel's tile (one block holds all 8 cells) and
    at T = 1, 3."""
    r = np.random.default_rng(3)
    px, py, ids = _small_planes()
    for i, (cy, cx, s) in enumerate(np.ndindex(2, 4, 4)):
        px[cy, cx, s] = np.clip(cx * 10 + r.uniform(-8, 18), 0.1, 39.9)
        py[cy, cx, s] = np.clip(cy * 10 + r.uniform(-8, 18), 0.1, 19.9)
        ids[cy, cx, s] = float(i)
    _, counts = _check([px, py, ids], SMALL, (tile_cells(4), 3, 1), FILLS_IDS)
    assert counts.max() > 4


def test_model_overflow_reports_drops():
    """Six candidates of cell (0, 1) at capacity 4: counts 6, the first four
    in window order kept."""
    px, py, ids = _small_planes()
    px[0, 0, :3], py[0, 0, :3], ids[0, 0, :3] = [12.0, 13.0, 14.0], 5.0, [0, 1, 2]
    px[0, 1, :3], py[0, 1, :3], ids[0, 1, :3] = [15.0, 16.0, 17.0], 5.0, [3, 4, 5]
    (got, counts) = _check([px, py, ids], SMALL, (tile_cells(4), 3, 1), FILLS_IDS)
    assert counts[1] == 6 and int(counts.sum()) == 6
    np.testing.assert_array_equal(got[2][0, 1], [0, 1, 2, 3])


def test_model_row_edge_wrap():
    """The flat shifts: the last column's mover keyed to (1, 3) is read by
    cell (1, 0)'s window through the wrap and by (1, 3)'s; a block edge
    falls between them at T = 3 and 1."""
    px, py, ids = _small_planes()
    px[1, 3], py[1, 3], ids[1, 3] = [35.0, 36.0, 37.0, 38.0], 15.0, [1.0, 2.0, 4.0, 5.0]
    px[0, 3, 0], py[0, 3, 0], ids[0, 3, 0] = 37.0, 17.0, 3.0
    (got, counts) = _check([px, py, ids], SMALL, (tile_cells(4), 3, 1), FILLS_IDS)
    assert counts[7] == 5 and counts[4] == 0 and not (got[0][1, 0] < 0.5 * SENTINEL).any()


@pytest.mark.parametrize("gw, gh", [(1, 9), (2, 6), (3, 5), (5, 1)])
@pytest.mark.parametrize("C", [7, 32, 40])
def test_model_narrow_grids(gw, gh, C):
    """gw 1, 2, 3 (every dx group wraps into another row) and one row, at C
    below, at and above one warp, odd C included, and a grid smaller than one
    tile: against the plain version (JAX is held on the shapes above)."""
    geom, planes = _demo(C, 1.8, seed=gw * 10 + gh + C, fill=0.8, **dict(
        gw=gw, gh=gh, x_min=-4.5 * gw, y_min=-4.5 * gh))
    _check(planes, geom, (tile_cells(C), 2), with_jax=False)
