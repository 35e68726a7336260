"""The strip walks' launch geometry (K2, K3, K3b, and K6 on the pair-packed
planes; csrc/sph.cu).

The kernels run only on the card.  Their geometry is fixed in the kernel's
source, and these tests read it from there (the strip's width, the block,
the tile, the shared bytes, the grid and the block-to-cell mapping) and hold
it on the CPU: every column of every own row is served by exactly one block
(odd widths, widths that are not a multiple of the strip, a band's slab with
ghost rows), every strip starts on an even column so that K6's cell pairs
are whole (each pair served by one block, the phantom cell of an odd width
by none), K6's three entries launch the strip walks, a block's shared memory
stays within what one H100 block may use for every C the walks take, and the
wrappers refuse any other C.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rust_particle_system_tpu_torch.ops.cuda import sph as S

SRC = (Path(S.__file__).resolve().parent.parent.parent / "csrc" / "sph.cu").read_text()
SHMEM_LIMIT = 232_448  # shared bytes one H100 block may use
SIZEOF = {"float2": 8, "float4": 16}


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


CONSTS = {name: _const(name) for name in ("kStripCells", "kWalkThreads", "kWalkTile", "kMaxC")}


def _cexpr(pattern: str) -> str:
    """The C expression that ``pattern``'s group captures in sph.cu, as Python
    (integer division, ``st.c0`` and ``blockIdx.x`` as plain names)."""
    found = re.findall(pattern, SRC)
    assert len(found) == 1, (pattern, found)
    expr = re.sub(r"static_cast<\w+>", "", found[0])
    return expr.replace("st.c0", "c0").replace("blockIdx.x", "bx").replace("/", "//")


GRID_X = _cexpr(r"const dim3 grid\((.*?), R\);")
C0 = _cexpr(r"st\.c0 = (.*?);")
N_CELLS = _cexpr(r"const int n_cells = (.*?);")
SHMEM = _cexpr(r"constexpr size_t strip_shmem\(size_t entry, size_t C\) \{\s*return (.*?);")
ENTRIES = [eval(re.sub(r"sizeof\((\w+)\)", lambda m: str(SIZEOF[m.group(1)]), e))
           for e in re.findall(r"static constexpr int kEntry = (.*?);", SRC)]


def _served(gh: int, gw: int, ghost: bool) -> np.ndarray:
    """[gh, gw] count of the blocks that serve each cell: block (bx, y) of the
    launch's grid serves own cells c0 .. c0 + n_cells - 1 of own row r0 + y."""
    r0, r1 = S._own_rows(gh, ghost)
    count = np.zeros((gh, gw), dtype=int)
    for y in range(r1 - r0):
        for bx in range(eval(GRID_X, {}, dict(CONSTS, gw=gw))):
            c0 = eval(C0, {}, dict(CONSTS, bx=bx))
            n_cells = eval(N_CELLS, {}, dict(CONSTS, gw=gw, c0=c0))
            assert n_cells > 0, f"block {bx} of row {y} serves no cell (gw {gw})"
            count[r0 + y, c0:c0 + n_cells] += 1
    return count


@pytest.mark.parametrize("gw", [1, 7, 8, 9, 21, 23, 214])
@pytest.mark.parametrize("ghost", [False, True])
def test_every_own_cell_is_served_once(gw, ghost):
    gh = 5
    count = _served(gh, gw, ghost)
    r0, r1 = S._own_rows(gh, ghost)
    assert np.all(count[r0:r1] == 1), count
    assert np.all(count[:r0] == 0) and np.all(count[r1:] == 0), "a ghost row was served"


@pytest.mark.parametrize("gw", [1, 3, 7, 21, 23, 213, 214])
@pytest.mark.parametrize("ghost", [False, True])
def test_every_cell_pair_is_served_by_one_block(gw, ghost):
    """K6's layout: cells (2p, 2p + 1) of a row are served by the same block;
    on an odd width the last pair's second cell is outside the grid and no
    block serves it."""
    gh, strip = 5, CONSTS["kStripCells"]
    r0, r1 = S._own_rows(gh, ghost)
    assert strip % 2 == 0 and "static_assert(kStripCells % 2 == 0" in SRC
    for y in range(r1 - r0):
        owner = {}
        for bx in range(eval(GRID_X, {}, dict(CONSTS, gw=gw))):
            c0 = eval(C0, {}, dict(CONSTS, bx=bx))
            assert c0 % 2 == 0, f"block {bx} starts on odd column {c0}"
            n_cells = eval(N_CELLS, {}, dict(CONSTS, gw=gw, c0=c0))
            for c in range(c0, c0 + n_cells):
                owner.setdefault(c // 2, set()).add(bx)
        assert sorted(owner) == list(range((gw + 1) // 2))
        assert all(len(b) == 1 for b in owner.values()), owner
    assert np.all(_served(gh, gw, ghost)[r0:r1] == 1)


def _entry(name: str) -> str:
    body = re.search(rf'extern "C" int {name}\(const void\* packed, int size\) \{{(.*?)\n\}}',
                     SRC, re.S)
    assert body, name
    return body.group(1)


@pytest.mark.parametrize("pair, classic", [("rps_pair_density", "rps_density"),
                                           ("rps_pair_density_pressure", "rps_density_pressure"),
                                           ("rps_pair_force_integrated", "rps_force_integrated"),
                                           ("rps_pair_force", "rps_force")])
def test_k6_entries_launch_the_strip_walks(pair, classic):
    """K6 keeps its entries and records, and each launches the classic
    entry's strip walk on the same record; the pair block is gone."""
    assert f"return {classic}(packed, size);" in _entry(pair)
    assert f"using {pair}_args = {classic}_args;" in SRC
    assert "launch_strips(" in _entry(classic)
    for gone in ("kPairCells", "stage_pair", "pair_density_kernel", "pair_force_kernel",
                 "pair_shape"):
        assert gone not in SRC, gone


@pytest.mark.parametrize("walk", ["density", "force"])
def test_shared_bytes_fit_one_block_for_every_capacity(walk):
    assert sorted(ENTRIES) == [8, 24], ENTRIES  # (px, py); + (P1, NPn, vx, vy)
    entry = ENTRIES[0] if walk == "density" else ENTRIES[1]
    sizes = [eval(SHMEM, {}, dict(CONSTS, entry=entry, C=C))
             for C in range(1, CONSTS["kMaxC"] + 1)]
    assert max(sizes) <= SHMEM_LIMIT
    # The tile bounds the footprint, not C: C=1024 adds only its ballots.
    assert max(sizes) - min(sizes) < 8 * 1024
    assert CONSTS["kWalkThreads"] % 32 == 0 and 32 <= CONSTS["kWalkThreads"] <= 1024
    assert CONSTS["kWalkTile"] >= 32


def test_host_takes_the_kernels_capacities():
    assert S.MAX_CAPACITY == CONSTS["kMaxC"]
    assert "C < 1 || C > kMaxC" in SRC


@pytest.mark.parametrize("C", [0, S.MAX_CAPACITY + 1, 2048, 4096])
@pytest.mark.parametrize("entry", ["density", "force", "pair_density", "pair_force"])
def test_other_capacities_are_refused(C, entry):
    planes = [torch.zeros(3, 2, C) for _ in range(6)]
    with pytest.raises(ValueError, match="slots a cell"):
        if entry == "density":
            S._launch(S._density, planes[:2], (), 2, False, 9.0, 1.0, 1.0)
        elif entry == "pair_density":
            S._launch(S._pair_density, planes[:2], (), 2, False, 9.0, 1.0, 1.0)
        elif entry == "force":
            S._launch(S._force, planes, planes[:1], 4, False, 9.0, 1e-8)
        else:
            S._launch(S._pair_force, planes, planes[:1], 4, False, 9.0, 1e-8)
