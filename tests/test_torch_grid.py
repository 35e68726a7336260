"""Port vs JAX: the grid's slot table, gather_to_cells, the neighbour cell ids
and suggest_capacity (the cases of tests/test_grid.py:26-90, :151).

The same numpy positions go through the JAX package and the port on the CPU.
Everything here is integer bookkeeping and value moves, so the bar is
bit-equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu.ops.grid import build_grid as jbuild_grid
from rust_particle_system_tpu.ops.grid import gather_to_cells as jgather
from rust_particle_system_tpu.ops.grid import suggest_capacity as jsuggest
from rust_particle_system_tpu_torch.ops.grid import (GridSpec, build_grid, gather_to_cells,
                                                     suggest_capacity)

BOUNDS = (-100.0, 100.0, -50.0, 50.0)  # gw=23, gh=12 at cell 9
GRID_FIELDS = ("perm", "sorted_keys", "starts", "table", "slot")


def _specs(capacity, bounds=BOUNDS, **kw):
    return (JGridSpec.from_bounds(bounds, 9.0, capacity, **kw),
            GridSpec.from_bounds(bounds, 9.0, capacity, **kw))


def _cloud(rng, n, lo=(-100.0, -50.0), hi=(100.0, 50.0)):
    return np.stack([rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n)],
                    -1).astype(np.float32)


CASES = {
    # a random cloud, with a few points exactly on cell edges
    "cloud": lambda rng: np.concatenate([_cloud(rng, 500),
                                         np.float32([[-100.0 + 9.0 * k, -50.0 + 9.0 * k]
                                                     for k in range(8)])]),
    # 20 particles in one cell of capacity 4 (tests/test_grid.py:68-76)
    "crammed": lambda rng: np.zeros((20, 2), np.float32),
    # positions outside the bounds clip into the border cells
    "out_of_grid": lambda rng: _cloud(rng, 400, (-160.0, -90.0), (160.0, 90.0)),
}


@pytest.mark.parametrize("case,capacity", [("cloud", 16), ("crammed", 4), ("out_of_grid", 8)])
def test_build_grid_and_table_match_jax(rng, case, capacity):
    js, ts = _specs(capacity)
    pos = CASES[case](rng)
    jg = jbuild_grid(js, jnp.asarray(pos))
    tg = build_grid(ts, torch.from_numpy(pos))
    for f in GRID_FIELDS:
        got, want = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert got.dtype == want.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert int(tg.overflow) == int(jg.overflow)
    assert tg.table.shape == (ts.num_cells + 1, capacity)
    assert bool((tg.table[-1] == -1).all())  # the padding row stays empty
    if case == "crammed":
        assert int(tg.overflow) == 16 and int((tg.table >= 0).sum()) == 4
    # Without the table: the same grid, a [0, C] placeholder table.
    bare = build_grid(ts, torch.from_numpy(pos), with_table=False)
    assert tuple(bare.table.shape) == (0, capacity)
    for f in ("perm", "sorted_keys", "starts", "slot", "overflow"):
        assert torch.equal(getattr(bare, f), getattr(tg, f)), f


def test_gather_to_cells_matches_jax(rng):
    js, ts = _specs(16)
    pos = _cloud(rng, 200)
    vel = rng.uniform(-30, 30, (200, 2)).astype(np.float32)
    jg = jbuild_grid(js, jnp.asarray(pos))
    tg = build_grid(ts, torch.from_numpy(pos))
    want = np.asarray(jgather(jg, js, jnp.asarray(vel)[jg.perm]))
    got = gather_to_cells(tg, ts, torch.from_numpy(vel)[tg.perm.long()]).numpy()
    np.testing.assert_array_equal(got, want)
    table = tg.table.numpy()
    np.testing.assert_array_equal(got[table < 0], 0.0)  # empty slots are zero


@pytest.mark.parametrize("bounds,aspect", [(BOUNDS, 1), ((0.0, 45.0, 0.0, 30.0), 1),
                                           (BOUNDS, 2)])
def test_neighbor_cell_ids_match_jax(bounds, aspect):
    js, ts = _specs(8, bounds, cell_aspect=aspect)
    got = ts.neighbor_cell_ids()
    want = np.asarray(js.neighbor_cell_ids())
    assert got.dtype == torch.int32 and tuple(got.shape) == (ts.num_cells, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got == ts.num_cells).sum()) > 0  # border cells reach the padding row


@pytest.mark.parametrize("n,safety", [(1000, 4.0), (100_000, 16.0), (50_000, 16.0), (3, 1.0)])
def test_suggest_capacity_matches_jax(n, safety):
    assert suggest_capacity(n, BOUNDS, 9.0, safety) == jsuggest(n, BOUNDS, 9.0, safety)
    js, ts = _specs(1)
    assert suggest_capacity(n, ts, safety=safety) == jsuggest(n, js, safety=safety)
    assert suggest_capacity(n, BOUNDS, 9.0, safety) >= 8
