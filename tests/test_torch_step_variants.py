"""Port vs JAX: ``plane_step`` / ``plane_frame`` with the rebin's other variants.

Variants 5 and 6 share the frame after the rebin (the defer mask, the fused or
unfused walk); variants 2, 3 and 4 take JAX's other branch (resident.py:
297-300): no defer mask, the raw walk on the rebinned planes, the torch tail,
and ``lost`` grows by what the rebin dropped (``live_before - sum(min(counts,
C))``).  Bars: tests/test_rebin.py:478-481's after four live frames (pos atol
5e-4, vel atol 5e-3, in id order), tests/test_torch_frame.py's for one live
rendered frame; ``lost`` and the ids exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_frame import _setup as _frame_setup
from test_torch_step import _by_id, _setup

from rust_particle_system_tpu.ops.pallas import resident as JR
from rust_particle_system_tpu_torch.ops.cuda import resident as R


def _compare_lossy(jps, tps, pos_atol, vel_atol):
    """Ids (dropped particles last), positions and velocities in id order;
    ``lost`` and the live count exactly."""
    jpos, jvel, jids = _by_id(jps)
    tpos, tvel, tids = _by_id(tps)
    np.testing.assert_array_equal(tids, jids)
    live = tids < tps.n
    np.testing.assert_allclose(tpos[live], jpos[live], rtol=0, atol=pos_atol)
    np.testing.assert_allclose(tvel[live], jvel[live], rtol=0, atol=vel_atol)
    assert int(tps.lost) == int(jps.lost)
    assert int(tps.live.sum()) == int(np.asarray(jps.live).sum()) == tps.n - int(tps.lost)


@pytest.mark.parametrize("variant", [2, 3, 4, 5])
def test_plane_step_variant_matches_jax(rng, variant):
    """Four live frames of n=512 at C=16 under gravity 400: the denser middle
    rows overflow at variants 2-4, which lose the same particles as JAX."""
    js, jp, jps, ts, tp, tps = _setup(rng)
    jps = dataclasses.replace(jps, frame=jnp.asarray(5, jnp.int32))
    tps = dataclasses.replace(tps, frame=5)
    for _ in range(4):
        jps = JR.plane_step(jps, jp, js, variant=variant)
        tps = R.plane_step(tps, tp, ts, variant=variant)
    _compare_lossy(jps, tps, 5e-4, 5e-3)
    if variant == 5:
        assert int(tps.lost) == 0


def test_plane_step_v4_drops_exactly_the_escapes(rng):
    """tests/test_rebin.py:493-521: every live slot moving three cells in one
    frame.  Variant 5 loses none; variant 4 loses exactly the particles whose
    key lies more than one cell from their resident cell."""
    _, _, _, ts, tp, tps = _setup(rng, n=64)
    fast = 3.0 * ts.cell_width / tp.dt
    tps = dataclasses.replace(tps, vx=torch.where(tps.live, fast, 0.0), frame=10)
    live_before = int(tps.live.sum())
    out5 = R.plane_step(tps, tp, ts, variant=5)
    assert int(out5.lost) == 0 and int(out5.live.sum()) == live_before
    predx = (tps.px + tps.vx * tp.dt).numpy()
    kx = np.clip(np.floor((predx - ts.x_min) / ts.cell_width).astype(int), 0, ts.gw - 1)
    src_cx = np.arange(ts.gw)[None, :, None]
    escapes = int(np.sum(tps.live.numpy() & (np.abs(kx - src_cx) > 1)))
    assert escapes > 0
    out4 = R.plane_step(tps, tp, ts, variant=4)
    assert int(out4.lost) == escapes
    assert int(out4.live.sum()) == live_before - escapes


def test_plane_frame_variant_4_matches_jax():
    """One live rendered frame at variant 4 (the other branch after the
    rebin), image and state."""
    js, jp, jps, ts, tp, tps, jrs, trs = _frame_setup(3, gravity=400.0)
    jnew, jimg = JR.plane_frame(jps, jp, js, jrs, bounds_static=(-96.0, 96.0, -54.0, 54.0),
                                variant=4)
    tnew, timg = R.plane_frame(tps, tp, ts, trs, bounds_static=(-96.0, 96.0, -54.0, 54.0),
                               variant=4)
    assert tnew.frame == int(jnew.frame) == 1
    _compare_lossy(jnew, tnew, 1e-4, 1e-2)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=1e-3, atol=1e-3)


def test_unknown_variant_raises(rng):
    _, _, _, ts, tp, tps = _setup(rng, n=64)
    with pytest.raises(ValueError, match="variant"):
        R.plane_step(tps, tp, ts, variant=7)
    with pytest.raises(ValueError, match="variant"):  # in warm-up too
        R.plane_step(dataclasses.replace(tps, frame=0), tp, ts, variant=1)
