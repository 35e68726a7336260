"""Port vs JAX: the fast mode (``protos/mxu_fast_forces.py``) and its stages.

The JAX script runs in interpret mode on the CPU; it parses ``sys.argv`` when
it is imported, so it is loaded by importlib with ``sys.argv`` set to
``check 12`` and restored after.  One geometry throughout: 2,000 uniform
particles on (-72, 72, -45, 45), h = 9 (11 x 17 cells, not a multiple of the
TPU kernels' 8 cells a program, so their padding path runs), capacity 32,
degree 12.  Both packages get the same numpy planes.  Tolerances: stages
A and C at 1e-5 of each output's scale (the sums run in another order),
the whole force pass at 1e-4 (the pressure passes through rho and P~
between the passes), the oracle at 1e-5.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu.ops.grid import GridSpec as JGridSpec
from rust_particle_system_tpu_torch.core.state import make_state
from rust_particle_system_tpu_torch.ops.cuda import fast_forces as K14
from rust_particle_system_tpu_torch.ops.cuda.resident import plane_state_from_particles
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.protos import mxu_fast_forces as ff

ROOT = Path(__file__).resolve().parents[1]
BOUNDS = (-72.0, 72.0, -45.0, 45.0)
H = 9.0
N = 2000
CAP = 32
SPEC = GridSpec.from_bounds(BOUNDS, H, CAP)


@functools.lru_cache(maxsize=None)
def _jax_proto():
    argv = sys.argv
    sys.argv = ["mxu_fast_forces.py", "check", "12"]
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_mxu_fast_forces", ROOT / "protos" / "mxu_fast_forces.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


@functools.lru_cache(maxsize=None)
def _planes():
    """numpy (px, py, vx, vy) planes [11, 17, 32]: 2,000 uniform particles
    binned by the port's plane init, random velocities on live slots."""
    rng = np.random.default_rng(7)
    pos = np.stack([rng.uniform(BOUNDS[0], BOUNDS[1], N),
                    rng.uniform(BOUNDS[2], BOUNDS[3], N)], -1).astype(np.float32)
    ps = plane_state_from_particles(make_state(torch.from_numpy(pos)), SPEC)
    assert int(ps.lost) == 0 and (SPEC.gh, SPEC.gw) == (11, 17)
    live = ps.live.numpy()
    vx = np.where(live, 30.0 * rng.standard_normal(live.shape), 0.0).astype(np.float32)
    vy = np.where(live, -30.0 * np.abs(rng.standard_normal(live.shape)), 0.0).astype(np.float32)
    return ps.px.numpy(), ps.py.numpy(), vx, vy


def _jspec():
    return JGridSpec.from_bounds(BOUNDS, H, capacity=CAP)


@functools.lru_cache(maxsize=None)
def _cs():
    return ff.build_transfers(H)


def _close(got, want, rtol_of_scale, mask=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= rtol_of_scale * scale, f"max err {err:.3e} > {rtol_of_scale} x {scale:.3e}"


def test_build_transfers_bit_equal_to_jax():
    """JAX ``build_transfers`` (mxu_fast_forces.py:104-123) at h = 9, deg 12."""
    got = _cs().numpy()
    want = np.asarray(_jax_proto().build_transfers(H))
    assert got.shape == (3, 9, 256, 256) and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_w", [1, 4])
def test_moments_match_jax(n_w):
    """K14a's plain version vs JAX ``moments`` (the Pallas kernel at :182,
    interpret mode), 1 and 4 weight channels, 1e-5 of scale; 0 in the
    padding of each [16, 16] block."""
    px, py, vx, vy = _planes()
    rng = np.random.default_rng(n_w)
    live = px < 5e5
    weights = [np.where(live, 1.0, 0.0).astype(np.float32)]
    weights += [vx, vy, rng.standard_normal(px.shape).astype(np.float32)][:n_w - 1]
    want = np.asarray(_jax_proto().moments(jnp.asarray(px), jnp.asarray(py),
                                           [jnp.asarray(w) for w in weights], _jspec(), H))
    got = K14.moments(torch.from_numpy(px), torch.from_numpy(py),
                      [torch.from_numpy(w) for w in weights], SPEC, H).numpy()
    assert got.shape == want.shape == (11, 17, n_w, 256)
    _close(got, want, 1e-5)
    blocks = got.reshape(11, 17, n_w, 16, 16)
    assert not blocks[..., 13:, :].any() and not blocks[..., :, 13:].any()


@pytest.mark.parametrize("n_pairs", [1, 7])
def test_evaluate_matches_jax(n_pairs):
    """K14c's plain version vs JAX ``evaluate`` (the Pallas kernel at :264,
    interpret mode) on seeded transfer planes, 1 and 7 pairs, 1e-5 of scale;
    dead slots 0."""
    px, py, _, _ = _planes()
    L = np.random.default_rng(10 + n_pairs).standard_normal(
        (11, 17, n_pairs, 256)).astype(np.float32)
    want = _jax_proto().evaluate(jnp.asarray(px), jnp.asarray(py), jnp.asarray(L), _jspec(),
                                 H, n_pairs)
    got = K14.evaluate(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(L), SPEC,
                       H, n_pairs)
    assert len(got) == len(want) == n_pairs
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5)
        assert not g.numpy()[px >= 5e5].any()


@functools.lru_cache(maxsize=None)
def _port_forces():
    px, py, vx, vy = (torch.from_numpy(a) for a in _planes())
    return (ff.fast_forces(px, py, vx, vy, SPEC, H, _cs()),
            ff.oracle_forces(px, py, vx, vy, H))


def test_fast_forces_match_jax():
    """JAX ``fast_forces`` (:285-303) on the same planes, 1e-4 of each
    output's scale over the live slots."""
    px, py, vx, vy = _planes()
    jp = _jax_proto()
    want = jp.fast_forces(*(jnp.asarray(a) for a in (px, py, vx, vy)), _jspec(), H,
                          jp.build_transfers(H))
    for g, w in zip(_port_forces()[0], want):
        _close(g.numpy(), w, 1e-4, px < 5e5)


def test_oracle_forces_match_jax():
    """JAX ``oracle_forces`` (:311-360), 1e-5 of each output's scale."""
    px, py, vx, vy = _planes()
    want = _jax_proto().oracle_forces(*(jnp.asarray(a) for a in (px, py, vx, vy)), H)
    for g, w in zip(_port_forces()[1], want):
        _close(g.numpy(), w, 1e-5, px < 5e5)


def test_fast_mode_within_bars_of_its_oracle():
    """The port's fast mode against its own oracle at the check bars (rho,
    fvx, fvy 5e-4; fx, fy 1e-2 rel-max; JAX measured 1.4e-4 / 3.3e-3 on the
    TPU at 30k)."""
    live = _planes()[0] < 5e5
    got, want = _port_forces()
    for name, g, w in zip(ff.NAMES, got, want):
        g, w = g.numpy()[live].astype(np.float64), w.numpy()[live].astype(np.float64)
        assert np.abs(g - w).max() <= ff.BARS[name] * np.abs(w).max(), name


def test_main_check_on_the_cpu(capsys):
    assert ff.main(["check", "--device", "cpu", "--n", "3000"]) == 0
    out = capsys.readouterr().out
    assert all(f"{name:4s}: rel-max" in out for name in ff.NAMES)
    assert "EXCEEDED" not in out


def test_time_modes_and_argv_checks():
    with pytest.raises(ValueError, match="deg"):
        ff.main(["check", "16", "--device", "cpu"])
    assert ff.main(["time", "--device", "cpu"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ff.main(["check"])


def test_transfers_refuse_tf32():
    """Stage B runs in full float32 (JAX pins Precision.HIGHEST); it raises
    rather than switch a caller's TF32 setting back."""
    M = torch.zeros((2, 3, 1, 256))
    assert ff.transfers(M, [(0, 0)], _cs()).shape == (2, 3, 1, 256)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            ff.transfers(M, [(0, 0)], _cs())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_wrappers_check_their_inputs():
    px = torch.zeros((11, 17, CAP))
    with pytest.raises(ValueError, match="deg"):
        K14.moments(px, px, [px], SPEC, H, deg=0)
    with pytest.raises(ValueError, match="weight planes"):
        K14.moments(px, px, [px] * 5, SPEC, H)
    with pytest.raises(ValueError, match="grid"):
        K14.moments(px[:5], px[:5], [px[:5]], SPEC, H)
    with pytest.raises(ValueError, match="256"):
        K14.evaluate(px, px, torch.zeros((11, 17, 2, 256)), SPEC, H, 1)
    meta = torch.zeros((11, 17, CAP), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K14.moments(meta, meta, [meta], SPEC, H)


def test_kernels_match_plain_on_the_card():
    """K14a and K14c against their plain versions on the card (needs one)."""
    if not torch.cuda.is_available():
        pytest.skip("K14a/K14c run on a CUDA card only")
    px, py, vx, vy = (torch.from_numpy(a).cuda() for a in _planes())
    w = [torch.where(px < 5e5, 1.0, 0.0), vx, vy, px * 0 + 2.0]
    _close(K14.moments(px, py, w, SPEC, H).cpu(),
           K14.moments_plain(px, py, w, SPEC, H).cpu(), 1e-5)
    L = torch.randn((11, 17, 7, 256), device="cuda")
    for g, p in zip(K14.evaluate(px, py, L, SPEC, H, 7),
                    K14.evaluate_plain(px, py, L, SPEC, H, 7)):
        _close(g.cpu(), p.cpu(), 1e-5)
