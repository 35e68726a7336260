"""The N-body kernel's decomposition (K8; csrc/nbody.cu), on the CPU.

The kernel runs only on the card.  Its decomposition is fixed in its source,
and these tests read it from there (the particles a thread holds, the j
slices, the block shape, the grid, the i and j mappings and the combine) and
hold it: for n in {1, 31, 1000, 16,383, 16,384} every i is held by exactly one
thread of one block and written once, the slices of every block cover each j
exactly once, and the launch at n = 16,384 puts at least 16 warps on each of
the H100's 132 SMs.

Then a float32 numpy model of the kernel's sum: per slice in j order, the
regrouped pair expression, the slices added in slice order.  It is held against
the port's plain version and the JAX dense ``nbody_accel`` at the bar of
``chip_smoke.py``: rtol 2e-4 / atol 2e-3 (tests/test_pallas_nbody.py:18),
the relative part taken of sum_j |delta_ij w_ij|, coincident particles
included.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_particle_system_tpu import models as jmodels
from rust_particle_system_tpu_torch import interop
from rust_particle_system_tpu_torch.ops.cuda import nbody as NB

SRC = (Path(NB.__file__).resolve().parents[2] / "csrc" / "nbody.cu").read_text()
SMS = 132  # streaming multiprocessors of an H100 SXM
F32, F64 = np.float32, np.float64


def _py(expr: str) -> str:
    """A C expression of nbody.cu as Python (integer division, no casts)."""
    expr = re.sub(r"static_cast<\w+>", "", expr).replace("&&", " and ")
    return expr.replace("r.", "").replace("/", "//")


def _one(pattern: str) -> str:
    found = re.findall(pattern, SRC)
    assert len(found) == 1, (pattern, found)
    return found[0]


CONSTS = {name: int(_one(rf"constexpr int {name} = (\d+);"))
          for name in ("kPerThread", "kSlices", "kChunk")}
for _name in ("kThreads", "kBlockI"):
    CONSTS[_name] = eval(_py(_one(rf"constexpr int {_name} = (.*?);")), {}, CONSTS)
_GRID = _py(_one(r"nbody_kernel<<<(.*?), kThreads, 0,"))
_I0 = _py(_one(r"const int i0 = (blockIdx\.x \* kBlockI);"))
_I = _py(_one(r"const int i = (i0 \+ u \* 32 \+ lane);"))
_LANE_SLICE = tuple(map(_py, _one(r"const int lane = (.*?), slice = (.*?);")))
_LEN = _py(_one(r"const int len = (.*?);"))
_J = tuple(map(_py, _one(r"const int j_lo = (.*?), j_hi = (.*?);")))
_WRITE = _py(_one(r"if \((threadIdx\.x < kBlockI && i0 \+ static_cast<int>\(threadIdx\.x\) "
                  r"< n)\)"))
_COMBINE = _one(r"for \(int s = 0; s < (kSlices); \+\+s\) \{\s*sx \+= part\[s\]")


@functools.lru_cache(maxsize=None)
def _code(expr):
    return compile(expr, "nbody.cu", "eval")


def _ev(expr, **env):
    return eval(_code(expr), {"min": min, "max": max}, dict(CONSTS, **env))


def _threads():
    return [type("T", (), {"x": t}) for t in range(CONSTS["kThreads"])]


def test_the_source_is_the_sliced_design():
    kernel = SRC[SRC.index("__global__ void"):SRC.index("}  // namespace")]
    assert not re.search(r"atomic[A-Z]", SRC), "a fixed combine order: no atomics"
    assert kernel.count("__syncthreads()") == 1, "one sync, before the combine"
    assert "rsqrtf(" in kernel
    assert _COMBINE == "kSlices"
    assert CONSTS["kPerThread"] >= 2, "each staged j serves several pairs"
    assert CONSTS["kThreads"] == 32 * CONSTS["kSlices"]


@pytest.mark.parametrize("n", [1, 31, 1000, 16_383, 16_384])
def test_every_i_and_j_is_covered_once(n):
    held = np.zeros(n, int)
    written = np.zeros(n, int)
    threads = [(th, *(_ev(e, threadIdx=th) for e in _LANE_SLICE)) for th in _threads()]
    for bx in range(_ev(_GRID, n=n)):
        i0 = _ev(_I0, blockIdx=type("B", (), {"x": bx}))
        swept = np.zeros(n, int)
        for th, lane, slice_ in threads:
            for u in range(CONSTS["kPerThread"]):
                i = _ev(_I, i0=i0, u=u, lane=lane)
                if i < n and slice_ == 0:
                    held[i] += 1
            if _ev(_WRITE, threadIdx=th, i0=i0, n=n):
                written[i0 + th.x] += 1
            if lane == 0:  # a warp per slice
                length = _ev(_LEN, n=n)
                assert length % CONSTS["kChunk"] == 0
                lo = _ev(_J[0], n=n, slice=slice_, len=length)
                swept[lo:_ev(_J[1], n=n, j_lo=lo, len=length)] += 1
        assert np.all(swept == 1), "the slices cover each j once"
    assert np.all(held == 1) and np.all(written == 1)


def test_the_launch_fills_the_card_at_16k():
    """At n = 16,384 (BASELINE.json config 3): at least one block on every SM,
    each of at least 16 warps."""
    blocks = _ev(_GRID, n=16_384)
    assert blocks >= SMS and CONSTS["kThreads"] // 32 >= 16
    assert blocks * CONSTS["kThreads"] // 32 >= 16 * SMS


# ---------------- the float32 model of the sliced sum ----------------


def _fma(a, b, c):
    return (a.astype(F64) * b + c).astype(F32)


def model_accel(pos, g_const, rep_soft, eps2):
    """K8's sums in float32: for every i, each slice's pairs in j order
    (w = s^3 (G - R eps s)), then the slices added in slice order."""
    n = pos.shape[0]
    px, py = pos[:, 0], pos[:, 1]
    g, rs, e2 = F32(g_const), F32(rep_soft), F32(eps2)
    length = _ev(_LEN, n=n)
    ax, ay = np.zeros(n, F32), np.zeros(n, F32)
    for s in range(CONSTS["kSlices"]):
        lo = _ev(_J[0], n=n, slice=s, len=length)
        hi = _ev(_J[1], n=n, j_lo=lo, len=length)
        sx, sy = np.zeros(n, F32), np.zeros(n, F32)
        for j in range(lo, hi):
            dx, dy = pos[j, 0] - px, pos[j, 1] - py
            inv = (1.0 / np.sqrt(_fma(dx, dx, _fma(dy, dy, e2)).astype(F64))).astype(F32)
            w = inv * inv * inv * _fma(-rs, inv, g)
            sx, sy = _fma(dx, w, sx), _fma(dy, w, sy)
        ax, ay = ax + sx, ay + sy
    return np.stack([ax, ay], 1)


def _term_scale(pos, p):
    """sum_j |delta_ij w_ij| in float64: the magnitude each f32 sum carries."""
    d = pos[None].astype(F64) - pos[:, None]
    inv = 1.0 / np.sqrt((d * d).sum(-1) + F64(p.softening) ** 2)
    w = p.g_const * inv ** 3 - p.repulsion * p.softening * inv ** 4
    return (np.abs(d) * np.abs(w)[..., None]).sum(1)


def _positions(kind, n, rng):
    pos = rng.uniform(-500, 500, (n, 2)).astype(F32)
    if kind == "coincident":
        pos[: n // 2] = pos[0]
    return pos


@pytest.mark.parametrize("kind, n", [("uniform", 1), ("uniform", 31), ("uniform", 1000),
                                     ("coincident", 1000), ("uniform", 1100)])
def test_model_within_the_bar_of_plain_and_jax(kind, n):
    """1000: not a multiple of 32 * kPerThread nor of the slices' 32-aligned
    length; 1100: the last slice short; half the particles on one point."""
    rng = np.random.default_rng(n + len(kind))
    pos = _positions(kind, n, rng)
    jp = jmodels.make_nbody_params()
    p = interop.params_from_numpy({f"params/{f}": np.asarray(getattr(jp, f))
                                   for f in jp._fields})
    got = model_accel(pos, p.g_const, F32(p.repulsion) * F32(p.softening),
                      F32(p.softening) * F32(p.softening))
    assert np.all(np.isfinite(got))
    bar = 2e-3 + 2e-4 * _term_scale(pos, p)
    plain = NB.nbody_accel(torch.from_numpy(pos), p).numpy()
    dense = np.asarray(jmodels.nbody_accel(jnp.asarray(pos), jp))
    for want in (plain, dense):
        assert np.all(np.abs(got - want) <= bar), np.max(np.abs(got - want) - bar)
