"""Port vs JAX: the toolchain probes' plain halves (K13a-e), and the runtime's
timing and profiling helpers on CPU tensors.

The JAX probes (``tools/tpu_smoke.py``) run under
``pltpu.force_tpu_interpret_mode()``; ``protos/bf16_repro.py::kernel`` and
``main_round4``'s kernel run through an interpret-mode ``pallas_call``.  The
dot-precision trap itself cannot be shown on the CPU: interpret mode computes
DEFAULT in float32 and torch's CPU matmul ignores ``allow_tf32``, so only its
HIGHEST half is held to JAX here, and the TF32 emulation is shown to fall
outside it.  Bars: the
float32 dot within 1e-4 of JAX's HIGHEST product (JAX's own bar,
tpu_smoke.py:85); every pass-through, copy and broadcast bit for bit.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rust_particle_system_tpu_torch.ops.cuda import _lib
from rust_particle_system_tpu_torch.ops.cuda import toolchain_probe as K13
from rust_particle_system_tpu_torch.runtime.profiling import PhaseTimer, trace
from rust_particle_system_tpu_torch.runtime.timing import (
    hsync, hsync_one, time_chained, time_fn)
from rust_particle_system_tpu_torch.tools import toolchain_smoke as smoke

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _load(rel: str):
    spec = importlib.util.spec_from_file_location("_jax_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_onehot_passthrough_plain_matches_jax():
    """tpu_smoke.py:92-126 on its own inputs: JAX's kernel at HIGHEST and the
    port's plain FP32 dot and TF32-free torch.matmul all give vals[:, perm]
    bit for bit; the port's probe passes on the CPU."""
    with pltpu.force_tpu_interpret_mode():
        detail = _load("tools/tpu_smoke.py").smoke_onehot_passthrough_precision()
    assert "HIGHEST=True" in detail
    vals = jax.random.normal(jax.random.key(3), (8, 256), jnp.float32) * 1e3
    vals = np.array(vals.at[0, 0].set(np.float32(np.pi) * 1e-8))
    _, onehot, perm = smoke.onehot_inputs()
    assert np.array_equal(perm, np.random.default_rng(0).permutation(256)[:128])
    want = vals[:, perm]
    tv, to = torch.from_numpy(vals), torch.from_numpy(onehot)
    assert np.array_equal(_bits(K13.dot_f32_plain(tv, to)), _bits(want))
    assert np.array_equal(_bits(tv @ to), _bits(want))
    assert smoke.onehot_passthrough_precision("cpu").startswith("bit-exact: K13a=True")


def test_ids_copy_plain_matches_jax():
    """tpu_smoke.py:129-150: JAX's copy kernel keeps the id probes; the port's
    plain K13c keeps them and the two subnormals bit for bit."""
    with pltpu.force_tpu_interpret_mode():
        _load("tools/tpu_smoke.py").smoke_ids_f32_roundtrip()
    x = smoke.ids_inputs()
    assert np.array_equal(x[0, :8], np.float32(smoke.ID_PROBES))
    assert x[0, 8] == np.finfo(np.float32).smallest_subnormal and 0 < x[0, 9] < 1.2e-38
    got = K13.copy_ids_plain(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), x.view(np.uint32))
    assert smoke.ids_f32_roundtrip("cpu").startswith("integers")


def test_dot_plain_versions_against_jax_highest():
    """tpu_smoke.py:59-89, its HIGHEST half, on its own inputs: the plain FP32
    dot within 1e-4 of ``jnp.dot(..., precision=HIGHEST)``; the plain TF32
    emulation (K13b's) more than 1e-4 from it, as the trap needs."""
    a = jax.random.normal(jax.random.key(1), (128, 128), jnp.float32)
    b = jax.random.normal(jax.random.key(2), (128, 128), jnp.float32)
    want = np.asarray(jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST), np.float64)
    ta, tb = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))
    assert np.abs(K13.dot_f32_plain(ta, tb).numpy() - want).max() < 1e-4
    assert np.abs(K13.dot_tf32_plain(ta, tb).numpy() - want).max() > 1e-4


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest with 10 mantissa bits, ties away from zero; a
    subnormal keeps the bits of its encoding above the 13 dropped ones."""
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      3.0, 2 ** -120, 2 ** -149], dtype=torch.float32)
    want = [1 + 2 ** -10, 1.0, 1 + 2 * 2 ** -10, -(1 + 2 ** -10), 3.0, 2 ** -120, 0.0]
    assert K13.tf32_round(x).tolist() == want


def test_bf16_plain_matches_jax_repro():
    """protos/bf16_repro.py:20-25 (``kernel``) through an interpret-mode
    pallas_call, on seeded non-constant bf16 values and on JAX's ones."""
    kernel = _load("protos/bf16_repro.py").kernel
    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((4, 256), jnp.float32),
                          interpret=True)
    for x in (smoke.bf16_inputs(), torch.ones((8, 128), dtype=torch.bfloat16)):
        want = np.asarray(call(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)))
        got = K13.bf16_broadcast_plain(x).numpy()
        assert got.shape == (4, 256) and np.array_equal(_bits(got), _bits(want))
    assert smoke.bf16_broadcast_reshape("cpu").startswith("bf16")


def test_bf16_outer_plain_matches_jax_round4(monkeypatch):
    """protos/bf16_repro.py:59-62 (``main_round4``'s kernel, taken from its
    pallas_call at :65) in interpret mode, on JAX's ones and on seeded
    non-constant values: the plain K13e gives its bits.  XLA on the CPU keeps
    a bf16 product in float32 unless told not to (excess precision, on by
    default); compiled with it off, the product is rounded to bf16 as the
    kernel's types say, and as K13e rounds it."""
    kernels = []
    real = pl.pallas_call

    def spy(kernel, **kw):
        kernels.append(kernel)
        return real(kernel, interpret=True, **kw)

    monkeypatch.setattr(pl, "pallas_call", spy)
    _load("protos/bf16_repro.py").main_round4()
    monkeypatch.undo()
    (kernel,) = kernels
    call = jax.jit(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, 40, 128), jnp.float32), interpret=True))
    for a, b in ((torch.ones((8, 128)),) * 2, smoke.bf16_outer_inputs()):
        ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
        want = np.asarray(call.lower(ja, jb).compile(
            compiler_options={"xla_allow_excess_precision": False})(ja, jb))
        got = K13.bf16_outer_plain(a, b).numpy()
        assert got.shape == (8, 40, 128) and np.array_equal(_bits(got), _bits(want))
    # On the seeded values the roundings show: the float32 product of the
    # bf16 inputs (XLA's default here) is not the bf16 product.
    exact = (a[:, :40, None].bfloat16().float() * b[:, None, :].bfloat16().float()).numpy()
    assert np.array_equal(np.asarray(call(ja, jb)), exact)
    assert not np.array_equal(want, exact)
    assert smoke.bf16_outer_product("cpu").startswith("bf16")


def test_nvcc_flags_keep_subnormals():
    """K13c's property is a build property: no -ftz and no fast math."""
    flags = " ".join(_lib.NVCC_FLAGS).lower()
    assert "ftz" not in flags and "fast_math" not in flags and "fast-math" not in flags


def test_probe_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="multiply"):
        K13.dot_f32(torch.zeros((4, 3)), torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="even"):
        K13.bf16_broadcast(torch.zeros((3, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="outer product"):
        K13.bf16_outer(torch.zeros((8, 16)), torch.zeros((8, 128)))
    meta = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K13.dot_tf32(meta, meta)


def test_toolchain_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes run (see the next test)")
    assert smoke.main([]) == 1
    assert "no CUDA card" in capsys.readouterr().out


def test_probes_on_the_card():
    """K13a-e against their plain versions and the five probes (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("K13a-e run on a CUDA card only")
    a, b = (torch.from_numpy(m).cuda() for m in smoke.dot_inputs())
    assert torch.allclose(K13.dot_f32(a, b), K13.dot_f32_plain(a, b), rtol=0, atol=1e-4)
    assert torch.allclose(K13.dot_tf32(a, b), K13.dot_tf32_plain(a, b), rtol=0, atol=1e-3)
    assert torch.equal(K13.bf16_outer(a, b), K13.bf16_outer_plain(a, b))
    assert smoke.main([]) == 0


def test_time_fn_and_time_chained_on_cpu_tensors():
    """runtime/timing.py: median over distinct argsets, one barrier per call
    (none for CPU tensors), and a chain of ``iters`` steps."""
    calls = []

    def fn(x):
        calls.append(float(x))
        return {"y": (x + 1,), "z": [x * 2]}

    argsets = [(torch.tensor(float(i)),) for i in range(3)]
    t = time_fn(fn, argsets, reps=5, warm=2)
    assert isinstance(t, float) and t >= 0.0
    assert calls == [0.0, 1.0, 0.0, 1.0, 2.0, 0.0, 1.0]
    per, out = time_chained(lambda s: s + 1, torch.zeros(3), 4)
    assert per >= 0.0 and torch.equal(out, torch.full((3,), 4.0))
    hsync({"a": [torch.ones(2)], "b": None})
    hsync_one(())


def test_phase_timer_accumulates():
    """tests/test_debug_and_diff.py:53-60 on the port's PhaseTimer."""
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("work"):
            pass
    stats = t.report()
    assert stats["work"]["calls"] == 3 and stats["work"]["mean_ms"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert events and prof.key_averages()
