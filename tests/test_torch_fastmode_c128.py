"""Port vs JAX: the fast mode's C = 128 contraction forms (K14d-f).

``protos/fastmode_c128.py`` is a script that times its kernels when it is
imported, at 8,768 cells.  Its definitions (imports, constants, the three
``make_*`` builders) are run here without its top-level statements (the
compilation-cache settings and the timing calls), ``NCP`` is cut to 16 cells
(2 programs of its 8 cells), and each builder's ``pallas_call`` is taken
from it and run in interpret mode on the port's seeded weights.  Bar: each
plain version within 1e-5 of the output's scale (the sums over slots or
basis terms run in another order).
"""

import ast
import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rust_particle_system_tpu_torch.ops.cuda import fastmode_c128 as K14
from rust_particle_system_tpu_torch.protos import fastmode_c128 as proto

ROOT = Path(__file__).resolve().parents[1]
CELLS = 16


@functools.lru_cache(maxsize=None)
def _jax_calls():
    """{form: the JAX probe's pallas_call at NCP = 16, interpret mode}."""
    path = ROOT / "protos" / "fastmode_c128.py"
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if not isinstance(n, ast.Expr)]
    calls = []

    class Pallas:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(kernel, **kw):
            calls.append(pl.pallas_call(kernel, interpret=True, **kw))
            return calls[-1]

    ns = {"__name__": "_jax_fastmode_c128"}
    argv = sys.argv
    sys.argv = ["fastmode_c128.py"]
    try:
        exec(compile(tree, str(path), "exec"), ns)
    finally:
        sys.argv = argv
    ns["pl"] = Pallas()
    ns["NCP"] = CELLS
    for make in ("make_a_dot", "make_a_vpu", "make_c_vpu"):
        ns[make]()
    return dict(zip(("a_dot", "a_vpu", "c_vpu"), calls))


def _close(got, want, rtol_of_scale=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol_of_scale * scale, f"max err {err:.3e} > {rtol_of_scale} x {scale:.3e}"


def test_a_dot_matches_jax():
    """K14d's plain version vs ``make_a_dot`` (fastmode_c128.py:77-105, the
    pallas_call at :91): [16, 13, 13]."""
    w, _ = proto.inputs(CELLS, "cpu", seed=1)
    want = _jax_calls()["a_dot"](jnp.asarray(w.numpy()))
    got = K14.a_dot(w)
    assert got.shape == want.shape == (CELLS, 13, 13)
    _close(got, want)


def test_a_vpu_matches_jax():
    """K14e's plain version vs ``make_a_vpu`` (:109-133, the pallas_call at
    :119): [16, 176, 1] there, [16, 176] here."""
    w, _ = proto.inputs(CELLS, "cpu", seed=2)
    want = np.asarray(_jax_calls()["a_vpu"](jnp.asarray(w.numpy())))
    assert want.shape == (CELLS, 176, 1)
    _close(K14.a_vpu(w), want[..., 0])


def test_c_vpu_matches_jax():
    """K14f's plain version vs ``make_c_vpu`` (:137-164, the pallas_call at
    :147) on the same moments: [16, 1, 128] there, [16, 128] here."""
    w, l = proto.inputs(CELLS, "cpu", seed=3)
    want = np.asarray(_jax_calls()["c_vpu"](jnp.asarray(w.numpy()),
                                           jnp.asarray(l.numpy())[:, :, None]))
    assert want.shape == (CELLS, 1, 128)
    _close(K14.c_vpu(w, l), want[:, 0])


def test_main_on_the_cpu(capsys):
    assert proto.main(["2", "--device", "cpu", "--cells", "8"]) == 0
    out = capsys.readouterr().out
    assert all(label in out for label in ("A-dot", "A-vpu", "C-vpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            proto.main(["2"])


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="128"):
        K14.a_dot(torch.zeros((4, 64)))
    with pytest.raises(ValueError, match="moments"):
        K14.c_vpu(torch.zeros((4, 128)), torch.zeros((4, 169)))
    meta = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K14.a_vpu(meta)


def test_kernels_match_plain_on_the_card():
    """K14d-f against their plain versions on the card (needs one)."""
    if not torch.cuda.is_available():
        pytest.skip("K14d-f run on a CUDA card only")
    w, l = proto.inputs(proto.NCP, "cuda")
    _close(K14.a_dot(w).cpu(), K14.a_dot_plain(w).cpu())
    _close(K14.a_vpu(w).cpu(), K14.a_vpu_plain(w).cpu())
    _close(K14.c_vpu(w, l).cpu(), K14.c_vpu_plain(w, l).cpu())
