"""The command itself: without the cards a cell asks for it fails and prints
no result, never falls back to the CPU; nothing it loads is JAX or the JAX
package, and nothing in the benchmark's sources imports them."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness import purity

ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _run(cwd, workload="sph16m_headless"):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=ENV, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone (no program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_top_level_names_are_compared_whole():
    assert purity.loaded_forbidden(["rust_particle_system_tpu_torch.ops", "numpy"]) == []
    assert purity.loaded_forbidden(["rust_particle_system_tpu.ops", "jax.numpy", "jaxlib",
                                    "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "rust_particle_system_tpu.ops"]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH) for p in BENCH.rglob("*.py")),
                         ids=str)
def test_sources_import_no_jax(path):
    assert not purity.imports_of(BENCH / path) & purity.FORBIDDEN


def test_a_run_loads_no_jax(mini):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import purity, result\n"
            "line = result.measure('sph16m_render', 3, 0.05, False, 'cpu', __import__('pathlib').Path(%r))\n"
            "assert line['correct'], line\n"
            "print(purity.loaded_forbidden())\n") % (str(BENCH), str(ROOT), str(mini))
    p = subprocess.run([sys.executable, "-c", code], env=ENV, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
