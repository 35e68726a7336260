"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: ``nvcc`` compiles every ``csrc/*.cu`` into
one shared library on first use, and ctypes binds it.  No PyTorch header is
compiled, so a cold build takes seconds.  The library lands in
``build/rps_torch_kernels/`` under the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is reused.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "rps_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "rps_plane_build": [_P, _P, _P, _P, _I, _I, _I, _P],
    "rps_rebin": [_P] * 5 + [_I] * 7 + [_F] * 4 + [_P],
    "rps_hole_fill_pass": [_P] * 7 + [_I] * 9 + [_F] * 4 + [_P],
    "rps_rebin_compact": [_P] * 4 + [_I] * 4 + [_F] * 4 + [_P],
    "rps_density": [_P] * 4 + [_I] * 5 + [_F] * 3 + [_P],
    "rps_force_integrated": [_P] * 13 + [_I] * 5 + [_F] * 9 + [_P],
    "rps_force": [_P] * 11 + [_I] * 5 + [_F] * 2 + [_P],
    "rps_pair_density": [_P] * 4 + [_I] * 5 + [_F] * 3 + [_P],
    "rps_pair_force_integrated": [_P] * 13 + [_I] * 5 + [_F] * 9 + [_P],
    "rps_pair_force": [_P] * 11 + [_I] * 5 + [_F] * 2 + [_P],
    "rps_nbody_accel": [_P, _P, _I, _F, _F, _F, _P],
    "rps_splat_planes": [_P] * 6 + [_I] * 10 + [_F] * 3 + [_P],
    "rps_splat_cells": [_P] * 7 + [_I] * 6 + [_F] * 2 + [_P],
    "rps_fm_moments": [_P] * 4 + [_I] * 5 + [_F] * 3 + [_P],
    "rps_fm_eval": [_P] * 4 + [_I] * 5 + [_F] * 3 + [_P],
    "rps_c128_a_dot": [_P, _P, _I, _P],
    "rps_c128_a_vpu": [_P, _P, _I, _P],
    "rps_c128_c_vpu": [_P, _P, _P, _I, _P],
    "rps_probe_dot_f32": [_P] * 3 + [_I] * 3 + [_P],
    "rps_probe_dot_tf32": [_P] * 3 + [_I] * 3 + [_P],
    "rps_probe_copy": [_P, _P, _I, _F, _P],
    "rps_probe_bf16": [_P, _P, _I, _I, _P],
    "rps_probe_bf16_outer": [_P] * 3 + [_I] * 4 + [_P],
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ on first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librps_torch_kernels_{_digest()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is already built:
    one nvcc per source, all started together, then one link."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for src, obj in zip(srcs, objs)]
        failed = []
        for src, proc in zip(srcs, procs):  # wait for every compile, failed or not
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        lib = str(Path(tmp) / "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(lib, so)  # atomic: a concurrent reader never sees a torn library
    return so


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def require_cuda_planes(*tensors: torch.Tensor) -> None:
    """Kernel input contract: contiguous float32 CUDA tensors of one shape on
    one device."""
    dev, shape = tensors[0].device, tensors[0].shape
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("expected contiguous float32 planes")
        if t.shape != shape:
            raise ValueError(f"plane shapes differ: {tuple(t.shape)} vs {tuple(shape)}")


def dispatch(t: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA tensor; anything else raises.

    The plain PyTorch version runs ONLY for CPU tensors: a CUDA tensor always
    goes to the kernel (or raises), never back to the plain version."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"unsupported device {t.device}")
