"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface: ``nvcc`` compiles every ``csrc/*.cu`` into
one shared library on first use, and ctypes binds it.  No PyTorch header is
compiled, so a cold build takes seconds.  The library lands in
``build/rps_torch_kernels/`` under the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is reused.

Each C entry point takes one packed record (:data:`RECORDS`), launches on the
stream the record names and returns ``cudaGetLastError()``; :func:`kernel`
binds an entry once and raises on a nonzero code.  The launch path is what
bounds the small kernels: a wrapper's host time per call is its checks, its
output allocation and one ctypes call with two converted arguments.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import struct
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "rps_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Each C entry ``rps_<name>(const void* packed, int size)`` takes its
# arguments as one packed record: the bytes of ``struct rps_<name>_args``
# (csrc/*.cu), packed here with ``struct`` in native layout, which pads as the
# C compiler does.  Field kinds: P a pointer (or the stream, always last), i
# an int, f a float; ``8P`` and ``8f`` are arrays, padded by :func:`pad8`.
# One converted argument per call, and pointers stay 64 bits.
RECORDS = {
    "rps_plane_build": "PPP8f3iP",
    "rps_rebin": "8P2P8P8P8P2PP8f7i6fP",
    "rps_hole_fill_pass": "8P8P8P8PPP8f9i4fP",
    "rps_rebin_compact": "8P8PP8f4i4fP",
    "rps_density": "4P5i3fP",
    "rps_force_integrated": "13P5i9fP",
    "rps_force": "11P5i2fP",
    "rps_pair_density": "4P5i3fP",
    "rps_pair_force_integrated": "13P5i9fP",
    "rps_pair_force": "11P5i2fP",
    "rps_density_pressure": "5P5i8fP",
    "rps_pair_density_pressure": "5P5i8fP",
    "rps_nbody_accel": "2Pi3fP",
    "rps_splat_planes": "8P12i9f4fP",
    "rps_splat_cells": "7P6i2fP",
    "rps_fm_moments": "2P8PP5i3fP",
    "rps_fm_eval": "3P8P5i3fP",
    "rps_c128_a_dot": "2PiP",
    "rps_c128_a_vpu": "2PiP",
    "rps_c128_c_vpu": "3PiP",
    "rps_probe_dot_f32": "3P3iP",
    "rps_probe_dot_tf32": "3P3iP",
    "rps_probe_copy": "2PifP",
    "rps_probe_bf16": "2P2iP",
    "rps_probe_bf16_outer": "3P4iP",
}
# The binding of every entry: the record's address and its size in bytes.
ARGTYPES = (ctypes.c_char_p, ctypes.c_int)
ARRAY = 8  # the length of a record's arrays (csrc/common.cuh, kMaxChannels)

_lib = None
_raw_stream = None


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


def library() -> ctypes.PyDLL:
    """The bound kernel library, built on first call."""
    global _lib, _raw_stream
    if _lib is None:
        # PyDLL: a call keeps the GIL.  An entry only enqueues a launch, and
        # releasing and retaking the GIL is a visible share of a small call.
        lib = ctypes.PyDLL(str(build()))
        for name in RECORDS:
            fn = getattr(lib, name)
            fn.argtypes = ARGTYPES
            fn.restype = ctypes.c_int
        # CUDA builds of torch only; Inductor's generated code reads the
        # current stream the same way, without a Stream object.  Device -1 is
        # the current device.
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _lib = lib
    return _lib


def kernel(name: str):
    """The launcher of C entry ``name``: ``launch(*fields)`` packs the fields
    of its record (``RECORDS[name]`` without the stream) with the handle of
    torch's current stream, calls the entry and raises if it returns a CUDA
    error.  The entry is looked up once, on the first launch."""
    record = struct.Struct(RECORDS[name] + "0P")  # "0P": trailing padding, as in C
    pack, size = record.pack, record.size
    fn = None

    def launch(*fields) -> None:
        nonlocal fn
        if fn is None:
            fn = getattr(library(), name)
        code = fn(pack(*fields, _raw_stream(-1)), size)
        if code:
            raise RuntimeError(f"{name}: CUDA error {code} at launch")

    launch.entry, launch.record = name, record
    return launch


def pad8(values) -> tuple:
    """A record's array: ``values`` (plane pointers or fills), then zeros
    (NULL pointers) up to its ARRAY slots."""
    if len(values) > ARRAY:
        raise ValueError(f"a record's array holds at most {ARRAY} values, got {len(values)}")
    return (*values, *(0,) * (ARRAY - len(values)))


def empty_f32(n: int, shape: tuple, like: torch.Tensor) -> list:
    """``n`` new float32 tensors of ``shape`` on ``like``'s device, one
    allocation each; ``empty_like`` where ``like`` (float32) has that shape,
    the cheapest allocation on the card's host."""
    if like.shape == shape:
        return [torch.empty_like(like) for _ in range(n)]
    return [torch.empty(*shape, dtype=torch.float32, device=like.device) for _ in range(n)]


def require_cuda(*tensors: torch.Tensor, dtype: torch.dtype = torch.float32) -> None:
    """Kernel input contract: contiguous CUDA tensors of ``dtype`` on one
    device.  Raises ValueError otherwise."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"expected CUDA tensors on one device, got {t.device} "
                             f"beside {tensors[0].device}")
        if t.dtype is not dtype or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype} tensors, got a "
                             f"{'' if t.is_contiguous() else 'non-contiguous '}{t.dtype} one")


def require_cuda_planes(*tensors: torch.Tensor) -> None:
    """:func:`require_cuda` for float32 planes, which must share one shape."""
    require_cuda(*tensors)
    shape = tensors[0].shape
    for t in tensors:
        if t.shape != shape:
            raise ValueError(f"plane shapes differ: {tuple(t.shape)} vs {tuple(shape)}")


def dispatch(t: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA tensor; anything else raises.

    The plain PyTorch version runs ONLY for CPU tensors: a CUDA tensor always
    goes to the kernel (or raises), never back to the plain version."""
    if t.is_cuda:
        return "cuda"
    if t.is_cpu:
        return "plain"
    raise ValueError(f"unsupported device {t.device}")
