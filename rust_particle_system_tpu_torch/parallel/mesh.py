"""The band mesh: one process per band of cell rows, joined by torch.distributed.

Counterpart of ``rust_particle_system_tpu/parallel/mesh.py::make_band_mesh``.
JAX's 1-D device mesh becomes a process group with one rank per band, in
band order, so band b's neighbours are ranks b - 1 and b + 1.

The transport is the caller's choice of backend, never a fallback:

* ``nccl``: one rank per card (``torchrun --nproc-per-node N``); halos and
  collectives move device buffers.
* ``gloo``: several bands on one card, or on the CPU.  NCCL refuses two ranks
  on one GPU, and gloo's point-to-point takes CPU tensors only, so under gloo
  every exchange and collective stages its buffer through the host
  (:attr:`BandMesh.wire`).

:func:`run_bands` spawns such a world on one host for the tests and
``chip_smoke.py``; a deployment starts its ranks with ``torchrun`` and calls
:func:`make_band_mesh` in each.  The multi-slice orderings of the JAX module
(``make_multislice_band_mesh``, ``dcn_boundary_bands``) span several hosts
and are not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..runtime.profiling import span

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class BandMesh:
    """This rank's view of the band mesh: its process group, the number of
    bands, its band, its device and the group's backend; and ``received``,
    a host-side count of the bytes its exchanges and reductions received,
    by direction (``"below"``, ``"above"``: the neighbour bands';
    ``"reduce"``: the all_reduce results), taken from the buffers' shapes,
    so counting costs the device nothing."""

    group: object  # torch.distributed ProcessGroup (None: the default group)
    size: int
    rank: int
    device: torch.device
    backend: str
    received: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def count(self, direction: str, buf: torch.Tensor) -> None:
        """Add ``buf``'s bytes to :attr:`received` under ``direction``."""
        self.received[direction] = self.received.get(direction, 0) + buf.nbytes

    @property
    def wire(self) -> torch.device:
        """Where exchanges and collectives take their buffers: the host under
        gloo (its point-to-point takes CPU tensors only), the device under
        NCCL."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the bands, on this rank's device (a
        ``sph.reduce`` span)."""
        with span("sph.reduce"):
            buf = t.to(self.wire)
            dist.all_reduce(buf, group=self.group)
            self.count("reduce", buf)
            return buf.to(self.device)


def make_band_mesh(device="cuda", group=None) -> BandMesh:
    """The band mesh over an initialised process group (the default one unless
    ``group`` is given): band = rank.  ``device`` "cuda" means this rank's
    card, ``cuda:{rank % device_count}``, made the current device; "cpu" runs
    the plain versions.  Ends with a barrier, the group's first collective
    (NCCL needs every rank in its first point-to-point call)."""
    backend = dist.get_backend(group)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the band mesh takes {BACKENDS}")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend moves device buffers: give a cuda device")
    if backend == "nccl":
        dist.barrier(group=group, device_ids=[dev.index])
    else:
        dist.barrier(group=group)
    return BandMesh(group=group, size=size, rank=rank, device=dev, backend=backend)


def _band_main(fn, rank: int, n_bands: int, backend: str, device: str, init: str,
               timeout: float, args: tuple, results) -> None:
    """One spawned rank: join the world, build the mesh, run ``fn(mesh, *args)``
    and report (rank, ok, pickled result or traceback)."""
    # The world lives on one host: keep gloo's and NCCL's sockets on loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init, world_size=n_bands, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        payload = pickle.dumps(fn(make_band_mesh(device), *args))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # Report before leaving the group: a peer that failed may leave it hanging.
    results.put((rank, True, payload))
    dist.destroy_process_group()


def run_bands(fn, n_bands: int, backend: str = "gloo", device: str = "cuda",
              timeout: float = 60.0, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` in a world of ``n_bands`` spawned processes on
    this host, one band each; return the results in band order.

    ``fn`` is a module-level function (it is pickled by name) and its result
    must pickle.  The ranks rendezvous through a file in a fresh temporary
    directory.  Raises RuntimeError, after killing every rank, if a rank
    fails or the world is not done within ``timeout`` seconds; the process
    group's own timeout is the same."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the band mesh takes {BACKENDS}")
    if torch.device(device).type == "cuda":
        from ..ops.cuda import _lib

        _lib.build()  # once here, not by every rank at once
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        procs = [ctx.Process(target=_band_main, daemon=True,
                             args=(fn, rank, n_bands, backend, device, init, timeout,
                                   args, results))
                 for rank in range(n_bands)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done, errors, reported = {}, [], set()

        def take(wait: float) -> None:
            rank, ok, payload = results.get(timeout=wait)
            reported.add(rank)
            if ok:
                done[rank] = pickle.loads(payload)  # written by our own ranks
            else:
                errors.append(f"band {rank} failed:\n{payload}")

        try:
            while len(done) < n_bands and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    errors.append(f"the world missed its deadline of {timeout} s "
                                  f"(bands done: {sorted(done)})")
                    break
                try:
                    take(min(left, 0.5))
                    continue
                except queue.Empty:
                    pass
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                try:  # a rank's report is queued before it exits
                    while dead:
                        take(0.2)
                except queue.Empty:
                    pass
                errors += [f"band {r} exited with code {procs[r].exitcode} and no report"
                           for r in dead if r not in reported]
        finally:
            for p in procs:
                p.join(timeout=max(0.0, deadline - time.monotonic()) if not errors else 1.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if errors:
        raise RuntimeError(f"run_bands({getattr(fn, '__name__', fn)}, {n_bands}, "
                           f"{backend}): " + "\n".join(errors))
    return [done[r] for r in range(n_bands)]
