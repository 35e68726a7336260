"""Command-line harness: run any model family, render its final frame, save
and resume checkpoints.

Counterpart of ``rust_particle_system_tpu/runtime/cli.py``:

    python -m rust_particle_system_tpu_torch.runtime.cli --n 50000 --frames 300 \\
        --set gravity=400 --render out.png --stats
    python -m rust_particle_system_tpu_torch.runtime.cli --model nbody --n 16384 \\
        --frames 100 --render nbody.png
    python -m rust_particle_system_tpu_torch.runtime.cli --backend grid --n 50000 \\
        --frames 300 --set gravity=400 --render out.png --stats
    python -m rust_particle_system_tpu_torch.runtime.cli --device cpu --n 2000 \\
        --frames 20 --resume jax_checkpoint.npz --save state.npz

``--resume`` loads a checkpoint written by the JAX package's
``runtime/checkpoint.save`` for the same model family (see ``interop.py``);
``--save`` writes one that it reads back.  ``--render`` writes the final frame
as an sRGB PNG.  ``--profile DIR`` records the run with ``torch.profiler``
(``runtime/profiling.trace``) and writes ``DIR/trace.json``, a Chrome trace
whose ``sph.*`` spans mark each frame and its phases.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from .. import interop
from ..models import MODEL_FAMILIES
from ..models.sph import BACKENDS as SPH_BACKENDS
from ..ops.cuda.resident import PlaneState
from ..render import to_srgb_u8
from ..utils.png import write_png
from .profiling import trace
from .simulation import Simulation

NOT_PORTED = {
    "video": "ROADMAP Queue 1 #2, the interactive tier (the video writer needs PIL or "
             "ffmpeg)",
}


def backend_refusal(name: str, backend: str | None) -> str | None:
    """Why ``--backend`` cannot run for ``--model name``, or None.  The SPH
    fluid takes the JAX package's backends; the N-body runs K8 for ``auto``
    and ``pallas`` alike and has no plain jnp path on the card; the other
    families have one path and ignore ``backend``."""
    if backend is None:
        return None
    if name == "sph" and backend not in SPH_BACKENDS:
        return f"sph backend {backend!r} is not one of {SPH_BACKENDS}"
    if name == "nbody" and backend not in ("auto", "pallas"):
        return (f"nbody backend {backend!r}: the port runs auto|pallas (K8); "
                "it has no plain jnp path on the card")
    return None


def build_model(name: str, n: int, device: str, backend: str | None = None):
    """The model behind ``--model``/``--backend``, as the JAX CLI builds it
    (``backend`` as :func:`backend_refusal` accepts it)."""
    if name == "sph":
        return MODEL_FAMILIES["sph"].create(n=n, device=device, backend=backend or "auto")
    return MODEL_FAMILIES[name].create(device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Particle simulation on PyTorch + CUDA")
    ap.add_argument("--model", choices=sorted(MODEL_FAMILIES), default="sph")
    ap.add_argument("--backend", default=None,
                    help="sph: auto|pallas|grid|oracle; nbody: auto|pallas|jnp")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a param field (repeatable), e.g. gravity=500")
    ap.add_argument("--stats", action="store_true",
                    help="validate invariants and print state statistics at the end")
    ap.add_argument("--resume", default=None,
                    help="load a checkpoint of this model (.npz, JAX layout) first")
    ap.add_argument("--save", default=None,
                    help="write the final checkpoint (.npz, JAX layout) here")
    ap.add_argument("--render", default=None, help="write the final frame (PNG) here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record a torch.profiler trace of the run into DIR/trace.json "
                         "(chrome://tracing or Perfetto open it)")
    for flag in NOT_PORTED:
        ap.add_argument(f"--{flag}", default=None, help="not yet ported")
    args = ap.parse_args(argv)

    for flag, where in NOT_PORTED.items():
        if getattr(args, flag) is not None:
            print(f"--{flag} is not yet ported ({where})", file=sys.stderr)
            return 2

    refusal = backend_refusal(args.model, args.backend)
    if refusal is not None:
        print(f"--backend: {refusal}", file=sys.stderr)
        return 2
    model = build_model(args.model, args.n, args.device, args.backend)
    sim = Simulation(model, n=args.n, seed=args.seed)
    if args.resume:
        state, params = interop.load_npz(args.resume, device=model.device)
        if isinstance(state, PlaneState) != isinstance(sim.state, PlaneState):
            raise SystemExit(f"{args.resume} holds a {type(state).__name__}; the "
                             f"{args.model} model runs a {type(sim.state).__name__}")
        if params is not None and type(params) is not type(sim.params):
            raise SystemExit(f"{args.resume} holds {type(params).__name__}; the "
                             f"{args.model} model takes {type(sim.params).__name__}")
        if isinstance(state, PlaneState):
            grid = model.grid
            if tuple(state.px.shape) != (grid.gh, grid.gw, grid.capacity):
                raise SystemExit(
                    f"checkpoint planes {tuple(state.px.shape)} do not match this "
                    f"model's grid {(grid.gh, grid.gw, grid.capacity)}")
        sim.state, sim.n = state, state.n
        if params is not None:
            sim.params = params
        print(f"resumed from {args.resume} at frame {state.frame}"
              + (" (params restored)" if params is not None else ""))

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = float(v)
    if overrides:
        sim.update_params(**overrides)

    t0 = time.perf_counter()
    with (trace(args.profile) if args.profile else contextlib.nullcontext()):
        sim.run(args.frames)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace -> {args.profile}")
    rate = args.frames * sim.n / max(elapsed, 1e-9)
    print(f"{args.model}: {args.frames} frames x {sim.n} particles on {model.device} in "
          f"{elapsed:.2f}s ({rate:,.0f} particle-steps/s, incl. kernel build)")
    if args.stats:
        print(sim.stats())
    if args.save:
        interop.save_npz(args.save, sim.state, sim.params)
        print(f"checkpoint -> {args.save}")
    if args.render:
        write_png(args.render, to_srgb_u8(sim.render()).cpu().numpy())
        print(f"frame -> {args.render}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
