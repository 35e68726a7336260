#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port on NVIDIA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``rust_particle_system_tpu_torch``), on a machine with as many CUDA cards as
the cell asks for.  ``BENCHMARK.json`` names the cells; each cell's
configuration, traffic mix, limits and per-layer metrics are files under
``perfbench/`` found by name, and so are the model the configuration names
(``models/<model>.py``), its initial state (``inits/<init>.py``) and the
frame entry the traffic names (``entries/<model>/<entry>.py``).  The run
builds the cell's state on the card from the seed, warms up, measures for
about ``--seconds`` (or, with ``--trace 1``, profiles one cycle of frames),
checks the frames against the plain reference in ``perfbench/reference/``,
prints each compared number beside its limit on standard error and, last on
standard output, one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` when traced) and ``checks``.

Exit codes: 2 without the cards the cell needs; 3 if a module of JAX or of the
JAX package was loaded; 1 on any other failure; no result line in each case.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import purity, result, spec

    started = result.process_start()
    import torch

    torch.set_num_threads(2)
    chips = spec.cell(args.workload, ROOT)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell {args.workload} needs {chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    line = result.measure(args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda", ROOT, started=started)
    for note in line.pop("_notes"):
        print(note, file=sys.stderr)
    forbidden = sorted(set(line.pop("_forbidden")) | set(purity.loaded_forbidden()))
    if forbidden:
        print("modules of JAX or of the JAX package were loaded: " + ", ".join(forbidden),
              file=sys.stderr)
        return 3
    for name, (value, limit) in line["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(1, str(ROOT))
    sys.exit(main())
