#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, at the cell's
own size: for each seed, one short window (the cell's own load), then the
checked frame's numbers for the program and for the control, the reference
computed with its pair terms in bfloat16 (the precision below the
configuration's float32) put in the program's place.  The control has to
come out as not correct.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 1]

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.  The benchmark's runs never run it.
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
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    from harness import cell, check, mesh, spec

    c = spec.cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    if c["config"].get("bands", 1) > 1:
        outs = mesh.control(c, seeds, args.seconds)
    else:
        outs = [cell.run(c, s, args.seconds, False, "cuda", None, True) for s in seeds]
    prog, ctrl = [], []
    for seed, out in zip(seeds, outs):
        ok, _ = check.verdict(out["numbers"], c["limits"])
        cok, _ = check.verdict(out["control_numbers"], c["limits"])
        print(json.dumps({"seed": seed, "program_correct": ok, "program": out["numbers"],
                          "control_correct": cok, "control": out["control_numbers"]}), flush=True)
        prog.append(out["numbers"])
        ctrl.append(out["control_numbers"])
    summary = {k: {"lower": max(p[k] for p in prog), "upper": min(q[k] for q in ctrl)}
               for k in ctrl[0]}
    print(json.dumps({"workload": args.workload, "seeds": len(seeds), "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.path.insert(1, str(ROOT))
    sys.exit(main())
