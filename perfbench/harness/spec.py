"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cells and
metrics; each configuration, traffic mix, limit set, per-layer metric, model,
frame entry and initial state is a file of its own under ``perfbench/``,
found by its name alone, so that a new one is a new file and a new entry, and
no file here changes:

* ``configs/<config>.json``     one deployment: its model, init, layout, sizes;
* ``traffic/<mix>.json``        one traffic mix: its frame entry and loop;
* ``limits/<cell>.json``        the limits of the cell's comparison;
* ``metrics/<metric>.py``       one per-layer metric's reader, ``read(ranks)``;
* ``models/<model>.py``         the model as the harness drives and judges it:
  ``Program(cfg, device, mesh)`` (the port's objects, the initial binning,
  the state's planes, the per-frame tally) and ``Judge(cfg, bands, image)``
  (the comparison with ``reference/<model>.py``);
* ``entries/<model>/<entry>.py`` one frame entry of that model:
  ``build(program) -> frame``, ``frame(state) -> (state, aux)``, and
  ``IMAGE``, whether aux is the frame's image;
* ``inits/<init>.py``           one initial state: ``particles(cfg, seed,
  device) -> (pos, vel)``, drawn from the seed, handed to both sides.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # perfbench/
ROOT = BENCH.parent

_LOADED: dict = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str):
    """The Python file ``path`` as a module (once a process, by its path)."""
    path = Path(path).resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        name = f"perfbench_{kind}_{len(_LOADED)}_{path.stem}"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "configs" / f"{name}.json")


def traffic(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "traffic" / f"{name}.json")


def limits(workload: str, bench: Path = BENCH) -> dict:
    """``{number: limit}`` of the cell's comparison (``limits/<cell>.json``)."""
    return {k: v["limit"] for k, v in load_json(bench / "limits" / f"{workload}.json").items()}


def metric(name: str, bench: Path = BENCH):
    """The reader module ``metrics/<name>.py`` (its ``read(ranks)``)."""
    return load_module(bench / "metrics" / f"{name}.py", "metric")


def model(name: str, bench: Path = BENCH):
    """The model's module ``models/<name>.py`` (its ``Program`` and ``Judge``)."""
    return load_module(bench / "models" / f"{name}.py", "model")


def entry(model_name: str, name: str, bench: Path = BENCH):
    """The frame entry ``entries/<model>/<name>.py`` (its ``build`` and ``IMAGE``)."""
    return load_module(bench / "entries" / model_name / f"{name}.py", "entry")


def init(name: str, bench: Path = BENCH):
    """The initial state ``inits/<name>.py`` (its ``particles``)."""
    return load_module(bench / "inits" / f"{name}.py", "init")


def cell(workload: str, root: Path = ROOT) -> dict:
    """Everything a run of ``workload`` needs: its entry, its configuration
    and traffic, its limits, and the metrics it reports (end-to-end ones with
    ``--trace 0``, per-layer ones with ``--trace 1``)."""
    b = benchmark(root)
    bench = root / "perfbench"
    entry_ = next((w for w in b["workloads"] if w["name"] == workload), None)
    if entry_ is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    reported = lambda m: workload in m.get("workloads", [workload])
    return {
        "workload": workload,
        "chips": int(entry_["chips"]),
        "config": config(entry_["config"], bench),
        "traffic": traffic(entry_["traffic"], bench),
        "limits": limits(workload, bench),
        "end_to_end": [m for m in b["end_to_end"] if reported(m)],
        "per_layer": [m for m in b["per_layer"] if reported(m)],
        "bench": bench,
    }
