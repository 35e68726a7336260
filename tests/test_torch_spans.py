"""The port's spans: one ``sph.frame`` a frame, its phases inside it, on the
profiler's clock while a profile records and free while none does.

The frames run on the CPU through the plain versions; the spans are the
same on the card, where each kernel's row is linked to the span it was
launched under.  This module imports only the port: the band mesh's ranks
import it.
"""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rust_particle_system_tpu_torch.core.params import make_params
from rust_particle_system_tpu_torch.core.state import scatter_init
from rust_particle_system_tpu_torch.ops.cuda import resident as R
from rust_particle_system_tpu_torch.ops.grid import GridSpec
from rust_particle_system_tpu_torch.parallel import (make_plane_sharded_frame,
                                                    make_plane_sharded_step, make_shard_spec,
                                                    run_bands, shard_plane_state)
from rust_particle_system_tpu_torch.render import RenderSpec
from rust_particle_system_tpu_torch.runtime import cli, profiling

BOUNDS = (-54.0, 54.0, -36.0, 36.0)  # 13 x 9 cells of 9
PHASES = ["sph.count", "sph.rebin", "sph.density", "sph.pressure", "sph.force"]
# a frame's phases in order: the live count, then after the walks the ids'
# re-park and the lost count.  The default rebin (variant 6, K1) predicts at
# load and writes the walk planes itself, so no ``sph.predict`` and no
# ``sph.defer``; variant 5 (K9's two passes) predicts in torch before it and
# takes the defer mask in torch under ``sph.defer``, straight after it.
FRAME = ["sph.count", "sph.rebin", "sph.density", "sph.pressure", "sph.force", "sph.count"]
FRAME_V5 = FRAME[:1] + ["sph.predict", "sph.rebin", "sph.defer"] + FRAME[2:]


def _state(n=300, capacity=16, seed=0, spec=None):
    spec = spec or GridSpec.from_bounds(BOUNDS, 9.0, capacity)
    gen = torch.Generator().manual_seed(seed)
    ps = R.plane_state_from_particles(scatter_init(gen, n, BOUNDS), spec)
    return dataclasses.replace(ps, frame=7), spec, make_params(bounds=BOUNDS)


def _spans(prof) -> list:
    """The program's spans in the profile: (name, event), by start time."""
    evs = [e for e in prof.events() if e.name.startswith("sph.")]
    return [(e.name, e) for e in sorted(evs, key=lambda e: e.time_range.start)]


def _phases(spans) -> list:
    """The spans inside the frame in order, repeats of one phase merged."""
    out = []
    for name, _ in spans:
        if name != "sph.frame" and (not out or out[-1] != name):
            out.append(name)
    return out


def _inside(e, name) -> bool:
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_is_the_shared_no_op_without_a_profiler():
    """No profile records: every span is one shared object that does
    nothing, and records nothing even where a profile is on by then."""
    off = profiling.span("sph.frame")
    assert off is profiling.span("sph.count")
    with off as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:
            torch.ones(4).sum()
    assert not _spans(prof)


def test_span_records_under_a_profile():
    """Under a profile, a span is a range named as given, with no
    argument."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rf = profiling.span("sph.frame")
        with rf:
            torch.ones(4).sum()
    assert rf is not profiling.span("sph.frame")
    assert rf.name == "sph.frame" and rf.args is None
    assert [n for n, _ in _spans(prof)] == ["sph.frame"]


@pytest.mark.parametrize("variant, phases", [(6, FRAME), (5, FRAME_V5)])
def test_plane_step_spans(variant, phases):
    """One ``sph.frame`` a frame, with the phases inside it in the frame's
    order, and the walks' and tail's work under no span of the frame's own
    but theirs; variant 5 still opens ``sph.defer``, variant 6 does not."""
    ps, spec, params = _state()
    _, spans = _profiled(lambda: R.plane_step(ps, params, spec, variant=variant))
    frames = [e for n, e in spans if n == "sph.frame"]
    assert len(frames) == 1
    assert _phases(spans) == phases
    assert all(_inside(e, "sph.frame") for _, e in spans)


def test_unfused_tail_adds_its_span():
    ps, spec, params = _state()
    _, spans = _profiled(lambda: R.plane_step(ps, params, spec, fuse_tail=False))
    assert _phases(spans) == FRAME[:-1] + ["sph.tail", "sph.count"]


def test_lossy_variant_has_no_defer_span():
    """Variant 3 (no defer mask) walks every live slot where it is: no
    ``sph.defer``, and the raw walk's torch tail."""
    ps, spec, params = _state()
    _, spans = _profiled(lambda: R.plane_step(ps, params, spec, variant=3))
    assert _phases(spans) == ["sph.count", "sph.predict", "sph.rebin", "sph.density",
                              "sph.pressure", "sph.force", "sph.tail", "sph.count"]


def test_warm_up_frame_is_one_empty_span():
    ps, spec, params = _state()
    ps = dataclasses.replace(ps, frame=0)
    _, spans = _profiled(lambda: R.plane_step(ps, params, spec))
    assert [n for n, _ in spans] == ["sph.frame"]


def test_plane_frame_renders_inside_the_one_frame_span():
    ps, spec, params = _state()
    rs = RenderSpec(width=108, height=72, max_radius_px=2)
    _, spans = _profiled(lambda: R.plane_frame(ps, params, spec, rs, BOUNDS))
    assert [n for n, _ in spans].count("sph.frame") == 1
    assert _phases(spans) == FRAME + ["sph.render"]
    render = next(e for n, e in spans if n == "sph.render")
    assert _inside(render, "sph.frame")
    _, spans = _profiled(lambda: R.render_plane_state(ps, params, spec, rs, BOUNDS))
    assert [n for n, _ in spans] == ["sph.render"]


@pytest.mark.parametrize("fuse_tail", [True, False])
def test_profiled_frame_is_bit_equal(fuse_tail):
    """The spans change nothing the frame computes."""
    ps, spec, params = _state(n=400)
    rs = RenderSpec(width=108, height=72, max_radius_px=2)
    run = lambda: R.plane_frame(ps, params, spec, rs, BOUNDS, fuse_tail=fuse_tail)
    (off, img_off), (on, img_on) = run(), _profiled(run)[0]
    for f in ("px", "py", "vx", "vy", "idsf", "lost"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    assert torch.equal(img_off, img_on)


def _band_spans(mesh, planes, n, frame):
    """One rank: a sharded step and a sharded frame under a profile; the
    names of the spans each recorded, and whether each lies in a frame."""
    ps = R.PlaneState(*planes, frame=frame, lost=torch.zeros((), dtype=torch.int32), n=n)
    spec = make_shard_spec(BOUNDS, 9.0, 16, mesh.size)
    params = make_params(bounds=BOUNDS)
    slab = shard_plane_state(ps, mesh)
    step = make_plane_sharded_step(spec, mesh)
    step_v5 = make_plane_sharded_step(spec, mesh, rebin_variant=5)
    frame_fn = make_plane_sharded_frame(spec, mesh, RenderSpec(width=108, height=72,
                                                               max_radius_px=2), BOUNDS)
    out = {}
    for key, fn in (("step", lambda: step(slab, params)),
                    ("step_v5", lambda: step_v5(slab, params)),
                    ("frame", lambda: frame_fn(slab, params))):
        _, spans = _profiled(fn)
        out[key] = ([n for n, _ in spans], all(_inside(e, "sph.frame") for _, e in spans))
    return out


def test_sharded_step_spans_on_two_gloo_bands():
    """On a 2-band gloo mesh each rank's frame has the single-device phases,
    the halo exchanges as ``sph.halo`` and the all_reduce as ``sph.reduce``,
    all inside its one ``sph.frame``; the sharded frame adds ``sph.render``
    with its all_reduce inside.  K7 writes the walk planes, so only the
    variant-5 step opens ``sph.defer``; K7 predicts its own rows at load,
    so the variant-6 step's ``sph.predict`` is the edge rows' inside
    ``sph.rebin``, before their exchange."""
    spec = make_shard_spec(BOUNDS, 9.0, 16, 2)
    ps, _, _ = _state(n=300, spec=spec)
    planes = [getattr(ps, f) for f in ("px", "py", "vx", "vy", "idsf")]
    outs = run_bands(_band_spans, 2, backend="gloo", device="cpu", timeout=90.0,
                     args=(planes, ps.n, ps.frame))
    for out in outs:
        names, framed = out["step"]
        assert framed and names.count("sph.frame") == 1
        for name in PHASES + ["sph.halo", "sph.reduce"]:
            assert name in names, name
        assert names.index("sph.halo") > names.index("sph.rebin")
        assert names.index("sph.rebin") < names.index("sph.predict") < names.index("sph.halo")
        assert names.count("sph.predict") == 1
        assert names[-1] == "sph.reduce"
        assert "sph.defer" not in names
        names, framed = out["step_v5"]
        assert framed and names.count("sph.frame") == 1
        assert names.index("sph.defer") > names.index("sph.rebin")
        names, framed = out["frame"]
        assert framed and names.count("sph.frame") == 1
        assert names.count("sph.reduce") == 2 and "sph.render" in names
        assert names.index("sph.render") < len(names) - 1 and names[-1] == "sph.reduce"


def test_cli_profile_writes_the_frames_spans(tmp_path, capsys):
    """``--profile DIR`` wraps the run in ``profiling.trace(DIR)``: its
    ``trace.json`` holds one ``sph.frame`` span a frame (5 of warm-up, then
    live frames with their phases)."""
    out = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "--n", "400", "--frames", "7",
                     "--profile", str(out)]) == 0
    assert f"profiler trace -> {out}" in capsys.readouterr().out
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("sph.frame") == 7
    for name in PHASES:
        assert name in names, name
    assert "sph.predict" not in names
