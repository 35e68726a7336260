"""The rooflines' yardstick on hand-built states: the physics' own pair and
pixel counts, the bound, and each reader's arithmetic; a reader whose kernel
rows are missing reads None, never 0."""

from __future__ import annotations

import math

import pytest
import torch

from harness import spec, trace, work
from reference import sph as ref

H = 9.0


def _planes(points, gw=3, gh=3, C=4):
    """Walk-position planes holding ``points`` ((x, y) in a grid of 9-unit
    cells from the origin), slots in order, the rest parked."""
    px = torch.full((gh, gw, C), ref.SENTINEL)
    py = torch.full((gh, gw, C), ref.SENTINEL)
    fill = {}
    for x, y in points:
        r, c = int(y // H), int(x // H)
        s = fill.get((r, c), 0)
        px[r, c, s], py[r, c, s] = x, y
        fill[(r, c)] = s + 1
    return px, py


def test_pairs_within_the_radius_are_counted_across_cells():
    # a and b 5 apart (two cells), c 8.9 from b (another row), d 12 from all
    pts = [(8.0, 4.0), (13.0, 4.0), (13.0, 12.9), (26.0, 26.0)]
    px, py = _planes(pts)
    # ordered pairs: a-b, b-a, b-c, c-b, and each of the four with itself
    assert work.count_pairs(px, py, H) == 4 + 4


def test_parked_slots_do_not_count():
    px, py = _planes([(1.0, 1.0), (2.0, 1.0)])
    px[0, 0, 1] = ref.SENTINEL  # the second one deferred
    assert work.count_pairs(px, py, H) == 1


def test_sprite_pixels():
    # a centre on a pixel centre: radius 1 reaches only that pixel (d < r);
    # radius 1.5 its four edge neighbours too, and not the corners (1.414...)
    c = torch.tensor([5.5])
    assert work.sprite_pixels(c, c, 1.0, 20, 20) == 1
    assert work.sprite_pixels(c, c, 1.5, 20, 20) == 9
    # a sprite at the image's corner keeps only the pixels inside the image
    z = torch.tensor([0.0])
    assert work.sprite_pixels(z, z, 1.0, 20, 20) == 1


def test_bound_takes_the_larger_time():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def _reading(rows, frames=10, window_s=0.01, work_counts=None):
    return trace.Reading(ops=rows, frames=frames, window_s=window_s, enqueue_ms=0.5,
                         work=work_counts)


W = {"live": 1e6, "walk_live": 1e6, "density_pairs": 1.2e8, "force_pairs": 1.19e8,
     "sprite_pixels": 2.8e7, "sprites": 1e6, "pixels": 1920 * 1080}


def test_roofline_readers():
    # 10 frames; each kernel row 1 ms a frame
    names = {"rebin_roofline": "(anonymous namespace)::rebin_tile(Src)",
             "density_roofline": "void strip_walk<(anonymous namespace)::DensityWalk>(int)",
             "force_roofline": "void strip_walk<(anonymous namespace)::ForceWalk<true> >(int)",
             "render_roofline": "void (anonymous namespace)::render_kernel<3, 0>(Planes)"}
    for metric, name in names.items():
        rows = [(name, 1000.0 * i, 1000.0 * i + 1000.0) for i in range(10)]
        got = spec.metric(metric).read([_reading(rows, work_counts=W)])
        mod = spec.metric(metric)
        if metric == "rebin_roofline":
            want = 100 * max(10e6 / 67e12, 40e6 / 3.35e12) / 1e-3
        elif metric == "density_roofline":
            want = 100 * max(11 * 1.2e8 / 67e12, 16e6 / 3.35e12) / 1e-3
        elif metric == "force_roofline":
            want = 100 * max((27 * 1.19e8 + 28e6) / 67e12, 52e6 / 3.35e12) / 1e-3
        else:
            want = 100 * max((21 * 2.8e7 + 16e6) / 67e12,
                             (16e6 + 16 * 1920 * 1080) / 3.35e12) / 1e-3
        assert got == pytest.approx(want), metric
        assert mod.read([_reading([("void other_kernel(int)", 0.0, 1.0)], work_counts=W)]) is None


def test_frame_mfu_counts_every_part():
    rows = [("k", 0.0, 1.0)]
    got = spec.metric("frame_mfu").read([_reading(rows, frames=10, window_s=0.02, work_counts=W)])
    ops = 10e6 + 11 * 1.2e8 + 27 * 1.19e8 + 28e6 + 21 * 2.8e7 + 16e6
    assert got == pytest.approx(100 * ops / (2e-3 * 67e12))
    assert spec.metric("frame_mfu").read([_reading([], work_counts=W)]) is None


def test_device_readers():
    rows = [("k1", 0.0, 2000.0), ("Memset (Device)", 2000.0, 2500.0),
            ("ncclDevKernel_SendRecv(x)", 3000.0, 4000.0), ("k1", 3500.0, 6000.0)]
    r = _reading(rows, frames=2, window_s=0.01)
    assert r.busy_s() == pytest.approx(5.5e-3)  # overlapping rows count once
    assert spec.metric("device_idle_share").read([r]) == pytest.approx(45.0)
    assert spec.metric("launches_per_frame").read([r]) == 1.5
    assert spec.metric("halo_ms").read([r]) == pytest.approx(0.5)
    assert spec.metric("glue_ms").read([r]) == pytest.approx((2.0 + 0.5 + 2.5) / 2)
    assert spec.metric("host_enqueue_ms").read([r, _reading(rows)]) == 0.5
    empty = _reading([], frames=2)
    for name in ("device_idle_share", "launches_per_frame", "halo_ms", "glue_ms"):
        assert spec.metric(name).read([empty]) is None, name


def test_census_of_a_frame_at_rest():
    """With no gravity and particles at rest, nothing moves or defers: the
    walk-live particles are the live ones and the pairs are the plain
    count of the initial positions."""
    from reference.sph import bin_particles

    pts = torch.tensor([[8.0, 4.0], [13.0, 4.0], [13.0, 12.9], [22.0, 22.0]])
    phys = {"particle_size": 3.0, "smoothing_radius": H, "gravity": 0.0, "dt": 0.01,
            "target_density": 0.011, "pressure_multiplier": 1e4,
            "near_density_multiplier": 1e3, "viscosity_strength": 5.0, "damping_factor": 0.1,
            "max_energy": 2000.0}
    judge = spec.model("sph").Judge({"n": 4, "bounds": [0.0, 26.0, 0.0, 26.0], "cell_size": H,
                                     "capacity": 4, "physics": phys})
    planes, lost = bin_particles(pts, torch.zeros_like(pts), judge.g)
    got = judge.walk_census(planes)
    assert got == {"live": 4, "walk_live": 4, "density_pairs": 8, "force_pairs": 4}
    assert math.isclose(work.mean_census([got, got])["density_pairs"], 8)
