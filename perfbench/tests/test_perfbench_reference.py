"""The plain reference against the port's own plain path on the CPU, at a few
thousand particles: the same binning bit for bit, the same frame, the same
image."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest
import torch

from conftest import MINI_BOUNDS, MINI_N
from harness import spec
from reference import render as ref_render
from reference import sph as ref

SPH = spec.model("sph")
UNIFORM = spec.init("uniform")

PHYSICS = {"particle_size": 3.0, "smoothing_radius": 9.0, "gravity": 300.0, "dt": 0.01,
           "target_density": 0.011, "pressure_multiplier": 10000.0,
           "near_density_multiplier": 1000.0, "viscosity_strength": 5.0,
           "damping_factor": 0.1, "max_energy": 2000.0, "shader_delay": 0}
CFG = {"model": "sph", "init": "uniform", "n": MINI_N, "bounds": MINI_BOUNDS, "cell_size": 9.0,
       "capacity": 128, "physics": PHYSICS,
       "render": {"width": 192, "height": 108, "max_radius_px": 4}}
# Layouts the configuration may state, each with the port's rebin and walks.
LAYOUTS = {"classic": {}, "pack2": {"capacity": 64, "pack2": True},
           "aspect2": {"cell_aspect": 2}, "variant5": {"rebin_variant": 5},
           "unfused": {"fuse_tail": False}}


def _port(cfg=CFG):
    return SPH.Program(cfg, torch.device("cpu"))


def _moving(cfg, seed):
    """The uniform particles with velocities of up to 50 units/s."""
    pos, _ = UNIFORM.particles(cfg, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    return pos, 100.0 * torch.rand(pos.shape, generator=gen) - 50.0


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_binning_matches_the_port_bit_for_bit(seed):
    particles = _moving(CFG, seed)
    ps = _port().init(particles)
    planes, lost = ref.bin_particles(*particles, ref.Grid.of(MINI_BOUNDS, 9.0, 128))
    assert lost == int(ps.lost) == 0
    for a, b in zip(SPH.Program.planes(ps), planes):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert SPH.Judge(CFG).init_numbers(SPH.Program.planes(ps), particles) == {
        "init_mismatch": 0, "init_lost": 0}


def test_binning_spills_overflow_as_the_port_does():
    """A crowded cell: more than C particles in one cell go to neighbours."""
    cfg = dict(CFG, capacity=8)
    pos, vel = UNIFORM.particles(cfg, 3, "cpu")
    pos = pos * 0.05  # ~3,000 particles in a few cells
    ps = _port(cfg).init((pos, vel))
    planes, lost = ref.bin_particles(pos, vel, ref.Grid.of(MINI_BOUNDS, 9.0, 8))
    assert lost == int(ps.lost) > 0
    for a, b in zip(SPH.Program.planes(ps), planes):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("frames", [1, 6])
def test_a_frame_matches_the_port(frames):
    port = _port()
    ps = port.init(UNIFORM.particles(CFG, 11, "cpu"))
    for _ in range(frames - 1):
        ps, _ = port.step_and_render(ps)
    out, image = port.step_and_render(ps)
    g = ref.Grid.of(MINI_BOUNDS, 9.0, 128)
    p = ref.Params.of(PHYSICS, MINI_BOUNDS)
    stepped = ref.step(SPH.Program.planes(ps), p, g)
    got, want = SPH.Program.planes(out), stepped["planes"]
    assert torch.equal(got[4], want[4])  # every particle in the same slot
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    geo = ref_render.geometry(MINI_BOUNDS, g, 192, 108, 4, 3.0)
    torch.testing.assert_close(image, ref_render.image(*got[:4], geo, p), rtol=0, atol=1e-6)
    assert stepped["density_pairs"] > stepped["walk_live"] > 0


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_each_layout_is_passed_to_the_port_and_the_judge(name):
    """The configuration's layout keys reach the port's grid and step, and
    the judge's reference follows them: moving particles, three frames, every
    number at its exact value or within the 16M cells' limits."""
    cfg = dict(CFG, **LAYOUTS[name])
    port, judge = _port(cfg), SPH.Judge(cfg)
    g = port.model.grid
    assert (g.capacity, g.pack2, g.cell_width) == (judge.g.C, cfg.get("pack2", False), judge.g.cw)
    assert (port.rebin_variant, port.fuse_tail) == (cfg.get("rebin_variant", 6),
                                                   cfg.get("fuse_tail", True))
    ps = port.init(_moving(cfg, 5))
    for _ in range(3):
        ps_in, ps = ps, port.step(ps)
    numbers = judge.frame_numbers(SPH.Program.planes(ps), None,
                                  judge.step(SPH.Program.planes(ps_in)))
    assert numbers["slot_mismatch"] == numbers["nonfinite"] == 0, numbers
    assert numbers["pos_err"] <= 1e-3 and numbers["vel_err"] <= 5e-3, numbers


def test_the_reference_imports_nothing_of_the_port():
    from harness import purity

    for f in Path(ref.__file__).parent.glob("*.py"):
        assert purity.PORT not in purity.imports_of(f), f
        assert not purity.imports_of(f) & purity.FORBIDDEN, f


def test_params_follow_the_port():
    want = SPH.make_params(CFG)
    got = ref.Params.of(PHYSICS, MINI_BOUNDS)
    assert (got.dnorm, got.nnorm, got.vnorm) == (
        want.density_kernel_norm, want.near_density_kernel_norm, want.viscosity_kernel_norm)
    assert dataclasses.astuple(got)[:3] == (want.smoothing_radius, want.particle_size, want.dt)
