"""A cell over several cards: one process a band, spawned by the port's own
one-host launcher (``parallel.run_bands``), each running :func:`.cell.run` on
its band.  Each band checks its own rows of the checked frame, with the few
ghost rows of its neighbours that the reference's step reads, and the first
band sums the bands' counts and takes their largest gaps; no band holds the
whole grid."""

from __future__ import annotations

from . import cell


def _band(mesh, c: dict, seed: int, seconds: float, trace_on: bool, control: bool):
    from . import purity

    out = cell.run(c, seed, seconds, trace_on, mesh.device, mesh, control)
    out["forbidden"] = purity.loaded_forbidden()
    return out


def _band_seeds(mesh, c: dict, seeds: list, seconds: float):
    """The control's readings: every seed in one world, the program's numbers
    and the control's of the same checked frame."""
    return [cell.run(c, seed, seconds, False, mesh.device, mesh, True) for seed in seeds]


def control(c: dict, seeds: list, seconds: float, device: str = "cuda", backend=None,
            timeout: float = 3000.0) -> list:
    """The first band's results of :func:`_band_seeds`, seed by seed."""
    from rust_particle_system_tpu_torch.parallel import run_bands

    return run_bands(_band_seeds, int(c["config"]["bands"]), backend or c["traffic"]["backend"],
                     device, timeout, args=(c, seeds, seconds))[0]


def run(c: dict, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
        backend: str | None = None, control: bool = False,
        timeout: float = 330.0) -> list:
    """Every band's result, in band order."""
    from rust_particle_system_tpu_torch.parallel import run_bands

    return run_bands(_band, int(c["config"]["bands"]), backend or c["traffic"]["backend"],
                     device, timeout, args=(c, seed, seconds, trace_on, control))
