"""The SPH fluid past 2^24 particles, over the band mesh: ``models/sph.py``'s
program and judge, with what that size asks of each.

``Program`` bins only its band's rows on a mesh (``parallel.band_plane_state``:
every particle still sorted and spilled over the whole grid), so no card holds
the whole grid's planes at once.

``Judge`` steps and bins with ``reference/sph_large.py``: ids past 2^24 as the
port's channel carries them, the walks and their pair census by column
pieces, the rebin by row chunks.  Its census adds ``halo_bytes``: the bytes a
band receives in a frame, counted from the layout and the exchanges of the
port's sharded step (``parallel/halo.py``, K7's rebin); the whole grid's work
takes the most any band receives.
"""

from __future__ import annotations

from pathlib import Path

import torch

from harness import spec
from reference import sph_large as ref_large

base = spec.model("sph", Path(__file__).resolve().parents[1])

FLOAT_BYTES = 4
# Channel rows a band receives a frame from each neighbour band, by the
# exchanges of the sharded step (rebin variant 6): the rebin's ghost rows
# (every channel of the edge row, and from below x/y of the row under it),
# the density walk's (x, y, vx, vy) and the pressure terms' (P1, NPn).
FROM_BELOW = 5 + 2 + 4 + 2
FROM_ABOVE = 5 + 4 + 2
DIAGS = 3  # the diagnostics' int32 all_reduce


class Program(base.Program):
    """``models/sph.py``'s program; on a mesh the initial binning builds
    this band's rows alone."""

    def init(self, particles):
        if self.mesh is None:
            return super().init(particles)
        from rust_particle_system_tpu_torch.core.state import make_state
        from rust_particle_system_tpu_torch.parallel import band_plane_state

        pos, vel = particles
        return band_plane_state(make_state(pos, vel), self.spec, self.mesh)


class Judge(base.Judge):
    """``models/sph.py``'s judge on ``reference/sph_large.py``."""

    def __init__(self, cfg: dict, bench=spec.BENCH, image: bool = False):
        super().__init__(cfg, bench, image)
        lay = base.layout(cfg)
        if lay["rebin_variant"] != 6:
            raise ValueError("the large reference and the halo census follow rebin variant 6")
        self.bands = lay["bands"]
        self.rebin = ref_large.rebin

    def step(self, planes, pair_dtype=torch.float32, band=None) -> dict:
        row0, lo, rows = self._band(band, planes)
        stepped = ref_large.step(planes, self.p, self.g, pair_dtype, self.rebin, self.defer,
                                 row0 - lo)
        own = lambda ts: [t[lo: lo + rows] for t in ts]
        return dict(stepped, planes=own(stepped["planes"]), raw=own(stepped["raw"]))

    def init_numbers(self, prog_planes, particles, row0: int = 0) -> dict:
        pos, vel = particles
        rows = (row0, row0 + prog_planes[0].shape[0])
        ref_planes, lost = ref_large.bin_particles(pos, vel, self.g, rows)
        mismatch = torch.zeros(prog_planes[0].shape, dtype=torch.bool, device=pos.device)
        for a, b in zip(prog_planes, ref_planes):
            mismatch |= base._bits(a.to(pos.device)) != base._bits(b)
        return {"init_mismatch": int(mismatch.sum()), "init_lost": lost}

    def walk_census(self, planes, band=None) -> dict:
        row0, lo, rows = self._band(band, planes)
        npx, npy = self.rebin(ref_large.predict(planes, self.p), self.g, row0 - lo)[:2]
        wx, wy = ref_large.walk_positions(npx, npy, self.g, row0 - lo)
        own = slice(lo, lo + rows)
        walk_live = int(ref_large.live(wx[own]).sum())
        pairs = ref_large.count_pairs(wx, wy, self.p.h, own)
        return {"live": int(ref_large.live(npx[own]).sum()), "walk_live": walk_live,
                "density_pairs": pairs, "force_pairs": pairs - walk_live}

    def halo_bytes(self, band) -> int:
        """The bytes band ``band = (row0, lo, rows)`` receives in a frame of
        the sharded step: its neighbours' channel rows and the diagnostics'
        sum."""
        row0, _, rows = band
        rank = row0 // rows
        channel_rows = (FROM_BELOW if rank > 0 else 0) + (FROM_ABOVE if rank < self.bands - 1
                                                          else 0)
        return channel_rows * self.g.gw * self.g.C * FLOAT_BYTES + DIAGS * 4

    def census(self, samples: list, out, band=None) -> dict:
        counts = super().census(samples, out, band)
        if self.bands > 1:
            counts["halo_bytes"] = self.halo_bytes(self._band(band, out))
        return counts

    def work(self, parts: list) -> dict:
        counts = super().work(parts)
        if "halo_bytes" in parts[0]:
            counts["halo_bytes"] = max(p["halo_bytes"] for p in parts)
        return counts
