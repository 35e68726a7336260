"""The SPH fluid as the harness drives it and judges it.

``Program`` is the system under test: the port's ``SPHFluid`` on the plane
path with the configuration's layout (``capacity``, ``pack2``,
``cell_aspect``, ``rebin_variant``, ``fuse_tail``; on a mesh ``bands``), the
port's initial binning (its only sort), and the calls the frame entries
(``entries/sph/<entry>.py``) make.  The port is imported here and in the
entries alone.

``Judge`` decides ``correct`` by the plain reference (``reference/sph.py``,
``reference/render.py``), which follows the program one frame at a time from
the program's own state: the frame the check reads (drawn from the seed, in
the window's last cycle) is stepped again by the reference from the
program's input to it, and the program's output is held to that.  The start,
which this skips, is checked by itself: the reference bins the run's
particles again and the program's initial planes must equal its planes bit
for bit.  The reference's rebin is the configuration's: the lossless one for
variants 5 and 6 (the port gives the same planes bit for bit), otherwise the
file ``reference/sph_rebin_v<variant>.py`` (``rebin(chans, g, row0)``, ``DEFERS``).

Numbers, each with its limit (``limits/<cell>.json``; the exact ones 0):

* ``init_mismatch``  slots of the initial planes that differ in any channel;
* ``init_lost``      particles the initial binning lost (the configuration's
  guarantee: none);
* ``slot_mismatch``  slots of the checked frame's output whose particle (id)
  or liveness differs from the reference's: the rebin, the migration between
  bands and the defer mask are exact;
* ``nonfinite``      live slots with a channel that is not finite;
* ``lost``           particles lost over the whole run, and ``live_error``,
  the live count's distance from n, at the end of the run;
* ``pos_err``        the largest gap of a live particle's position (units);
* ``vel_err``        the largest gap of a live particle's velocity (units/s).
  The bounce is discontinuous at a wall: a particle whose position before the
  clamp lies within ``wall_eps`` of a wall may take either side's velocity,
  and is held to the nearer;
* ``image_err``      the largest gap of the image's channels from the
  reference's image of the program's output planes (cells whose entry draws).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness import spec, work
from reference import render as ref_render
from reference import sph as ref

LOSSLESS = (5, 6)  # rebin variants that defer and lose nothing, bit-identical planes


def layout(cfg: dict) -> dict:
    """The configuration's layout keys, with the port's defaults."""
    return {"capacity": int(cfg["capacity"]), "pack2": bool(cfg.get("pack2", False)),
            "cell_aspect": int(cfg.get("cell_aspect", 1)),
            "rebin_variant": int(cfg.get("rebin_variant", 6)),
            "fuse_tail": bool(cfg.get("fuse_tail", True)), "bands": int(cfg.get("bands", 1))}


def make_params(cfg: dict):
    from rust_particle_system_tpu_torch.core.params import make_params as mk

    ph = cfg["physics"]
    return mk(particle_size=ph["particle_size"], smoothing_radius=ph["smoothing_radius"],
              max_energy=ph["max_energy"], damping_factor=ph["damping_factor"], dt=ph["dt"],
              gravity=ph["gravity"], target_density=ph["target_density"],
              pressure_multiplier=ph["pressure_multiplier"],
              viscosity_strength=ph["viscosity_strength"],
              near_density_multiplier=ph["near_density_multiplier"],
              bounds=tuple(float(b) for b in cfg["bounds"]), shader_delay=ph["shader_delay"])


class Program:
    """One configuration on one device, or on one band of ``mesh``."""

    def __init__(self, cfg: dict, device: torch.device, mesh=None):
        from rust_particle_system_tpu_torch.models.sph import SPHFluid
        from rust_particle_system_tpu_torch.ops.grid import GridSpec
        from rust_particle_system_tpu_torch.render import RenderSpec

        lay = layout(cfg)
        self.cfg, self.device, self.mesh = cfg, device, mesh
        self.rebin_variant, self.fuse_tail = lay["rebin_variant"], lay["fuse_tail"]
        self.params = make_params(cfg)
        bounds = tuple(float(b) for b in cfg["bounds"])
        cell = float(cfg["cell_size"])
        r = cfg.get("render", {})
        model = SPHFluid.create(
            n=int(cfg["n"]), bounds=bounds, cell_size=cell, capacity=lay["capacity"],
            pack2=lay["pack2"], device=device, backend="pallas",
            render_spec=RenderSpec(width=r.get("width", 1920), height=r.get("height", 1080),
                                   max_radius_px=r.get("max_radius_px", 4)))
        grid = GridSpec.from_bounds(bounds, cell, lay["capacity"], cell_aspect=lay["cell_aspect"],
                                    pack2=lay["pack2"])
        self.model = dataclasses.replace(model, grid=grid)
        self.spec = grid
        if mesh is not None:
            from rust_particle_system_tpu_torch.parallel import make_shard_spec

            if lay["cell_aspect"] != 1:
                raise ValueError("the port's band mesh takes cells as wide as they are high")
            self.spec = make_shard_spec(bounds, cell, lay["capacity"], mesh.size,
                                        pack2=lay["pack2"])
        # SPHFluid's own calls run rebin variant 6 with the fused tail; another
        # layout goes through the plane functions they call, with its keys.
        self._own = (self.rebin_variant, self.fuse_tail) == (6, True)

    def init(self, particles):
        """The port's initial binning (its only sort), then this band's slab."""
        from rust_particle_system_tpu_torch.core.state import make_state
        from rust_particle_system_tpu_torch.ops.cuda.resident import plane_state_from_particles

        pos, vel = particles
        ps = plane_state_from_particles(make_state(pos, vel), self.spec)
        if self.mesh is not None:
            from rust_particle_system_tpu_torch.parallel import shard_plane_state

            ps = shard_plane_state(ps, self.mesh)
        return ps

    def step(self, ps):
        if self._own:
            return self.model.step(ps, self.params)
        from rust_particle_system_tpu_torch.ops.cuda.resident import plane_step

        return plane_step(ps, self.params, self.model.grid, self.fuse_tail, self.rebin_variant)

    def step_and_render(self, ps):
        if self._own:
            return self.model.step_and_render(ps, self.params)
        from rust_particle_system_tpu_torch.ops.cuda.resident import plane_frame

        return plane_frame(ps, self.params, self.model.grid, self.model.render_spec,
                           bounds_static=self.model.bounds, fuse_tail=self.fuse_tail,
                           variant=self.rebin_variant)

    @staticmethod
    def planes(ps) -> list:
        return [ps.px, ps.py, ps.vx, ps.vy, ps.idsf]

    def tally(self, ps, aux):
        """What each timed frame keeps on the card: the mesh's diagnostics
        (live before, live after, deferred; summed over the bands) or the
        state's count of lost particles."""
        return aux if self.mesh is not None else ps.lost

    def failed(self, tallies: torch.Tensor) -> tuple:
        """(frames that lost a particle, the most lost by any frame)."""
        n = int(self.cfg["n"])
        if self.mesh is not None:
            bad = (tallies[:, 1] != n) | (tallies[:, 0] != n)
            return int(bad.sum()), int((n - tallies[:, 1]).clamp_min(0).max())
        return int((tallies != 0).sum()), int(tallies.max())


def _bits(t):
    return t.contiguous().view(torch.int32)


def wall_eps(bounds) -> float:
    """Four float32 spacings at the largest coordinate of the domain: the
    gap within which rounding may put a particle on either side of a wall."""
    return 4.0 * float(np.spacing(np.float32(max(abs(float(b)) for b in bounds))))


def _vel_gap(v, x_raw, v_raw, lo: float, hi: float, damp: float, eps: float):
    """|v - reference| per slot; near a wall the nearer of the bounced and the
    unbounced reference velocity."""
    at_lo, at_hi = (x_raw - lo).abs() <= eps, (x_raw - hi).abs() <= eps
    bounced_lo, bounced_hi = v_raw.abs() * damp, -v_raw.abs() * damp
    v_ref = torch.where(x_raw <= lo, bounced_lo, v_raw)
    v_ref = torch.where(x_raw >= hi, -v_ref.abs() * damp, v_ref)
    gap = (v - v_ref).abs()
    gap = torch.where(at_lo | at_hi, torch.minimum(gap, (v - v_raw).abs()), gap)
    gap = torch.where(at_lo, torch.minimum(gap, (v - bounced_lo).abs()), gap)
    return torch.where(at_hi, torch.minimum(gap, (v - bounced_hi).abs()), gap)


class Judge:
    """The reference's side of a run: the same grid, parameters, rebin and
    image geometry, worked out from the configuration alone.

    On one device the judge sees the whole grid.  On a band mesh each band
    judges its own rows, ``band = (row0, lo, rows)``: its own rows are the
    grid's ``row0 .. row0 + rows - 1``, and the input of the checked frame
    (and of each work sample) is handed with ``lo`` ghost rows below them and
    the ghost rows above them that the band above sent (``GHOSTS``; none past
    the mesh's edges, where the reference's fills stand in as on the whole
    grid).  :meth:`combine` and :meth:`work` make the whole grid's numbers of
    the bands' parts."""

    GHOSTS = (4, 3)  # input rows below and above its own that one band's step reads
    LARGEST = ("pos_err", "vel_err", "image_err")  # the other numbers are counts, summed

    def __init__(self, cfg: dict, bench=spec.BENCH, image: bool = False):
        lay = layout(cfg)
        self.n = int(cfg["n"])
        self.g = ref.Grid.of(cfg["bounds"], float(cfg["cell_size"]), lay["capacity"],
                             lay["bands"], lay["cell_aspect"])
        self.p = ref.Params.of(cfg["physics"], cfg["bounds"])
        v = lay["rebin_variant"]
        if v in LOSSLESS:
            self.rebin, self.defer = ref.rebin, True
        else:
            mod = spec.load_module(bench / "reference" / f"sph_rebin_v{v}.py", "reference rebin")
            self.rebin, self.defer = mod.rebin, bool(mod.DEFERS)
        self.geo = None
        if image:
            if lay["bands"] > 1:
                raise ValueError("the band mesh's entries draw no image")
            r = cfg["render"]
            self.geo = ref_render.geometry(cfg["bounds"], self.g, r["width"], r["height"],
                                           r["max_radius_px"], self.p.particle_size)

    def _band(self, band, planes) -> tuple:
        """(row0, lo, rows) of ``band``; the whole grid where it is None."""
        return band if band is not None else (0, 0, planes[0].shape[0])

    def step(self, planes, pair_dtype=torch.float32, band=None) -> dict:
        """The reference's step of ``planes``; on a band, of its own rows:
        the planes and tail values of those rows alone."""
        row0, lo, rows = self._band(band, planes)
        stepped = ref.step(planes, self.p, self.g, pair_dtype, self.rebin, self.defer, row0 - lo)
        own = lambda ts: [t[lo: lo + rows] for t in ts]
        return dict(stepped, planes=own(stepped["planes"]), raw=own(stepped["raw"]))

    def init_numbers(self, prog_planes, particles, row0: int = 0) -> dict:
        """The program's initial planes (grid rows from ``row0`` on) against
        the reference's binning of the same rows; the loss of the particles
        whose cell lies in them."""
        pos, vel = particles
        rows = (row0, row0 + prog_planes[0].shape[0])
        ref_planes, lost = ref.bin_particles(pos, vel, self.g, rows)
        mismatch = torch.zeros(prog_planes[0].shape, dtype=torch.bool, device=pos.device)
        for a, b in zip(prog_planes, ref_planes):
            mismatch |= _bits(a.to(pos.device)) != _bits(b)
        return {"init_mismatch": int(mismatch.sum()), "init_lost": lost}

    def step_numbers(self, prog_out, stepped: dict) -> dict:
        """The checked frame's numbers: the program's output planes against
        the reference's step of the same input."""
        p = self.p
        rpx, rpy, rvx, rvy, rid = stepped["planes"]
        x_raw, y_raw, vx_raw, vy_raw = stepped["raw"]
        px, py, vx, vy, idsf = (t.to(rpx.device) for t in prog_out)
        alive = ref.live(rpx)
        slot = (ref.live(px) != alive) | (alive & (_bits(idsf) != _bits(rid)))
        both = alive & ref.live(px)
        finite = torch.isfinite(px) & torch.isfinite(py) & torch.isfinite(vx) & torch.isfinite(vy)
        eps = wall_eps(p.bounds)
        x_min, x_max, y_min, y_max = p.bounds
        gx = _vel_gap(vx, x_raw, vx_raw, x_min, x_max, p.damping, eps)
        gy = _vel_gap(vy, y_raw, vy_raw, y_min, y_max, p.damping, eps)
        worst = lambda t: float(torch.where(both, t, 0.0).max()) if bool(both.any()) else 0.0
        pos = torch.maximum((px - rpx).abs(), (py - rpy).abs())
        vel = torch.maximum(gx, gy)
        return {"slot_mismatch": int(slot.sum()),
                "nonfinite": int((ref.live(px) & ~finite).sum()),
                "pos_err": worst(torch.nan_to_num(pos, nan=np.inf)),
                "vel_err": worst(torch.nan_to_num(vel, nan=np.inf))}

    def image_numbers(self, prog_out, prog_image) -> dict:
        px, py, vx, vy = (t.to(prog_image.device) for t in prog_out[:4])
        img = ref_render.image(px, py, vx, vy, self.geo, self.p)
        gap = torch.nan_to_num((prog_image - img).abs(), nan=np.inf)
        return {"image_err": float(gap.max())}

    def frame_numbers(self, out_planes, image, stepped: dict) -> dict:
        numbers = self.step_numbers(out_planes, stepped)
        if self.geo is not None:
            numbers.update(self.image_numbers(out_planes, image))
        return numbers

    def numbers(self, particles, init, planes_in, out, image, lost: int, band=None) -> dict:
        """Every compared number of a run, or on a band mesh this band's part
        of them (with its ``live`` count, see :meth:`combine`)."""
        numbers = self.init_numbers(init, particles, self._band(band, out)[0])
        numbers.update(self.frame_numbers(out, image, self.step(planes_in, band=band)))
        numbers.update({"lost": lost, "live": int(ref.live(out[0]).sum())})
        return numbers

    def combine(self, parts: list) -> dict:
        """The whole grid's numbers from the bands' parts, in band order:
        the gaps the largest, ``lost`` the first band's, the other counts
        summed; ``live`` becomes ``live_error``, the summed live count's
        distance from n."""
        out = {}
        for k in parts[0]:
            vals = [p[k] for p in parts]
            if k == "lost":  # every band counts the whole mesh's
                out[k] = vals[0]
            else:
                out[k] = max(vals) if k in self.LARGEST else sum(vals)
        if "live" in out:
            out["live_error"] = abs(out.pop("live") - self.n)
        return out

    def control(self, planes_in, band=None) -> dict:
        """The control's numbers (this band's part): the reference in the
        precision below float32 (its pair terms in bfloat16) in the program's
        place, held to the reference in float32."""
        stepped = self.step(planes_in, band=band)
        low = self.step(planes_in, torch.bfloat16, band)["planes"]
        image = None
        if self.geo is not None:
            image = ref_render.image(*low[:4], self.geo, self.p, torch.bfloat16)
        return self.frame_numbers(low, image, stepped)

    def census(self, samples: list, out, band=None) -> dict:
        """This band's counts of the physics' own work (the rooflines'
        yardstick): each sampled frame's walks, and the image of the checked
        frame's output where the entry draws."""
        counts = {"walks": [self.walk_census(s, band) for s in samples]}
        if self.geo is not None:
            counts["image"] = work.image_census(out, self.geo)
        return counts

    def work(self, parts: list) -> dict:
        """The whole grid's work a frame from the bands' :meth:`census`: each
        sample's counts summed over the bands, then the mean over samples."""
        walks = [{k: sum(w[k] for w in frame) for k in frame[0]}
                 for frame in zip(*(p["walks"] for p in parts))]
        counts = work.mean_census(walks)
        counts.update(parts[0].get("image", {}))
        return counts

    def walk_census(self, planes, band=None) -> dict:
        """The walks' work in the frame from ``planes`` (of this band's own
        rows): live particles, the walk-live ones (not deferred), and the
        pairs the density walk (each slot with itself included) and the
        force walk (without) need."""
        row0, lo, rows = self._band(band, planes)
        npx, npy = self.rebin(ref.predict(planes, self.p), self.g, row0 - lo)[:2]
        wx, wy = ref.walk_positions(npx, npy, self.g, row0 - lo) if self.defer else (npx, npy)
        own = slice(lo, lo + rows)
        walk_live = int(ref.live(wx[own]).sum())
        pairs = work.count_pairs(wx, wy, self.p.h, own)
        return {"live": int(ref.live(npx[own]).sum()), "walk_live": walk_live,
                "density_pairs": pairs, "force_pairs": pairs - walk_live}
