"""The band-sharded plane-resident step and rendered frame.

Counterpart of ``rust_particle_system_tpu/parallel/plane_sharded.py`` (rebin
variants 6 and 5).  Each rank owns ``R = gh / n_bands`` rows of cell slots of
the ``[gh, gw, C]`` planes (:func:`.shard.shard_plane_state`) and runs the
single-device frame's phases on them (``resident._physics`` on the band's
``Slab``, which brings the band's rebin and the walks' ghost rows) with the
same kernels: migration between bands IS the lossless rebin, which adopts a
mover from the neighbour band's edge row like any local one (variant 6: K7,
K1 on the band's slab with ghost rows; variant 5: K9's pass Y with ghost
rows, the adoption returned to the owner band, then pass X, band-local), and
the walks (K2/K3/K3b, or K6) read the neighbour bands' edge rows as ghost rows.

Per frame, on every rank (JAX ``ppermute`` -> point-to-point, ``psum`` ->
``all_reduce``):

1. gravity + predict: variant 6 the band's edge rows    (elementwise)
   (K7 predicts its own rows at load); variant 5 all
2. rebin ghost rows, K7                                 one exchange (two at R=1)
   or variant 5: ghost rows, K9 pass Y                  one exchange
                 adoption return, merge, K9 pass X      one exchange
3. defer mask in global rows (variant 6: written by K7 with its planes)
4. the walk planes' ghost rows, density walk            one exchange
5. the pressure terms' ghost rows, force walk + tail    one exchange
6. diagnostics                                          one int32 all_reduce

The phases run under the spans of ``plane_step`` (``sph.frame``, ``sph.count``,
``sph.predict``, ``sph.rebin``, ...); each exchange is a ``sph.halo`` span and
each all_reduce a ``sph.reduce`` span inside them.

On one card the 4-band step equals :func:`~..ops.cuda.resident.plane_step` on
the same grid bit for bit: K7 is bit-equal to K1's rows (and the variant-5
passes to K1's output), the walks stage each
cell's live neighbours in an order that depends only on the cells, and the
elementwise glue runs the same operations.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.cuda.rebin import (SENTINEL, hole_fill_pass, predict_channels, rebin_planes_walk,
                              retention_merge)
from ..ops.cuda.resident import FILLS, PlaneState, Slab, _physics
from ..render.splat import splat_resolve
from ..render.splat_planes import MARGIN, accumulators, raster_planes, render_geometry
from ..runtime.profiling import span
from .halo import edge_rows, exchange_halo, halo_rows, rebin_halo
from .mesh import BandMesh

DIAGS = ("live_before", "live_after", "deferred")


def _rebin_v5_band(chans, spec, row0: int, mesh: BandMesh) -> list:
    """The lossless two-pass rebin on this rank's slab (JAX
    plane_sharded.py:133-202): K9's pass Y with the neighbour bands' edge rows
    as ghost rows, the adoption of their slots returned to them, the retention
    merge with the adoption of ours, then K9's pass X (band-local: its lanes
    never leave a row) and its merge."""
    R, gw, C = chans[0].shape
    flats = [c.reshape(R * gw, C) for c in chans]
    lo, hi = edge_rows(chans, FILLS, mesh)
    mid, _, adopted = hole_fill_pass(flats, spec, FILLS, gw, True, True,
                                     list(zip(lo, hi)), row0)
    # Group 0 of row 0 adopted the band below's top row; group 1 of row R-1
    # the band above's bottom row.  Each goes back to its owner.
    took_lo, took_hi = exchange_halo(adopted[(R - 1) * gw:, C:].to(torch.uint8),
                                     adopted[:gw, :C].to(torch.uint8), mesh)
    extra = torch.zeros((R * gw, C), dtype=torch.bool, device=mid[0].device)
    if took_lo is not None:
        extra[:gw] |= took_lo.bool()
    if took_hi is not None:
        extra[(R - 1) * gw:] |= took_hi.bool()
    mid = retention_merge(flats, mid, adopted, spec, gw, True, row0, extra)
    out, _, adopted = hole_fill_pass(mid, spec, FILLS, 1, False, True, None, row0)
    out = retention_merge(mid, out, adopted, spec, 1, False, row0)
    return [o.reshape(R, gw, C) for o in out]


def _edge_rows(planes) -> list:
    """Each ``[R, gw, C]`` plane's rows that its neighbour bands read as
    ghost rows (``rebin_halo``'s rows: 0, R-2 and R-1), in that order, as a
    band of at most three rows."""
    R = planes[0].shape[0]
    return [torch.cat([p[:1], p[R - 2:]]) for p in planes] if R > 3 else list(planes)


def check_plane_diags(diags: torch.Tensor, expect_particles: int | None = None) -> dict:
    """Raise on conservation violations (there must be none: the rebin is
    lossless by construction); return host ints by name.  ``deferred`` is
    informational: persistently large values mean the grid capacity is
    undersized for the density the flow reaches."""
    vals = dict(zip(DIAGS, diags.tolist()))
    if vals["live_after"] != vals["live_before"]:
        raise ValueError(
            f"plane-sharded step lost particles: {vals['live_before']} -> "
            f"{vals['live_after']}: lossless-rebin invariant violated (bug)")
    if expect_particles is not None and vals["live_after"] != expect_particles:
        raise ValueError(f"particle count {vals['live_after']} != expected "
                         f"{expect_particles}")
    return vals


def make_plane_sharded_step(spec, mesh: BandMesh, rebin_variant: int = 6,
                            fuse_tail: bool = True):
    """The band-sharded plane step ``(slab PlaneState, SimParams) -> (slab
    PlaneState, diags)``: this rank's part of one frame of the grid ``spec``,
    on a slab from :func:`.shard.shard_plane_state`.  ``diags`` is the [3]
    int32 tensor of :data:`DIAGS`, summed over the bands (read it with
    :func:`check_plane_diags`).

    ``fuse_tail`` as in ``plane_step``: the fused walk (K3, or K6), or the raw
    walk (K3b, or K6) and the tail in torch, the order of JAX's sharded step.
    ``rebin_variant``: 6 (K7) or 5 (K9's two passes, with the adoption
    returned across band boundaries), which give the same planes bit for bit;
    any other raises ValueError (JAX runs 5 for any other than 6).  The
    warm-up gate reads the host-side frame counter, as ``plane_step`` does."""
    local = _band_step(spec, mesh, rebin_variant, fuse_tail)

    def step(ps: PlaneState, params):
        with span("sph.frame"):
            return local(ps, params)

    return step


def _band_step(spec, mesh: BandMesh, rebin_variant: int, fuse_tail: bool):
    """:func:`make_plane_sharded_step`'s step without the frame's span, for
    the frames that hold it."""
    if rebin_variant not in (5, 6):
        raise ValueError(f"the sharded step runs rebin variant 5 or 6, not {rebin_variant}")
    if spec.gh % mesh.size:
        raise ValueError(f"gh={spec.gh} must divide by {mesh.size} bands; build the "
                         f"grid with parallel.shard.make_shard_spec")
    row0 = mesh.rank * (spec.gh // mesh.size)

    # The exchanges are looked up when the frame runs, so a swapped
    # ``rebin_halo`` or ``halo_rows`` of this module takes effect.  K7
    # predicts the band's own rows at load; its ghost rows come predicted,
    # from the neighbours' edge rows predicted in torch.
    def rebin(chans, variant, predict):
        if variant == 5:
            return _rebin_v5_band(chans, spec, row0, mesh), None, None
        with span("sph.predict"):
            edges = predict_channels(_edge_rows(chans), predict)
        return rebin_planes_walk(chans, spec, FILLS, row0, rebin_halo(edges, FILLS, mesh),
                                 predict)

    slab = Slab(row0, rebin, lambda planes, fills: halo_rows(planes, fills, mesh))

    def local(ps: PlaneState, params):
        if ps.frame >= params.shader_delay:
            planes, live_before, _, fpx = _physics(ps, params, spec, fuse_tail,
                                                   rebin_variant, slab)
            new = PlaneState(*planes, frame=ps.frame, lost=ps.lost, n=ps.n)
            with span("sph.count"):
                live = planes[0] < 0.5 * SENTINEL
                deferred = (live & ~(fpx < 0.5 * SENTINEL)).sum(dtype=torch.int32)
                counts = torch.stack([live_before, live.sum(dtype=torch.int32), deferred])
        else:
            with span("sph.count"):
                new, live = ps, ps.live.sum(dtype=torch.int32)
                counts = torch.stack([live, live, torch.zeros_like(live)])
        return dataclasses.replace(new, frame=ps.frame + 1), mesh.all_reduce(counts)

    return local


def make_plane_sharded_frame(spec, mesh: BandMesh, render_spec, bounds_static,
                             rebin_variant: int = 6, fuse_tail: bool = True):
    """The sharded step plus its image: each band rasterizes its rows (K4, its
    accumulator epilogue) into full-image accumulators, one all_reduce sums
    them, and every rank resolves the image.  Returns ``(slab PlaneState, SimParams) -> (slab PlaneState,
    [H, W, 4] image, diags)``.

    The band's slab is embedded in full-height planes of dead slots, because
    the rasterizer places a cell's patch by its global row; K4 therefore
    sweeps the whole grid on every band (a row-window K4 is not written yet).
    As in JAX: margin 4, drift clamped, ramp colours summing to 1 with blue
    rebuilt before the sum (linear, so the sum is unchanged)."""
    step = _band_step(spec, mesh, rebin_variant, fuse_tail)
    R = spec.gh // mesh.size
    rows = slice(mesh.rank * R, (mesh.rank + 1) * R)

    def frame(ps: PlaneState, params):
        with span("sph.frame"):
            new, diags = step(ps, params)
            with span("sph.render"):
                full = []
                for p, f in zip((new.px, new.py, new.vx, new.vy), FILLS):
                    plane = torch.full((spec.gh, spec.gw, spec.capacity), f,
                                       dtype=p.dtype, device=p.device)
                    plane[rows] = p
                    full.append(plane)
                geometry = render_geometry(bounds_static, spec, render_spec, MARGIN,
                                           params.particle_size)
                rgb, alpha = accumulators(
                    raster_planes(*full, geometry, params.max_energy, color_sum=1.0,
                                  clamp_drift=True, background=None), 1.0)
                acc = mesh.all_reduce(torch.cat([rgb, alpha[..., None]], dim=-1))
                image = splat_resolve(acc[..., :3], acc[..., 3], (0.0, 0.0, 0.0, 1.0))
        return new, image, diags

    return frame
