"""Plane-RESIDENT SPH: state lives in cell planes across frames; no per-frame sort.

Counterpart of ``rust_particle_system_tpu/ops/pallas/resident.py`` for the
single-chip main path: ``plane_state_from_particles`` (one sort, the plane build
K5, the overflow spill), ``plane_physics`` / ``plane_step`` (gravity + predict,
the rebin of the chosen ``variant``: the lossless K1 by default, which reads
the state's planes and predicts them at load, and also writes the walks'
position planes (the defer mask); for the others the predict in torch, then
two K9 passes for 4 and 5, K12 for 2 and 3; for 5 the defer mask in torch;
for 5 and 6 the density walk K2
with the pressure terms in its epilogue, the fused force walk K3 with the
frame tail, or with ``fuse_tail=False`` the raw walk K3b and the tail in
torch; for 2-4 no defer mask and always the raw walk), ``plane_frame`` (a
frame plus its image through the plane render K4), ``render_plane_state`` and
``to_particle_state``.

A frame's phases are written once, in ``_physics``, on a ``Slab``: the whole
grid here, or a band's rows on the mesh (``parallel/plane_sharded.py``),
with the band's rebin and the walks' ghost rows.

The frame counter is a host-side int, so the warm-up gate needs no device read;
``lost`` stays a device tensor and is only read back when asked for.

Each frame is one ``sph.frame`` span, its phases spans inside it
(:func:`~...runtime.profiling.span`: ``sph.count``, ``sph.predict``,
``sph.rebin``, ``sph.defer``, ``sph.density``, ``sph.pressure``, ``sph.force``,
``sph.tail``, ``sph.render``), so a profile of the frame splits its device
time by phase; with no profiler recording each is one shared no-op.  The
default rebin predicts at load and writes the walk planes under
``sph.rebin``, so its frames have no ``sph.predict`` row on one card and no
``sph.defer``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ...core import kernels as K
from ...core.params import SimParams, f32_mul
from ...core.state import ParticleState
from ...render.splat_planes import WHITE, drifted_patch_margin, raster_planes, render_geometry
from ...runtime.profiling import span
from ..grid import GridSpec, build_grid
from .plane_build import cell_planes_aos
from .rebin import (SENTINEL, check_variant, predict_channels, rebin_planes, rebin_planes_walk,
                    walk_positions)
from .sph_step import _forces_from_cells, _velocities_from_cells

ID_EXACT = 1 << 24  # ids below it ride the f32 ``idsf`` channel as their value
MAX_IDS = (1 << 31) - (1 << 23)  # the id codec's range: ids 0 .. MAX_IDS - 1
_SIGN_BIT = -(1 << 31)  # 0x80000000 as an int32
MAX_SPILL = 4096  # overflow rows the init spill places (as JAX's max_spill)
FILLS = (SENTINEL, SENTINEL, 0.0, 0.0, 0.0)  # a dead slot's px, py, vx, vy, idsf


@dataclasses.dataclass(frozen=True)
class PlaneState:
    """Cell-plane particle state ``[gh, gw, C]``.  Dead slots hold
    :data:`FILLS`: px/py = SENTINEL, vx/vy/idsf = 0.  ``n`` is the initial
    particle count; ``lost`` (int32 device scalar) counts particles dropped at
    the initial binning, so the live total is always ``n - lost``."""

    px: torch.Tensor
    py: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    idsf: torch.Tensor  # original index, encoded by :func:`encode_ids`
    frame: int
    lost: torch.Tensor
    n: int

    @property
    def live(self) -> torch.Tensor:
        return self.px < 0.5 * SENTINEL

    def to_particle_state(self, params: SimParams | None = None) -> ParticleState:
        return to_particle_state(self, params)


def encode_ids(ids: torch.Tensor) -> torch.Tensor:
    """Particle ids (0 .. ``MAX_IDS`` - 1) as the f32 ``idsf`` channel.  An id
    below 2^24 is ``float(id)``, exact, as the JAX package stores it; a wider
    one is the float whose bits are ``0x80000000 | id``: negative, its
    exponent field ``id >> 23`` in 2..254, so never a subnormal, -0.0, an
    infinity or a NaN.  The frame moves the channel (the rebin, the re-park,
    the mesh's exchanges) and never computes with it, so either form comes
    back unchanged from :func:`decode_ids`."""
    ids = ids.to(torch.int32)
    wide = (ids | _SIGN_BIT).view(torch.float32)
    return torch.where(ids >= ID_EXACT, wide, ids.to(torch.float32))


def decode_ids(idsf: torch.Tensor) -> torch.Tensor:
    """The int32 ids of an ``idsf`` channel (:func:`encode_ids`' inverse);
    a dead slot's 0.0 reads 0."""
    bits = idsf.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits & 0x7FFFFFFF, idsf.to(torch.int32))


def _spill_offsets():
    """The 5x5 neighbourhood minus the centre, by distance then row-major."""
    return sorted(
        [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if (dy, dx) != (0, 0)],
        key=lambda o: (o[0] * o[0] + o[1] * o[1], o[0], o[1]))


def _spill_init_overflow(ch, packed, grid, spec: GridSpec, a: int = 0):
    """Zero-loss initial binning: place capacity-overflow rows (``slot >= C`` in
    the sorted stream) into the nearest neighbour cell with a free slot, in
    sorted order, counts updated as it goes (the JAX ``_spill_init_overflow``).
    ``ch`` holds grid rows ``a ..``; every spill is decided over the whole
    grid, and those that land in ``ch``'s rows are written.

    The placement loop runs on the host over at most ``MAX_SPILL`` rows, and
    only when there is overflow (one device read at init); the values are then
    written into the planes in one scatter.  Returns (planes, spilled), every
    spill counted wherever it landed."""
    gh, gw, C = spec.gh, spec.gw, spec.capacity
    over = grid.slot >= C
    n_over = int(over.sum())
    if n_over == 0:
        return ch, 0
    idx = torch.nonzero(over).flatten()[:MAX_SPILL]
    # each cell's live slots in the whole grid's planes before the spill
    placed = ~over & (packed[:, 0] < 0.5 * SENTINEL)
    counts = torch.bincount(grid.sorted_keys[placed].long(), minlength=gh * gw)
    counts = counts.reshape(gh, gw).cpu().numpy()
    key_h = grid.sorted_keys[idx].cpu().numpy()
    offs = _spill_offsets()
    rows, ty, tx, ts = [], [], [], []
    spilled = 0
    for i, key in enumerate(key_h):
        cy, cx = divmod(int(key), gw)
        for dy, dx in offs:
            ny = min(max(cy + dy, 0), gh - 1)
            nx = min(max(cx + dx, 0), gw - 1)
            # clipped offsets can alias the (full) home cell; exclude it
            if counts[ny, nx] < C and (ny != cy or nx != cx):
                spilled += 1
                if a <= ny < a + ch[0].shape[0]:
                    rows.append(i)
                    ty.append(ny - a)
                    tx.append(nx)
                    ts.append(int(counts[ny, nx]))
                counts[ny, nx] += 1
                break
    if rows:
        dev = ch[0].device
        sel = idx[torch.as_tensor(rows, device=dev)]
        at = tuple(torch.as_tensor(v, device=dev) for v in (ty, tx, ts))
        vals = packed[sel]
        ch = [p.index_put(at, vals[:, c]) for c, p in enumerate(ch)]
    return ch, spilled


def plane_state_from_particles(state: ParticleState, spec: GridSpec,
                               rows: tuple | None = None) -> PlaneState:
    """Initial binning: one sort + gather + plane build (the only one ever run).

    Per-cell capacity overflow is re-homed to the nearest free neighbour cell
    instead of dropped; ``lost`` is 0 unless a whole 5x5 neighbourhood is
    packed solid.  Ids (``state.ids``, else 0 .. n-1) go into ``idsf``
    through :func:`encode_ids`.  ``rows = (a, b)`` builds grid rows ``a ..
    b-1`` alone (a band of the mesh), with every particle still sorted and
    spilled over the whole grid: those rows of the whole planes, and the
    whole grid's ``lost``."""
    state = state.with_ids()
    n = state.n
    if n:
        lo, hi = (int(v) for v in torch.aminmax(state.ids))
        if lo < 0 or hi >= MAX_IDS:
            raise ValueError(f"ids {lo}..{hi}: the idsf channel holds 0..{MAX_IDS - 1}")
    gh, gw, C = spec.gh, spec.gw, spec.capacity
    a, b = (0, gh) if rows is None else rows
    if not 0 <= a < b <= gh:
        raise ValueError(f"rows {rows} of a grid of {gh}")
    grid = build_grid(spec, state.pos, with_table=False)
    idsf = encode_ids(state.ids)
    packed = torch.cat([state.pos, state.vel, idsf[:, None]], dim=-1)[grid.perm.long()]
    cells = cell_planes_aos(packed, grid.starts[a * gw:], (b - a) * gw, C, FILLS)
    ch = [cells[..., i].reshape(b - a, gw, C).contiguous() for i in range(5)]
    del cells
    ch, spilled = _spill_init_overflow(ch, packed, grid, spec, a)
    return PlaneState(px=ch[0], py=ch[1], vx=ch[2], vy=ch[3], idsf=ch[4],
                      frame=state.frame, lost=(grid.overflow - spilled).to(torch.int32),
                      n=n)


def _planes_to_particles(ps: PlaneState):
    """Live slots back to an [n]-row stream ordered by id; rows of dropped
    particles come last (ids >= n, SENTINEL positions, zero velocity)."""
    n = ps.n
    live = ps.live.reshape(-1)
    ids = decode_ids(ps.idsf).reshape(-1)
    key = torch.where(live, ids, torch.iinfo(torch.int32).max)
    order = torch.argsort(key, stable=True)[:n]
    livc = live[order]
    pos = torch.stack([ps.px.reshape(-1)[order], ps.py.reshape(-1)[order]], dim=-1)
    vel = torch.stack([ps.vx.reshape(-1)[order], ps.vy.reshape(-1)[order]], dim=-1)
    vel = torch.where(livc[:, None], vel, 0.0)
    extra = n + torch.arange(n, dtype=torch.int32, device=ids.device)
    ids_out = torch.where(livc, key[order], extra)
    return pos, vel, ids_out, livc


def to_particle_state(ps: PlaneState, params: SimParams | None = None
                      ) -> ParticleState:
    """Id-ordered particle stream; colour white during warm-up, else the
    kinetic-energy ramp."""
    pos, vel, ids_out, _ = _planes_to_particles(ps)
    if params is not None and ps.frame > params.shader_delay:
        color = K.energy_color(vel, params.max_energy)
    else:
        color = torch.ones((ps.n, 4), dtype=torch.float32, device=pos.device)
    return ParticleState(pos=pos, vel=vel, color=color, frame=ps.frame, ids=ids_out)


def planes_of(ps: PlaneState) -> list:
    """The state's five planes [px, py, vx, vy, idsf]."""
    return [ps.px, ps.py, ps.vx, ps.vy, ps.idsf]


def predict_args(params: SimParams) -> tuple:
    """(dt, gdt) of the predict: the step and the float32 gravity * dt."""
    return params.dt, f32_mul(params.gravity, params.dt)


def predict_planes(ps: PlaneState, params: SimParams) -> list:
    """Gravity + predict (compute_shader.wgsl:397-405), the plain version of
    what K1/K7 apply at load: the rebin's input channels [pred x, pred y, vx,
    vy, idsf], dead slots parked."""
    return predict_channels(planes_of(ps), predict_args(params))


def _unfused_tail(fpx, npx, npy, nvx0, nvy0, nvx, nvy, params: SimParams):
    """The torch frame tail of ``fuse_tail=False`` (JAX resident.py:291-322):
    deferred slots keep their post-gravity velocity, integrate from the
    predicted position, bounce, re-park dead slots."""
    dt = params.dt
    live2 = npx < 0.5 * SENTINEL
    defer = (fpx >= 0.5 * SENTINEL) & live2
    nvx = torch.where(defer, nvx0, nvx)
    nvy = torch.where(defer, nvy0, nvy)
    x_min, x_max, y_min, y_max = params.bounds
    x2, nvx = K.bounce_axis(npx + (nvx - nvx0) * dt, nvx, x_min, x_max,
                            params.damping_factor)
    y2, nvy = K.bounce_axis(npy + (nvy - nvy0) * dt, nvy, y_min, y_max,
                            params.damping_factor)
    return (torch.where(live2, x2, SENTINEL), torch.where(live2, y2, SENTINEL),
            torch.where(live2, nvx, 0.0), torch.where(live2, nvy, 0.0))


def walk_and_integrate(rebinned, walk, spec: GridSpec, params: SimParams,
                       fuse_tail: bool, halo=None):
    """The walks on the rebinned channels (px, py, vx, vy, ...) and the walk
    planes ``walk`` = (wx, wy), deferred slots parked: the density walk K2
    with its pressure terms, then the fused force walk K3, or with
    ``fuse_tail=False`` the raw walk K3b and the torch tail (K6 for
    ``spec.pack2``).  ``halo`` brings a band's ghost rows (see
    :mod:`.sph_step`).  Returns the new (px, py, vx, vy) planes."""
    npx, npy, nvx0, nvy0 = rebinned[:4]
    fpx, fpy = walk
    if fuse_tail:
        return _forces_from_cells(fpx, fpy, nvx0, nvy0, npx, npy, spec, params, halo)
    nvx, nvy = _velocities_from_cells(fpx, fpy, nvx0, nvy0, spec, params, halo)
    with span("sph.tail"):
        return _unfused_tail(fpx, npx, npy, nvx0, nvy0, nvx, nvy, params)


@dataclasses.dataclass(frozen=True)
class Slab:
    """The rows a frame runs on: the whole grid on one card, a band's on the
    mesh.  ``row0`` is its first global row.  ``rebin(chans, variant,
    predict)`` rebins into ``(planes, counts, walk)``: ``chans`` are the
    state's raw planes with ``predict`` = (dt, gdt) for the kernel to
    predict at load (variant 6: K1, K7), else the predicted channels with
    ``predict`` None; ``counts`` None where the rebin gives none, ``walk``
    the walk planes (wx, wy) where the kernel writes them (K1, K7), else
    None.  ``halo`` brings the walks' ghost rows (see :mod:`.sph_step`),
    None on one card."""

    row0: int
    rebin: Callable
    halo: Callable | None = None


def _grid_slab(spec: GridSpec) -> Slab:
    """The whole grid: K1 with the predict at load and the walk planes for
    variant 6, else :func:`rebin_planes` of the variant."""
    def rebin(chans, variant, predict):
        if variant == 6:
            return rebin_planes_walk(chans, spec, FILLS, predict=predict)
        return (*rebin_planes(chans, spec, FILLS, variant), None)

    return Slab(0, rebin)


def _physics(ps: PlaneState, params: SimParams, spec: GridSpec, fuse_tail: bool,
             variant: int, slab: Slab):
    """One live physics frame on ``slab``'s rows, the phases of the card and
    of a band alike: the live count, gravity + predict, the slab's rebin, the
    walk planes, the walks (:func:`walk_and_integrate`), the ids' re-park.
    Variant 6 hands the rebin the state's planes and the predict (K1 and K7
    predict at load); the others predict in torch first.

    The lossless rebins (6; 5 is bit-identical) leave movers that find no
    free slot, and >1-cell/frame movers in transit, in their slot; they are
    DEFERRED, parked in the walk planes (K1 and K7 write them; for variant 5
    the mask runs in torch, in global rows), so they take gravity +
    integrate + bounce only.  Variants 2-4 defer nothing and take the raw
    walk and the torch tail whatever ``fuse_tail`` says.  Returns the five
    new planes, the live count before, the rebin's counts and the walk x
    plane."""
    with span("sph.count"):
        live_before = ps.live.sum(dtype=torch.int32)
    if variant == 6:
        chans, predict = planes_of(ps), predict_args(params)
    else:
        with span("sph.predict"):
            chans, predict = predict_planes(ps, params), None
    with span("sph.rebin"):
        rebinned, counts, walk = slab.rebin(chans, variant, predict)
    del chans  # predicted planes (variants 2-5), not to be held through the walks
    lossless = variant in (5, 6)
    if walk is None and lossless:
        with span("sph.defer"):
            walk = walk_positions(rebinned[0], rebinned[1], spec, slab.row0)
    elif walk is None:
        walk = rebinned[:2]
    out = walk_and_integrate(rebinned, walk, spec, params, fuse_tail and lossless, slab.halo)
    with span("sph.count"):
        idsf = torch.where(rebinned[0] < 0.5 * SENTINEL, rebinned[4], 0.0)
    return (*out, idsf), live_before, counts, walk[0]


def plane_physics(ps: PlaneState, params: SimParams, spec: GridSpec,
                  fuse_tail: bool = True, variant: int = 6) -> PlaneState:
    """One live physics frame (:func:`_physics`) on the whole grid: K1 (the
    rebin, writing the walk planes), K2, then K3, or with ``fuse_tail=False``
    K3b and the tail in torch (the same math in another order of rounding).
    ``lost`` grows by what a lossy rebin (variants 2-4) drops."""
    planes, live_before, counts, _ = _physics(ps, params, spec, fuse_tail, variant,
                                              _grid_slab(spec))
    with span("sph.count"):
        lost = ps.lost + (live_before - counts.clamp_max(spec.capacity).sum(dtype=torch.int32))
    return PlaneState(*planes, frame=ps.frame, lost=lost, n=ps.n)


def plane_step(ps: PlaneState, params: SimParams, spec: GridSpec,
               fuse_tail: bool = True, variant: int = 6) -> PlaneState:
    """Warm-up-honouring full frame: physics once ``frame >= shader_delay``.
    ``variant`` is the rebin's (see :func:`plane_physics`); any other than
    2-6 raises ValueError."""
    with span("sph.frame"):
        return _step(ps, params, spec, fuse_tail, variant)


def _step(ps: PlaneState, params: SimParams, spec: GridSpec, fuse_tail: bool,
          variant: int) -> PlaneState:
    """:func:`plane_step` inside a frame's span."""
    check_variant(variant)
    if ps.frame >= params.shader_delay:
        stepped = plane_physics(ps, params, spec, fuse_tail, variant)
    else:
        stepped = ps
    return dataclasses.replace(stepped, frame=ps.frame + 1)


def plane_frame(ps: PlaneState, params: SimParams, spec: GridSpec, render_spec,
                bounds_static: tuple, patch_margin: int | None = None,
                fuse_tail: bool = True, variant: int = 6):
    """Fused step + render: the frame, then its image straight from the end
    planes through the plane render K4 (one launch: world planes in, image
    out), with no binning.  Returns (state, [H, W, 4] image).

    The patch is the tight one (sprite radius + 1 px of drift slack) with
    centre clamping, so a sprite that drifted further renders displaced
    instead of clipped; ``patch_margin`` asks for a wider patch.  Colours are
    the energy ramp (sum rule 1), in warm-up too, as in JAX.  ``fuse_tail``
    and ``variant`` as in :func:`plane_step`."""
    with span("sph.frame"):
        new = _step(ps, params, spec, fuse_tail, variant)
        with span("sph.render"):
            geometry = render_geometry(
                bounds_static, spec, render_spec,
                drifted_patch_margin(spec, render_spec, bounds_static, patch_margin),
                params.particle_size)
            image = raster_planes(new.px, new.py, new.vx, new.vy, geometry,
                                  params.max_energy, color_sum=1.0, clamp_drift=True)
    return new, image


def render_plane_state(ps: PlaneState, params: SimParams, spec: GridSpec,
                       render_spec, bounds_static: tuple):
    """Standalone render of plane-resident state, with no binning (one K4
    launch): the same patch and clamping as the fused frame.  Warm-up states
    draw white (sum rule 3), later ones the energy ramp (sum rule 1); the
    choice is made from the host-side frame counter, so nothing is read
    back."""
    warm = ps.frame <= params.shader_delay
    with span("sph.render"):
        geometry = render_geometry(bounds_static, spec, render_spec,
                                   drifted_patch_margin(spec, render_spec, bounds_static),
                                   params.particle_size)
        return raster_planes(ps.px, ps.py, ps.vx, ps.vy, geometry, params.max_energy,
                             colors=WHITE if warm else None,
                             color_sum=3.0 if warm else 1.0, clamp_drift=True)
