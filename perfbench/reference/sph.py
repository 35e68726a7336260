"""The plain reference of the plane-resident SPH frame, in PyTorch alone.

A frozen copy of the port's plain versions, as they stood when this benchmark
was written, so that a later change to the port cannot move the yardstick: the
initial binning (one stable sort, slots by rank, the overflow spill), gravity
and predict, the lossless rebin (variant 6, whole grid), the defer mask, the
density walk, the pressure terms and the force walk with the frame tail.  It
imports nothing of the port and nothing of JAX; every value it needs it works
out from the particles and the parameters it is handed.

The walks evaluate the dense 3x3 cell window in row chunks, the slots above the
highest live one of each chunk dropped.  ``pair_dtype`` computes the pair terms
in another type (the sums stay float32): bfloat16 is the control, the
reference in the precision below the one the configuration states.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SENTINEL = 1.0e6  # dead-slot parking position
MAX_SPILL = 4096  # overflow rows the initial spill places
EPS2 = float(np.float32(1e-4) ** 2)  # the force walk's direction guard, in f32
CHUNK_ELEMS = 1 << 25  # pair elements per row chunk


def f32(v) -> float:
    return float(np.float32(v))


def f32_mul(a: float, b: float) -> float:
    return float(np.float32(a) * np.float32(b))


@dataclasses.dataclass(frozen=True)
class Grid:
    """Cells ``cell`` high and ``aspect`` times as wide over the bounds, ``C``
    slots each; ``gh`` may be padded above the domain (the band mesh pads it
    to a multiple of the bands: the rows it adds stay empty)."""

    x_min: float
    y_min: float
    cell: float
    gw: int
    gh: int
    C: int
    cw: float

    @classmethod
    def of(cls, bounds, cell: float, capacity: int, bands: int = 1,
           aspect: int = 1) -> "Grid":
        x_min, x_max, y_min, y_max = (float(b) for b in bounds)
        cw = float(cell) * int(aspect)
        gw = int(math.floor((x_max - x_min) / cw)) + 1
        gh = int(math.floor((y_max - y_min) / cell)) + 1
        return cls(x_min, y_min, float(cell), gw, math.ceil(gh / bands) * bands,
                   int(capacity), cw)


@dataclasses.dataclass(frozen=True)
class Params:
    """The frame's scalars, each rounded to float32 as the configuration's
    physics states them (``src/main.rs:25-35`` of the reference app, the
    kernel norms of ``main.rs:96-98``)."""

    h: float
    particle_size: float
    dt: float
    gravity: float
    target_density: float
    pressure_multiplier: float
    near_density_multiplier: float
    viscosity_strength: float
    damping: float
    max_energy: float
    bounds: tuple
    dnorm: float
    nnorm: float
    vnorm: float

    @classmethod
    def of(cls, physics: dict, bounds) -> "Params":
        h = float(physics["smoothing_radius"])
        return cls(
            h=f32(h), particle_size=f32(physics["particle_size"]), dt=f32(physics["dt"]),
            gravity=f32(physics["gravity"]), target_density=f32(physics["target_density"]),
            pressure_multiplier=f32(physics["pressure_multiplier"]),
            near_density_multiplier=f32(physics["near_density_multiplier"]),
            viscosity_strength=f32(physics["viscosity_strength"]),
            damping=f32(physics["damping_factor"]), max_energy=f32(physics["max_energy"]),
            bounds=tuple(f32(b) for b in bounds),
            dnorm=f32(10.0 / (math.pi * h ** 5)), nnorm=f32(15.0 / (math.pi * h ** 6)),
            vnorm=f32(4.0 / (math.pi * h ** 8)))


def live(x):
    return x < 0.5 * SENTINEL


def cell_index(v, lo: float, width: float, n: int):
    """``clip(floor((v - lo) / width), 0, n - 1)``, the division a true one
    (a device tensor divisor: a host scalar divides by its reciprocal)."""
    w = torch.full((), width, dtype=torch.float32, device=v.device)
    return torch.floor((v - lo) / w).to(torch.int32).clamp(0, n - 1)


def key_x(x, g: Grid):
    return cell_index(x, g.x_min, g.cw, g.gw)


def key_y(y, g: Grid):
    return cell_index(y, g.y_min, g.cell, g.gh)


# ---------------------------------------------------------------- binning


def _spill_offsets():
    return sorted([(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
                   if (dy, dx) != (0, 0)],
                  key=lambda o: (o[0] * o[0] + o[1] * o[1], o[0], o[1]))


def bin_particles(pos, vel, g: Grid, rows=None):
    """The initial planes (px, py, vx, vy, idsf) ``[gh, gw, C]`` of the
    particles ``pos``, ``vel`` (ids in row order), and how many were lost: a
    stable sort by cell, slot = rank in the cell; rows past C go, in sorted
    order, to the nearest cell of their 5x5 neighbourhood with a free slot
    (the first ``MAX_SPILL`` of them).

    ``rows`` = ``(a, b)`` builds only the grid rows ``a .. b-1`` (a band's):
    every particle is still sorted and spilled over the whole grid, so the
    planes are those rows of the whole planes, and the loss counts the
    particles whose own cell lies in them."""
    a, b = (0, g.gh) if rows is None else rows
    n, dev = pos.shape[0], pos.device
    keys = key_y(pos[:, 1], g) * g.gw + key_x(pos[:, 0], g)
    skeys, perm = torch.sort(keys, stable=True)
    ncell = g.gw * g.gh
    starts = torch.searchsorted(skeys, torch.arange(ncell + 1, dtype=torch.int32,
                                                    device=dev)).long()
    slot = torch.arange(n, device=dev) - starts[skeys.long()]
    packed = lambda i: torch.cat([pos[perm[i]], vel[perm[i]],
                                  perm[i].to(torch.float32)[:, None]], dim=1)
    fills = torch.tensor([SENTINEL, SENTINEL, 0.0, 0.0, 0.0], device=dev)
    base = a * g.gw * g.C  # the first slot of the rows built
    cells = fills.repeat((b - a) * g.gw * g.C, 1)
    fit = slot < g.C
    put = fit & (skeys >= a * g.gw) & (skeys < b * g.gw)
    cells[skeys[put].long() * g.C + slot[put] - base] = packed(put)
    over = torch.nonzero(~fit).flatten()
    home = skeys[over] // g.gw
    lost = int(((home >= a) & (home < b)).sum())
    if over.numel():
        counts = (starts[1:] - starts[:-1]).clamp_max(g.C).reshape(g.gh, g.gw)
        counts = counts.cpu().numpy().copy()
        spilled, dest = [], []
        for i, key in zip(over[:MAX_SPILL].tolist(),
                          skeys[over[:MAX_SPILL]].tolist()):
            cy, cx = divmod(int(key), g.gw)
            for dy, dx in _spill_offsets():
                ny, nx = min(max(cy + dy, 0), g.gh - 1), min(max(cx + dx, 0), g.gw - 1)
                if counts[ny, nx] < g.C and (ny, nx) != (cy, cx):
                    lost -= int(a <= cy < b)
                    if a <= ny < b:
                        spilled.append(i)
                        dest.append((ny * g.gw + nx) * g.C + int(counts[ny, nx]) - base)
                    counts[ny, nx] += 1
                    break
        if spilled:
            cells[torch.tensor(dest, device=dev)] = packed(torch.tensor(spilled, device=dev))
    planes = cells.reshape(b - a, g.gw, g.C, 5).permute(3, 0, 1, 2)
    return [p.contiguous() for p in planes], lost


# ---------------------------------------------------------------- rebin


def predict(planes, p: Params):
    """Gravity and predict: the rebin's channels (pred x, pred y, vx, vy, idsf)."""
    px, py, vx, vy, idsf = planes
    m = live(px)
    vxp = torch.where(m, vx, 0.0)
    vyp = torch.where(m, vy - f32_mul(p.gravity, p.dt), 0.0)
    return [torch.where(m, px + vxp * p.dt, SENTINEL),
            torch.where(m, py + vyp * p.dt, SENTINEL), vxp, vyp, idsf]


FILLS = (SENTINEL, SENTINEL, 0.0, 0.0, 0.0)


def _shift(t, d: int, fill: float):
    """Along the columns: the value at c comes from c + d; ``fill`` outside."""
    out = torch.full_like(t, fill)
    n = t.shape[1]
    if abs(d) < n:
        if d > 0:
            out[:, : n - d] = t[:, d:]
        else:
            out[:, -d:] = t[:, : n + d]
    return out


def _hole_fill(own, win, keep, stay):
    """Candidate of window rank j fills the dead own slot of rank j while
    j < #holes; stayers keep their slot; every other slot takes the fill."""
    C = own[0].shape[-1]
    dead = ~live(own[0])
    arank = torch.cumsum(keep.to(torch.int32), -1) - 1
    hrank = torch.cumsum(dead.to(torch.int32), -1) - 1
    n_arr = keep.sum(-1, keepdim=True)
    n_holes = dead.sum(-1, keepdim=True)
    adopted = keep & (arank < n_holes)
    dest = torch.where(adopted, arank, C).long()
    widx = torch.arange(2 * C, device=keep.device).expand_as(dest)
    src = torch.zeros(dest.shape[:-1] + (C + 1,), dtype=torch.long, device=keep.device)
    src.scatter_(-1, dest, widx)
    filled = dead & (hrank < n_arr)
    pick = src.gather(-1, hrank.clamp(0, C - 1).long())
    return [torch.where(stay, o, torch.where(filled, w.gather(-1, pick), f))
            for o, w, f in zip(own, win, FILLS)]


def rebin(chans, g: Grid, row0: int = 0):
    """The lossless rebin: stayers keep their slots; a mover whose one-cell
    hop lands in a neighbour fills its dead slots in candidate order (rows
    r-1 then r+1, then columns c-1 then c+1, slot order within each); a mover
    no neighbour adopts stays where it is.  ``chans`` are grid rows from
    ``row0`` on (a band with its ghost rows); row r of the output reads rows
    r-2 .. r+1, and the fills past the planes' ends."""
    gw, C = g.gw, g.C
    R = chans[0].shape[0]
    ext = [torch.cat([torch.full((2, gw, C), f, device=p.device), p,
                      torch.full((1, gw, C), f, device=p.device)])
           for p, f in zip(chans, FILLS)]
    rows = (torch.arange(R, device=chans[0].device) + row0).view(R, 1, 1)
    cols = torch.arange(gw, device=chans[0].device).view(1, gw, 1)
    kx = lambda x: key_x(x, g)
    ky = lambda y: key_y(y, g)
    planes = [p[2: R + 2] for p in ext]
    x0, y0 = planes[0], planes[1]
    live0, ky0 = live(x0), ky(y0)
    up = [p[1: R + 1] for p in ext]
    dn = [p[3: R + 3] for p in ext]
    keep_up = live(up[0]) & (rows >= 1) & (ky(up[1]) >= rows)
    keep_dn = live(dn[0]) & (rows <= g.gh - 2) & (ky(dn[1]) <= rows)
    out_y = _hole_fill(planes, [torch.cat([u, d], -1) for u, d in zip(up, dn)],
                       torch.cat([keep_up, keep_dn], -1), live0 & (ky0 == rows))
    # did row r-1 / r+1 adopt row r's mover?
    keep_m2 = live(ext[0][:R]) & (rows >= 2) & (ky(ext[1][:R]) >= rows - 1)
    into_up = live0 & (ky0 <= rows - 1) & (rows >= 1)
    rank_up = keep_m2.sum(-1, keepdim=True) + torch.cumsum(into_up.to(torch.int32), -1) - 1
    adopted_up = into_up & (rank_up < (~live(up[0])).sum(-1, keepdim=True))
    into_dn = live0 & (ky0 >= rows + 1) & (rows <= g.gh - 2)
    rank_dn = torch.cumsum(into_dn.to(torch.int32), -1) - 1
    adopted_dn = into_dn & (rank_dn < (~live(dn[0])).sum(-1, keepdim=True))
    retain = live0 & (ky0 != rows) & ~(adopted_up | adopted_dn)
    mid = [torch.where(retain, p, o) for p, o in zip(planes, out_y)]

    mx, my = mid[0], mid[1]
    liveM, mkx, mky = live(mx), kx(mx), ky(my)
    lf = [_shift(p, -1, f) for p, f in zip(mid, FILLS)]
    rt = [_shift(p, 1, f) for p, f in zip(mid, FILLS)]
    kg0 = live(lf[0]) & (cols >= 1) & (ky(lf[1]) == rows) & (kx(lf[0]) >= cols)
    kg1 = live(rt[0]) & (cols <= gw - 2) & (ky(rt[1]) == rows) & (kx(rt[0]) <= cols)
    out_x = _hole_fill(mid, [torch.cat([a, b], -1) for a, b in zip(lf, rt)],
                       torch.cat([kg0, kg1], -1), liveM & ((mky != rows) | (mkx == cols)))
    in_row = liveM & (mky == rows)
    l2x, l2y = _shift(mx, -2, SENTINEL), _shift(my, -2, SENTINEL)
    g0_of_l = live(l2x) & (cols >= 2) & (ky(l2y) == rows) & (kx(l2x) >= cols - 1)
    into_l = in_row & (cols >= 1) & (mkx <= cols - 1)
    rank_l = g0_of_l.sum(-1, keepdim=True) + torch.cumsum(into_l.to(torch.int32), -1) - 1
    adopted_l = into_l & (rank_l < (~live(lf[0])).sum(-1, keepdim=True))
    into_r = in_row & (cols <= gw - 2) & (mkx >= cols + 1)
    rank_r = torch.cumsum(into_r.to(torch.int32), -1) - 1
    adopted_r = into_r & (rank_r < (~live(rt[0])).sum(-1, keepdim=True))
    retain = in_row & (mkx != cols) & ~(adopted_l | adopted_r)
    return [torch.where(retain, m, o) for m, o in zip(mid, out_x)]


def walk_positions(npx, npy, g: Grid, row0: int = 0):
    """Deferred slots (live, but resident in another cell than their key) are
    parked: they take no part in the walks this frame.  The planes are grid
    rows from ``row0`` on."""
    cx = torch.arange(g.gw, dtype=torch.int32, device=npx.device)[None, :, None]
    cy = (torch.arange(npx.shape[0], dtype=torch.int32, device=npx.device)
          + row0)[:, None, None]
    defer = live(npx) & ((key_x(npx, g) != cx) | (key_y(npy, g) != cy))
    return torch.where(defer, SENTINEL, npx), torch.where(defer, SENTINEL, npy)


# ---------------------------------------------------------------- walks


def _windows(planes_fills, r0: int, r1: int, gw: int):
    """Per plane, the 3x3 cell window of rows r0..r1 as ``[R, gw, 9, C]``."""
    out = []
    for p, fill in planes_fills:
        gh, _, C = p.shape
        cols = (torch.arange(gw, device=p.device) + 1)[:, None] + torch.arange(3, device=p.device)
        lo, hi = max(r0 - 1, 0), min(r1 + 1, gh)
        pad = torch.full((r1 - r0 + 2, gw + 4, C), fill, dtype=p.dtype, device=p.device)
        pad[lo - (r0 - 1): hi - (r0 - 1), 2: gw + 2] = p[lo:hi]
        out.append(torch.cat([pad[dy: dy + r1 - r0][:, cols] for dy in range(3)], dim=2))
    return out


def _chunks(px):
    """Row chunks ``(r0, r1, c)``: c is 1 + the highest live slot of rows
    r0-1..r1 (slots above it are parked everywhere the chunk reads)."""
    gh, gw, C = px.shape
    step = max(1, CHUNK_ELEMS // (gw * C * 9 * C))
    for r0 in range(0, gh, step):
        r1 = min(gh, r0 + step)
        any_live = live(px[max(r0 - 1, 0): r1 + 1]).flatten(0, 1).any(0)
        idx = torch.nonzero(any_live)
        if idx.numel():
            yield r0, r1, int(idx.max()) + 1


def density(wx, wy, p: Params, pair_dtype=torch.float32):
    """(rho, rhon) per slot, and the pairs within the radius (self included)
    of the walk-live slots: norms x (sum v^2, sum v^3), v = max(h - d, 0)."""
    gh, gw, C = wx.shape
    rho, rhon = torch.zeros_like(wx), torch.zeros_like(wx)
    pairs = 0
    for r0, r1, c in _chunks(wx):
        ox, oy = wx[r0:r1, :, :c], wy[r0:r1, :, :c]
        nx, ny = _windows([(wx[..., :c], SENTINEL), (wy[..., :c], SENTINEL)], r0, r1, gw)
        dx = (nx[:, :, None] - ox[..., None, None]).to(pair_dtype)
        dy = (ny[:, :, None] - oy[..., None, None]).to(pair_dtype)
        d = torch.sqrt(dx * dx + dy * dy)
        v = (p.h - d).clamp_min(0.0)
        vv = v * v
        own = live(ox)
        pairs += int(((d < p.h) & own[..., None, None]).sum())
        rho[r0:r1, :, :c] = torch.where(own, p.dnorm * vv.float().sum(-2).sum(-1), 0.0)
        rhon[r0:r1, :, :c] = torch.where(own, p.nnorm * (vv * v).float().sum(-2).sum(-1), 0.0)
    return rho, rhon, pairs


def pressure_terms(rho, rhon, p: Params):
    """Per slot (alpha p / rho^2, beta np / rho^2, beta np / (rho rhon)),
    alpha = -2 dnorm, beta = -3 nnorm, guarded for empties."""
    rho_safe = torch.where(rho > 0, rho, 1.0)
    rhon_safe = torch.where(rhon > 0, rhon, 1.0)
    alpha, beta = f32(-2.0 * p.dnorm), f32(-3.0 * p.nnorm)
    inv_rho2 = 1.0 / (rho_safe * rho_safe)
    pr = (rho - p.target_density) * p.pressure_multiplier
    npr = rhon * p.near_density_multiplier
    return alpha * (pr * inv_rho2), beta * (npr * inv_rho2), beta * (npr / (rho_safe * rhon_safe))


def _bounce(x, v, lo: float, hi: float, damp: float):
    v = torch.where(x <= lo, v.abs() * damp, v)
    v = torch.where(x >= hi, -v.abs() * damp, v)
    return x.clamp(lo, hi), v


def forces(wx, wy, P1, NPn, vx, vy, NPo, npx, npy, p: Params, pair_dtype=torch.float32):
    """The pressure, near-pressure and viscosity sums over the window, then
    the frame tail per slot: velocity combine, deferred slots keep their
    post-gravity velocity, Euler from the predicted position, bounce, park.
    Returns the final (px, py, vx, vy) and, for the comparison, the tail's
    velocity before the bounce and its position before the clamp."""
    gh, gw, C = wx.shape
    h = p.h
    accs = [torch.zeros_like(wx) for _ in range(5)]
    for r0, r1, c in _chunks(wx):
        sl = (slice(r0, r1), slice(None), slice(None, c))
        e = lambda t: t[sl][..., None, None]
        nb = _windows([(t[..., :c], f) for t, f in ((wx, SENTINEL), (wy, SENTINEL),
                       (P1, 0.0), (NPn, 0.0), (vx, 0.0), (vy, 0.0))], r0, r1, gw)
        nx, ny, nP1, nNPn, nvx, nvy = (t[:, :, None] for t in nb)
        dx = (nx - e(wx)).to(pair_dtype)
        dy = (ny - e(wy)).to(pair_dtype)
        d2 = dx * dx + dy * dy
        near0 = d2 <= EPS2
        inv_d = torch.where(near0, 0.0, torch.rsqrt(d2))
        v = (h - d2 * inv_d).clamp_min(0.0)
        mag = (e(P1) + nP1).to(pair_dtype) * v + (e(NPo) + nNPn).to(pair_dtype) * (v * v)
        m = mag * inv_d
        u = (h * h - d2).clamp_min(0.0)
        u3 = u * u * u
        own = live(wx[sl])
        sums = (dx * m, dy * m + torch.where(near0, mag, 0.0), u3,
                nvx.to(pair_dtype) * u3, nvy.to(pair_dtype) * u3)
        for a, t in zip(accs, sums):
            a[sl] = torch.where(own, t.float().sum(-2).sum(-1), 0.0)
    fx, fy, S, Sx, Sy = accs
    fy = fy - ((P1 + P1) * h + (NPo + NPn) * (h * h))
    fvx, fvy = Sx - vx * S, Sy - vy * S
    vscale = f32_mul(f32_mul(p.vnorm, p.viscosity_strength), p.dt)
    nvx = vx + fx * p.dt + fvx * vscale
    nvy = vy + fy * p.dt + fvy * vscale
    alive = live(npx)
    defer = ~live(wx) & alive
    nvx, nvy = torch.where(defer, vx, nvx), torch.where(defer, vy, nvy)
    x_min, x_max, y_min, y_max = p.bounds
    x2, y2 = npx + (nvx - vx) * p.dt, npy + (nvy - vy) * p.dt
    bx, bvx = _bounce(x2, nvx, x_min, x_max, p.damping)
    by, bvy = _bounce(y2, nvy, y_min, y_max, p.damping)
    out = (torch.where(alive, bx, SENTINEL), torch.where(alive, by, SENTINEL),
           torch.where(alive, bvx, 0.0), torch.where(alive, bvy, 0.0))
    return out, (x2, y2, nvx, nvy)


def step(planes, p: Params, g: Grid, pair_dtype=torch.float32, rebin=rebin,
         defer: bool = True, row0: int = 0) -> dict:
    """One physics frame of the plane state ``planes`` (px, py, vx, vy,
    idsf), rebinned by ``rebin(chans, g, row0)`` (the lossless one by
    default); ``defer=False`` walks every live slot where it is (a rebin that
    drops what does not fit).  The planes are grid rows from ``row0`` on: the
    whole grid, or a band with the ghost rows its own rows read (rows
    r-4 .. r+3 of the input make row r of the output: the rebin reads r-2 ..
    r+1, the force walk the pressure terms of r±1, whose density walk and
    its slot trim (``_chunks``) read the rebinned rows r±2).  Returns the
    new planes and what the comparison and the work counts read: the tail's
    raw values, the pairs the walks need."""
    npx, npy, nvx0, nvy0, nidsf = rebin(predict(planes, p), g, row0)
    wx, wy = walk_positions(npx, npy, g, row0) if defer else (npx, npy)
    rho, rhon, pairs = density(wx, wy, p, pair_dtype)
    P1, NPo, NPn = pressure_terms(rho, rhon, p)
    (px, py, vx, vy), raw = forces(wx, wy, P1, NPn, nvx0, nvy0, NPo, npx, npy, p, pair_dtype)
    walk_live = int(live(wx).sum())
    return {"planes": [px, py, vx, vy, torch.where(live(npx), nidsf, 0.0)], "raw": raw,
            "density_pairs": pairs, "force_pairs": pairs - walk_live,
            "walk_live": walk_live}
