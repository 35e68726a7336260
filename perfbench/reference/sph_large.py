"""The plain reference of the SPH frame at sizes past 2^24 particles, in
PyTorch alone: :mod:`reference.sph` with three changes, each giving the same
values as that module wherever that module is exact.

* Ids.  ``reference/sph.py`` writes a particle's id as ``float(id)``, exact
  only below 2^24.  Here an id below 2^24 is written the same way, and a wider
  one as the float32 whose bits, read as an int32, are ``id - 2^31`` (the
  sign bit set over the id's own bits).  Every other step moves the channel
  and never computes with it, so the check compares the program's ids with
  these bit for bit.
* The walks and their pair census run in column pieces of ``reference/sph.py``'s
  row chunks (:func:`_pieces`), at most ``CHUNK_ELEMS`` pair elements each: at
  3414 cells a row one row's ``[1, gw, c, 9, c]`` temporary is ~2 GB.  Each
  piece keeps its row chunk's ``c`` (the slot trim reads the whole rows), so
  every slot's sums run over the same shapes in the same order.
* The rebin runs ``REBIN_ROWS`` output rows at a time, each with the input
  rows it reads (r-2 .. r+1), so its temporaries stay a few GB on a band of
  481 rows.

Like ``reference/sph.py`` it imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import torch

from reference import sph as ref
from reference.sph import SENTINEL, live, predict, pressure_terms, walk_positions

CHUNK_ELEMS = 1 << 27  # pair elements per column piece (0.5 GB a float32 temporary)
REBIN_ROWS = 64  # output rows a rebin call makes
EXACT = 1 << 24  # ids below it are written as their value


def id_values(ids) -> torch.Tensor:
    """Integer ids as the idsf channel's float32 values."""
    ids = ids.long()
    wide = (ids - (1 << 31)).to(torch.int32).view(torch.float32)
    return torch.where(ids < EXACT, ids.to(torch.float32), wide)


def bin_particles(pos, vel, g: ref.Grid, rows=None):
    """``reference/sph.py``'s initial binning (planes and loss, ``rows`` a
    band's grid rows), with the ids written by :func:`id_values`."""
    a, b = (0, g.gh) if rows is None else rows
    n, dev = pos.shape[0], pos.device
    keys = ref.key_y(pos[:, 1], g) * g.gw + ref.key_x(pos[:, 0], g)
    skeys, perm = torch.sort(keys, stable=True)
    del keys
    ncell = g.gw * g.gh
    starts = torch.searchsorted(skeys, torch.arange(ncell + 1, dtype=torch.int32,
                                                    device=dev)).long()
    slot = torch.arange(n, device=dev) - starts[skeys.long()]
    packed = lambda i: torch.cat([pos[perm[i]], vel[perm[i]], id_values(perm[i])[:, None]],
                                 dim=1)
    fills = torch.tensor([SENTINEL, SENTINEL, 0.0, 0.0, 0.0], device=dev)
    base = a * g.gw * g.C  # the first slot of the rows built
    cells = fills.repeat((b - a) * g.gw * g.C, 1)
    fit = slot < g.C
    put = fit & (skeys >= a * g.gw) & (skeys < b * g.gw)
    cells[skeys[put].long() * g.C + slot[put] - base] = packed(put)
    del put
    over = torch.nonzero(~fit).flatten()
    home = skeys[over] // g.gw
    lost = int(((home >= a) & (home < b)).sum())
    if over.numel():
        counts = (starts[1:] - starts[:-1]).clamp_max(g.C).reshape(g.gh, g.gw)
        counts = counts.cpu().numpy().copy()
        spilled, dest = [], []
        for i, key in zip(over[:ref.MAX_SPILL].tolist(),
                          skeys[over[:ref.MAX_SPILL]].tolist()):
            cy, cx = divmod(int(key), g.gw)
            for dy, dx in ref._spill_offsets():
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


def rebin(chans, g: ref.Grid, row0: int = 0):
    """``reference/sph.py``'s lossless rebin, ``REBIN_ROWS`` output rows a
    call: output row r reads input rows r-2 .. r+1, and the fills past the
    planes' ends, so each call takes those rows and keeps its own."""
    R = chans[0].shape[0]
    parts = []
    for a in range(0, R, REBIN_ROWS):
        b = min(R, a + REBIN_ROWS)
        lo, hi = max(a - 2, 0), min(b + 1, R)
        out = ref.rebin([c[lo:hi] for c in chans], g, row0 + lo)
        parts.append([o[a - lo: b - lo] for o in out])
    return [torch.cat(ps) for ps in zip(*parts)]


# ---------------------------------------------------------------- walks


def _pieces(px):
    """``reference/sph.py``'s row chunks ``(r0, r1, c)``, each cut into
    columns ``c0 .. c1-1`` of at most ``CHUNK_ELEMS`` pair elements."""
    gw = px.shape[1]
    for r0, r1, c in ref._chunks(px):
        w = max(1, CHUNK_ELEMS // ((r1 - r0) * c * 9 * c))
        for c0 in range(0, gw, w):
            yield r0, r1, c, c0, min(gw, c0 + w)


def _windows(planes_fills, r0: int, r1: int, c0: int, c1: int):
    """Per plane, the 3x3 cell window of rows r0..r1-1 and columns c0..c1-1
    as ``[R, c1 - c0, 9, C]`` (``reference/sph.py``'s ``_windows`` there)."""
    out = []
    for p, fill in planes_fills:
        gh, gw, C = p.shape
        w = c1 - c0
        cols = torch.arange(w, device=p.device)[:, None] + torch.arange(3, device=p.device)
        lo, hi = max(r0 - 1, 0), min(r1 + 1, gh)
        k0, k1 = max(c0 - 1, 0), min(c1 + 1, gw)
        pad = torch.full((r1 - r0 + 2, w + 2, C), fill, dtype=p.dtype, device=p.device)
        pad[lo - (r0 - 1): hi - (r0 - 1), k0 - (c0 - 1): k1 - (c0 - 1)] = p[lo:hi, k0:k1]
        out.append(torch.cat([pad[dy: dy + r1 - r0][:, cols] for dy in range(3)], dim=2))
    return out


def density(wx, wy, p: ref.Params, pair_dtype=torch.float32):
    """``reference/sph.py``'s ``density`` by column pieces."""
    rho, rhon = torch.zeros_like(wx), torch.zeros_like(wx)
    pairs = 0
    for r0, r1, c, c0, c1 in _pieces(wx):
        ox, oy = wx[r0:r1, c0:c1, :c], wy[r0:r1, c0:c1, :c]
        nx, ny = _windows([(wx[..., :c], SENTINEL), (wy[..., :c], SENTINEL)], r0, r1, c0, c1)
        dx = (nx[:, :, None] - ox[..., None, None]).to(pair_dtype)
        dy = (ny[:, :, None] - oy[..., None, None]).to(pair_dtype)
        d = torch.sqrt(dx * dx + dy * dy)
        del dx, dy
        v = (p.h - d).clamp_min(0.0)
        vv = v * v
        own = live(ox)
        pairs += int(((d < p.h) & own[..., None, None]).sum())
        del d
        rho[r0:r1, c0:c1, :c] = torch.where(own, p.dnorm * vv.float().sum(-2).sum(-1), 0.0)
        rhon[r0:r1, c0:c1, :c] = torch.where(own, p.nnorm * (vv * v).float().sum(-2).sum(-1),
                                             0.0)
    return rho, rhon, pairs


def forces(wx, wy, P1, NPn, vx, vy, NPo, npx, npy, p: ref.Params, pair_dtype=torch.float32):
    """``reference/sph.py``'s ``forces`` (the window's sums by column pieces,
    then the same frame tail)."""
    h = p.h
    accs = [torch.zeros_like(wx) for _ in range(5)]
    for r0, r1, c, c0, c1 in _pieces(wx):
        sl = (slice(r0, r1), slice(c0, c1), slice(None, c))
        e = lambda t: t[sl][..., None, None]
        nb = _windows([(t[..., :c], f) for t, f in ((wx, SENTINEL), (wy, SENTINEL),
                       (P1, 0.0), (NPn, 0.0), (vx, 0.0), (vy, 0.0))], r0, r1, c0, c1)
        nx, ny, nP1, nNPn, nvx, nvy = (t[:, :, None] for t in nb)
        dx = (nx - e(wx)).to(pair_dtype)
        dy = (ny - e(wy)).to(pair_dtype)
        d2 = dx * dx + dy * dy
        near0 = d2 <= ref.EPS2
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
    vscale = ref.f32_mul(ref.f32_mul(p.vnorm, p.viscosity_strength), p.dt)
    nvx = vx + fx * p.dt + fvx * vscale
    nvy = vy + fy * p.dt + fvy * vscale
    alive = live(npx)
    defer = ~live(wx) & alive
    nvx, nvy = torch.where(defer, vx, nvx), torch.where(defer, vy, nvy)
    x_min, x_max, y_min, y_max = p.bounds
    x2, y2 = npx + (nvx - vx) * p.dt, npy + (nvy - vy) * p.dt
    bx, bvx = ref._bounce(x2, nvx, x_min, x_max, p.damping)
    by, bvy = ref._bounce(y2, nvy, y_min, y_max, p.damping)
    out = (torch.where(alive, bx, SENTINEL), torch.where(alive, by, SENTINEL),
           torch.where(alive, bvx, 0.0), torch.where(alive, bvy, 0.0))
    return out, (x2, y2, nvx, nvy)


def count_pairs(wx, wy, h: float, rows: slice = slice(None)) -> int:
    """``harness/work.py``'s ``count_pairs`` by column pieces: ordered pairs
    of walk-live slots closer than ``h``, of the slots in ``rows``."""
    own_rows = torch.zeros(wx.shape[0], dtype=torch.bool, device=wx.device)
    own_rows[rows] = True
    pairs = 0
    for r0, r1, c, c0, c1 in _pieces(wx):
        if not bool(own_rows[r0:r1].any()):
            continue
        ox, oy = wx[r0:r1, c0:c1, :c], wy[r0:r1, c0:c1, :c]
        nx, ny = _windows([(wx[..., :c], SENTINEL), (wy[..., :c], SENTINEL)], r0, r1, c0, c1)
        dx = nx[:, :, None] - ox[..., None, None]
        dy = ny[:, :, None] - oy[..., None, None]
        own = live(ox) & own_rows[r0:r1, None, None]
        pairs += int(((dx * dx + dy * dy < h * h) & own[..., None, None]).sum())
    return pairs


def step(planes, p: ref.Params, g: ref.Grid, pair_dtype=torch.float32, rebin=rebin,
         defer: bool = True, row0: int = 0) -> dict:
    """``reference/sph.py``'s ``step`` with this module's rebin and walks."""
    npx, npy, nvx0, nvy0, nidsf = rebin(predict(planes, p), g, row0)
    wx, wy = walk_positions(npx, npy, g, row0) if defer else (npx, npy)
    rho, rhon, pairs = density(wx, wy, p, pair_dtype)
    P1, NPo, NPn = pressure_terms(rho, rhon, p)
    del rho, rhon
    (px, py, vx, vy), raw = forces(wx, wy, P1, NPn, nvx0, nvy0, NPo, npx, npy, p, pair_dtype)
    walk_live = int(live(wx).sum())
    return {"planes": [px, py, vx, vy, torch.where(live(npx), nidsf, 0.0)], "raw": raw,
            "density_pairs": pairs, "force_pairs": pairs - walk_live,
            "walk_live": walk_live}
