// K2 (density walk), K3 (fused pressure + viscosity walk with the frame
// tail in its epilogue), K3b (the same walk with the raw-sum epilogue), and
// K6 (the same three walks on the pair-packed layout's planes) over
// [gh, gw, C] cell planes.
//
// Replace rust_particle_system_tpu/ops/pallas/sph.py::_make_seg_kernel with
// _density_update (via density_planes, and with the pressure terms after it
// via density_pressure_planes), with _force_update +
// _force_finalize_integrated (via force_planes_integrated) and with
// _force_update + _force_finalize (via force_planes): n_dx=3 for the classic
// layout (K2, K3, K3b), n_dx=2 for the pair-packed one (K6, driven by
// ops/pallas/sph_step.py:95-153).
//
// What they compute, per own slot i, over the 3x3 neighbour cells j (self
// included; sentinel-parked slots contribute exactly 0 and are skipped):
//   K2   rho = dnorm * sum v^2, rhon = nnorm * sum v^3, v = max(h - d, 0)
//        (sph.py:295-310).  Slots whose walk position is parked get 0.  The
//        same walk with the pressure epilogue writes the force walk's
//        per-slot terms from rho and rhon in registers instead (the port's
//        ops/cuda/sph.py::pressure_terms, op by op, so bit for bit):
//        P1 = alpha p / rho^2, NPo = beta np / rho^2, NPn = beta np / (rho
//        rhon), guarded for empties, with p = (rho - target) * pmult and
//        np = rhon * nmult; parked slots get the terms of rho = rhon = 0.
//   K3   mag = (P1_i + P1_j) v + (NPo_i + NPn_j) v^2 over d = d2 * inv_d, with
//        the eps guard d2 <= eps2 -> inv_d = 0, d = 0, fy += mag (sph.py:
//        333-353); viscosity sum u^3, sum v_j u^3 with u = max(h^2 - d2, 0);
//        then the closed-form self term, the velocity combine, the deferred
//        restore, Euler, the abs-damped bounce and the dead-slot park
//        (sph.py:366-419).  The epilogue runs for every slot, deferred ones
//        included (their walk position is parked while npx is live).
//   K3b  K3's walk and self term with the raw epilogue (sph.py:366-379):
//        (fx, fy - self, Sx - vx S, Sy - vy S).  Slots whose walk position is
//        parked get zero sums (and the self term); the caller's tail restores
//        or parks them.  K3 and K3b are one template over the epilogue.
//   K6   the same three walks on the pair-packed layout's planes (C=64 on
//        the TPU, where two cells filled one 128-lane row and the kernel read
//        the half-shifted units B[p] and B[p+1]: cells 2p-1 .. 2p+2 of rows
//        r-1 .. r+1).  The card has no lanes to fill: K6 launches the strip
//        walk below on those planes.  A strip starts on an even column
//        (kStripCells is even), so it holds whole pairs, and each own cell
//        walks its 3x3 window in the order the pair window gave it (columns
//        left to right, each column's rows r-1 .. r+1, slots in order; the
//        TPU's fourth column is at least a cell width (>= h) away and adds
//        exact zeros).  So K6's outputs are K2's, K3's and K3b's bit for bit
//        on the same planes.
//
// Own rows.  A launch walks the own rows [r0, r0 + R) of neighbour planes of
// gh rows: r0 = 0 and R = gh on the whole grid, or r0 = 1 and R = gh - 2 on a
// band's slab whose rows 0 and gh - 1 are ghost rows of the neighbour bands
// (rust_particle_system_tpu/ops/pallas/sph_step.py::_forces_from_cells with
// its halo, on the band-sharded mesh).  The grid has R block rows, so a ghost
// row costs its staging by the adjacent own row and nothing else.  The
// own-side planes (NPo, npx, npy) and the outputs are [R, gw, C].
//
// Bound on the H100: arithmetic on the pair loop, not memory (the 1M state's
// 3.49e8 live window pairs at ~29 instructions a force pair and about half
// that a density pair; the planes are read about three times).  The TPU
// evaluated all C x 9C slot pairs as dense vector tiles, lane-padded to 128,
// gated by 32-slot chunks.  The walk here stages only the LIVE neighbour
// slots in shared memory (ranked by ballots), so a pair loop runs over the
// live count, not 9C.
//
// The strip walk (K2, K3, K3b, and K6 on the pair-packed planes).  A block
// of kWalkThreads threads serves a strip of kStripCells adjacent own cells of
// one row (fixed here: a strip of 6 holds ~232 live particles at the 1M
// density, one round of 256 threads;
// the launch computes its own shared bytes, and the host checks only C).
// Against what bounded a first design that gave each cell a block of C
// threads, thread s owning slot s:
//   1. Threads map to live particles, not to slots (there, ~70% of a C=128
//      block had no particle at the 1M density and idled while holding its
//      SM slot).  The strip's walk-live own slots are ranked by the window's
//      ballots; thread t walks the t-th, in rounds of kWalkThreads if there
//      are more.  A separate sweep over the strip's slots gives every parked
//      walk slot its epilogue with zero sums, as before.
//   2. Shared memory is bounded by a tile of kWalkTile staged neighbours, not
//      by the 9C window x 6 channels (~28 KB a cell at C=128, which capped an
//      SM at 8 blocks of mostly idle warps): the walk streams the strip's
//      window through the tile, as K8 streams its j tiles.  At the 1M density
//      one tile holds a round's window.  The footprint is 1024 x 24 B (K3) or
//      1024 x 8 B (K2) plus 8 B per 32-slot chunk of the window: 25.4 KB (K3)
//      and 9.0 KB (K2) at C=128, at most 30.8 KB at C=1024.  So registers, not
//      shared memory, set how many blocks an SM holds.  The launch bounds ask
//      for 3 (24 warps): at 4, K3's registers are capped at 64 and it spills.
//   3. The 3 x (W+2) window is counted once: one warp ballot per 32-slot
//      chunk, then one scan over the chunks' counts (no chain of nine
//      block-wide counts).  It is ordered column-major (column outer, row
//      inner, as the TPU's pair window orders its 3x4), so own cell k's 3x3
//      window is the contiguous range [col[k], col[k + 3]).  Each neighbour cell is
//      staged by 3 row blocks (plus the strips' edge columns), not 9.
//   4. Staged neighbours are packed: (px, py, P1, NPn) as a float4 and
//      (vx, vy) as a float2 (K3), (px, py) as a float2 (K2), so a force pair
//      reads shared memory twice, not six times.  Lanes of one cell read one
//      address (a broadcast).
// A slot sums its window in one order (its columns left to right, each
// column's rows r-1 .. r+1, slots in order), whatever strip, round or tile it
// falls in, so the band-sharded step gives the single-device step's planes
// bit for bit.
//
// Arithmetic, held to the same bars as before: the force walk's 1/d is the
// SFU's reciprocal square root (rsqrtf's bits wherever it is taken), as JAX's
// walk (lax.rsqrt) and the plain version (torch.rsqrt) form it, in place of a
// correctly rounded 1.0f / sqrtf.  The density walk keeps the correctly
// rounded sqrtf.  nvcc contracts a * b + c into fused multiply-adds (its
// default, as XLA does on the CPU); the plain version does not, so the two
// differ by rounding only.

#include "common.cuh"

namespace {

using rps::kLiveBelow;

// ---------------------------------------------------------------------------
// The pair bodies and the force epilogue.

struct ForceScalars {
  float h, eps2, dt, vscale, x_min, x_max, y_min, y_max, damp;
};

// The SFU's reciprocal square root (MUFU.RSQ) with sub-normal inputs flushed
// to zero: no fix-up instructions around it.  The force walk takes it only
// where d2 > eps2, far above FLT_MIN, where rsqrtf gives the same bits.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One density pair: s2 += v^2, s3 += v^3, v = max(h - d, 0).
__device__ __forceinline__ void density_pair(float ox, float oy, float nx, float ny,
                                             float h, float& s2, float& s3) {
  const float dx = nx - ox, dy = ny - oy;
  const float d = sqrtf(dx * dx + dy * dy);
  const float v = fmaxf(h - d, 0.0f);
  const float vv = v * v;
  s2 += vv;
  s3 += vv * v;
}

struct ForceOwn {
  float x, y, P1, NPo;
};

struct ForceSums {
  float fx, fy, S, Sx, Sy;
};

// One force pair against neighbour (x, y, P1, NPn) with velocity (vx, vy).
__device__ __forceinline__ void force_pair(const ForceOwn& o, float4 n, float2 nv, float h,
                                           float hh, float eps2, ForceSums& a) {
  const float dx = n.x - o.x, dy = n.y - o.y;
  const float d2 = dx * dx + dy * dy;
  const bool near0 = d2 <= eps2;
  const float inv_d = near0 ? 0.0f : rsqrt_approx(d2);
  const float d = d2 * inv_d;
  const float v = fmaxf(h - d, 0.0f);
  const float vv = v * v;
  const float mag = (o.P1 + n.z) * v + (o.NPo + n.w) * vv;
  const float mm = mag * inv_d;
  const float u = fmaxf(hh - d2, 0.0f);
  const float u3 = u * u * u;
  a.fx += dx * mm;
  a.fy += dy * mm;
  if (near0) a.fy += mag;  // the (0, 1) direction fallback (mm = 0 there)
  a.S += u3;
  a.Sx += nv.x * u3;
  a.Sy += nv.y * u3;
}

// The force walk's planes: the walk side [gh, gw, C], the own side and the
// outputs [R, gw, C] (npx, npy: K3 only; out = (px, py, vx, vy) for K3,
// (fx, fy, fvx, fvy) for K3b).
struct ForcePlanes {
  const float* px;
  const float* py;
  const float* P1;
  const float* NPn;
  const float* vx;
  const float* vy;
  const float* NPo;
  const float* npx;
  const float* npy;
  float* out0;
  float* out1;
  float* out2;
  float* out3;
};

__device__ __forceinline__ void bounce(float& x, float& v, float lo, float hi, float damp) {
  v = (x <= lo) ? fabsf(v) * damp : v;
  v = (x >= hi) ? -fabsf(v) * damp : v;
  x = fminf(fmaxf(x, lo), hi);
}

// The epilogue of own slot (o on the walk side, q on the own side) from its
// sums, which are zero for a slot whose walk position is parked.
template <bool kTail>
__device__ __forceinline__ void force_epilogue(const ForcePlanes& p, const ForceScalars& k,
                                               ForceSums a, bool walk_live, size_t o,
                                               size_t q) {
  const float oP1 = __ldg(p.P1 + o), oNPn = __ldg(p.NPn + o), oNPo = __ldg(p.NPo + q);
  const float ovx = __ldg(p.vx + o), ovy = __ldg(p.vy + o);
  const float hh = k.h * k.h;
  // Self pair (d = 0, fy fallback) removed in closed form; viscosity combine.
  a.fy -= (oP1 + oP1) * k.h + (oNPo + oNPn) * hh;
  const float fvx = a.Sx - ovx * a.S, fvy = a.Sy - ovy * a.S;
  if constexpr (!kTail) {
    p.out0[q] = a.fx;
    p.out1[q] = a.fy;
    p.out2[q] = fvx;
    p.out3[q] = fvy;
    return;
  }
  const float onpx = __ldg(p.npx + q), onpy = __ldg(p.npy + q);
  float nvx = ovx + a.fx * k.dt + fvx * k.vscale;
  float nvy = ovy + a.fy * k.dt + fvy * k.vscale;
  const bool live = onpx < kLiveBelow;
  if (!walk_live && live) {  // deferred: keep the post-gravity velocity
    nvx = ovx;
    nvy = ovy;
  }
  float x2 = onpx + (nvx - ovx) * k.dt;
  float y2 = onpy + (nvy - ovy) * k.dt;
  bounce(x2, nvx, k.x_min, k.x_max, k.damp);
  bounce(y2, nvy, k.y_min, k.y_max, k.damp);
  p.out0[q] = live ? x2 : rps::kSentinel;
  p.out1[q] = live ? y2 : rps::kSentinel;
  p.out2[q] = live ? nvx : 0.0f;
  p.out3[q] = live ? nvy : 0.0f;
}

// ---------------------------------------------------------------------------
// The strip walk.

constexpr int kStripCells = 6;    // W: own cells a block serves (even: whole pairs for K6)
constexpr int kWalkThreads = 256;  // threads a block
constexpr int kWalkTile = 1024;    // staged neighbours a tile holds
constexpr int kMaxC = 1024;        // the largest C the strip walks take

// Shared bytes of a strip block at C slots a cell: the tile of staged
// neighbours of `entry` bytes, a ballot and an offset per 32-slot chunk of
// the 3 x (W + 2) window (plus the window's total), and the W + 1 own-rank
// offsets (4 bytes each).
constexpr size_t strip_shmem(size_t entry, size_t C) {
  return kWalkTile * entry + 4 * (2 * 3 * (kStripCells + 2) * ((C + 31) / 32) + kStripCells + 2);
}
static_assert(strip_shmem(24, kMaxC) <= 232448, "a strip block fits one H100 block's shared memory");
static_assert(kStripCells % 2 == 0, "a strip holds whole cell pairs (K6)");

// The strip's geometry and its shared arrays (W = kStripCells).
struct Strip {
  int gh, gw, C, r, r0, c0, nchunk, nchk;
  const unsigned* ballot;  // [nchk] live bits of window chunk q, column-major
  const int* off;          // [nchk + 1] chunk q's first rank in the window
  const int* own;          // [W + 1] own cell k's first walk-live rank

  // Walk-side offset of lane `lane` of window chunk q; false if that slot is
  // outside the grid or past C.
  __device__ bool slot(int q, int lane, size_t* o) const {
    const int cell = q / nchunk, col = cell / 3;
    const int rr = r - 1 + (cell - 3 * col), cc = c0 - 1 + col;
    const int s = (q - cell * nchunk) * 32 + lane;
    *o = (static_cast<size_t>(rr) * gw + cc) * C + s;
    return rr >= 0 && rr < gh && cc >= 0 && cc < gw && s < C;
  }
  // First chunk of window column k (k = 0 .. W + 2; W + 2 ends the window).
  __device__ int column(int k) const { return 3 * k * nchunk; }
  // First chunk of own cell k (window column k + 1, middle row).
  __device__ int own_chunk(int k) const { return (3 * (k + 1) + 1) * nchunk; }
  // The own cell of walk-live rank i.
  __device__ int own_cell(int i) const {
    int k = 0;
    while (k + 1 < kStripCells && own[k + 1] <= i) ++k;
    return k;
  }
  // The slot of own cell k that is its j-th walk-live one.
  __device__ int nth_live(int k, int j) const {
    const unsigned* b = ballot + own_chunk(k);
    int ch = 0;
    for (int pc = __popc(b[0]); j >= pc; pc = __popc(b[++ch])) j -= pc;
    unsigned m = b[ch];
    for (; j > 0; --j) m &= m - 1;
    return ch * 32 + __ffs(m) - 1;
  }
  __device__ size_t walk_offset(int k, int s) const {
    return (static_cast<size_t>(r) * gw + c0 + k) * C + s;
  }
  __device__ size_t own_offset(int k, int s) const {
    return (static_cast<size_t>(r - r0) * gw + c0 + k) * C + s;
  }
};

// Ballots, ranks and own ranks of the block's window into shared memory.
// Every thread of the block must call it.
__device__ Strip count_window(const float* __restrict__ px, unsigned char* scratch, int gh,
                              int r0, int gw, int C) {
  Strip st;
  st.gh = gh;
  st.gw = gw;
  st.C = C;
  st.r0 = r0;
  st.r = r0 + blockIdx.y;
  st.c0 = blockIdx.x * kStripCells;
  st.nchunk = (C + 31) / 32;
  st.nchk = 3 * (kStripCells + 2) * st.nchunk;
  unsigned* ballot = reinterpret_cast<unsigned*>(scratch);
  int* off = reinterpret_cast<int*>(ballot + st.nchk);
  int* own = off + st.nchk + 1;
  st.ballot = ballot;
  st.off = off;
  st.own = own;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = kWalkThreads / 32;
  // One ballot per chunk, four chunks' loads in flight per warp.
  for (int q0 = warp; q0 < st.nchk; q0 += 4 * nwarps) {
    bool live[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      size_t o;
      const int q = q0 + u * nwarps;
      live[u] = q < st.nchk && st.slot(q, lane, &o) && __ldg(px + o) < kLiveBelow;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * nwarps;  // warp-uniform
      const unsigned b = __ballot_sync(0xffffffffu, live[u]);
      if (lane == 0 && q < st.nchk) ballot[q] = b;
    }
  }
  __syncthreads();
  // One exclusive scan of the chunk counts (warp 0, a run of chunks a lane),
  // then the own cells' rank offsets.
  if (warp == 0) {
    const int per = (st.nchk + 31) / 32;
    const int q0 = lane * per, q1 = min(q0 + per, st.nchk);
    int sum = 0;
    for (int q = q0; q < q1; ++q) sum += __popc(ballot[q]);
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    int run = incl - sum;
    for (int q = q0; q < q1; ++q) {
      off[q] = run;
      run += __popc(ballot[q]);
    }
    if (lane == 31) off[st.nchk] = incl;
    __syncwarp();
    if (lane == 0) {
      int n = 0;
      for (int k = 0; k < kStripCells; ++k) {
        own[k] = n;
        const int q = st.own_chunk(k);
        n += off[q + st.nchunk] - off[q];
      }
      own[kStripCells] = n;
    }
  }
  __syncthreads();
  return st;
}

// Stage the window's ranks [t0, t1) into tile entries 0 .. t1 - t0, from
// the chunks [qa, qb), four chunks' loads in flight per warp.
template <class Walk>
__device__ void stage_tile(const Walk& w, const Strip& st, unsigned char* tile, int qa, int qb,
                           int t0, int t1) {
  const int lane = threadIdx.x & 31;
  constexpr int nwarps = kWalkThreads / 32;
  const unsigned below = (1u << lane) - 1u;
  for (int q0 = qa + (threadIdx.x >> 5); q0 < qb; q0 += 4 * nwarps) {
    typename Walk::Entry v[4];
    int e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * nwarps;
      e[u] = -1;
      if (q < qb) {
        const unsigned b = st.ballot[q];
        const int x = st.off[q] + __popc(b & below);
        size_t o;
        if (((b >> lane) & 1u) && x >= t0 && x < t1 && st.slot(q, lane, &o)) {
          e[u] = x - t0;
          v[u] = w.load(o);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e[u] >= 0) w.store(tile, e[u], v[u]);
  }
}

// The strip walk of policy Walk (DensityWalk<kPressure>, ForceWalk<kTail>): block
// (x, y) serves own cells x W .. x W + W - 1 (those inside the grid) of own
// row r0 + y, W = kStripCells.
template <class Walk>
__global__ void __launch_bounds__(kWalkThreads, 3)
    strip_walk(Walk w, int gh, int r0, int gw, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tile = smem;
  constexpr int nt = kWalkThreads;
  const Strip st = count_window(w.x_plane(), smem + kWalkTile * Walk::kEntry, gh, r0, gw, C);

  // Parked walk slots of the strip's own cells: the epilogue with zero sums,
  // whose values a thread forms once (the pressure terms of zero sums take
  // two divisions).
  const int n_cells = min(kStripCells, gw - st.c0);
  const typename Walk::Park park = w.park();
  for (int t = threadIdx.x; t < n_cells * C; t += nt) {
    const int k = t / C, s = t - k * C;
    if (!((st.ballot[st.own_chunk(k) + s / 32] >> (s & 31)) & 1u))
      w.parked(park, st.walk_offset(k, s), st.own_offset(k, s));
  }

  // Walk-live own slots, in rounds of kWalkThreads; each round streams the
  // window columns its cells need through the tile.
  const int n_own = st.own[kStripCells];
  for (int base = 0; base < n_own; base += nt) {
    const int i = base + threadIdx.x;
    const bool has = i < n_own;
    const int kf = st.own_cell(base), kl = st.own_cell(min(base + nt, n_own) - 1);
    const int qa = st.column(kf), qb = st.column(kl + 3);
    const int rlo = st.off[qa], rhi = st.off[qb];
    int k = kf, lo = 0, hi = 0;
    size_t o = 0, q = 0;
    typename Walk::Acc acc{};
    if (has) {
      k = st.own_cell(i);
      const int s = st.nth_live(k, i - st.own[k]);
      o = st.walk_offset(k, s);
      q = st.own_offset(k, s);
      lo = st.off[st.column(k)];
      hi = st.off[st.column(k + 3)];
      acc = w.start(o, q);
    }
    for (int t0 = rlo; t0 < rhi; t0 += kWalkTile) {
      const int t1 = min(t0 + kWalkTile, rhi);
      __syncthreads();  // the previous tile has been read
      stage_tile(w, st, tile, qa, qb, t0, t1);
      __syncthreads();
      if (has) w.pairs(acc, tile, max(lo, t0) - t0, min(hi, t1) - t0);
    }
    if (has) w.finish(acc, o, q);
  }
}

// The pressure epilogue's scalars: the target density, the two multipliers,
// and alpha = -2 dnorm, beta = -3 nnorm as the host forms them in f32.
struct PressureScalars {
  float target, pmult, nmult, alpha, beta;
};

// pressure_terms of one slot, rounded op by op in torch's order (-O3 would
// contract dnorm * s2 - target and the products into fused multiply-adds).
__device__ __forceinline__ void pressure_terms(float rho, float rhon, const PressureScalars& k,
                                               float& P1, float& NPo, float& NPn) {
  const float rho_safe = rho > 0.0f ? rho : 1.0f;
  const float rhon_safe = rhon > 0.0f ? rhon : 1.0f;
  const float inv_rho2 = __fdiv_rn(1.0f, __fmul_rn(rho_safe, rho_safe));
  const float p = __fmul_rn(__fsub_rn(rho, k.target), k.pmult);
  const float np = __fmul_rn(rhon, k.nmult);
  P1 = __fmul_rn(k.alpha, __fmul_rn(p, inv_rho2));
  NPo = __fmul_rn(k.beta, __fmul_rn(np, inv_rho2));
  NPn = __fmul_rn(k.beta, __fdiv_rn(np, __fmul_rn(rho_safe, rhon_safe)));
}

// The density walk; out = (rho, rhon), or with kPressure (P1, NPo, NPn).
template <bool kPressure>
struct DensityWalk {
  const float* px;
  const float* py;
  float* out0;
  float* out1;
  float* out2;
  float h, dnorm, nnorm;
  PressureScalars k;

  using Entry = float2;
  static constexpr int kEntry = sizeof(float2);
  struct Acc {
    float x, y, s2, s3;
  };
  __device__ const float* x_plane() const { return px; }
  __device__ Entry load(size_t o) const { return make_float2(__ldg(px + o), __ldg(py + o)); }
  __device__ void store(unsigned char* tile, int e, Entry v) const {
    reinterpret_cast<float2*>(tile)[e] = v;
  }
  __device__ void write(float rho, float rhon, size_t q) const {
    if constexpr (kPressure) {
      pressure_terms(rho, rhon, k, out0[q], out1[q], out2[q]);
    } else {
      out0[q] = rho;
      out1[q] = rhon;
    }
  }
  struct Park {  // the outputs of zero sums
    float a, b, c;
  };
  __device__ Park park() const {
    Park v{0.0f, 0.0f, 0.0f};
    if constexpr (kPressure) pressure_terms(0.0f, 0.0f, k, v.a, v.b, v.c);
    return v;
  }
  __device__ void parked(const Park& v, size_t, size_t q) const {
    out0[q] = v.a;
    out1[q] = v.b;
    if constexpr (kPressure) out2[q] = v.c;
  }
  __device__ Acc start(size_t o, size_t) const {
    return {__ldg(px + o), __ldg(py + o), 0.0f, 0.0f};
  }
  __device__ void pairs(Acc& a, const unsigned char* tile, int j0, int j1) const {
    const float2* t = reinterpret_cast<const float2*>(tile);
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float2 n = t[j];
      density_pair(a.x, a.y, n.x, n.y, h, a.s2, a.s3);
    }
  }
  __device__ void finish(const Acc& a, size_t, size_t q) const {
    write(__fmul_rn(dnorm, a.s2), __fmul_rn(nnorm, a.s3), q);
  }
};

template <bool kTail>
struct ForceWalk {
  ForcePlanes p;
  ForceScalars k;

  // (px, py, P1, NPn) as a float4 at tile[e], (vx, vy) as a float2 past the
  // tile's kWalkTile float4s.
  struct Entry {
    float4 a;
    float2 v;
  };
  static constexpr int kEntry = sizeof(float4) + sizeof(float2);
  struct Acc {
    ForceOwn own;
    ForceSums sums;
  };
  __device__ const float* x_plane() const { return p.px; }
  __device__ Entry load(size_t o) const {
    return {make_float4(__ldg(p.px + o), __ldg(p.py + o), __ldg(p.P1 + o), __ldg(p.NPn + o)),
            make_float2(__ldg(p.vx + o), __ldg(p.vy + o))};
  }
  __device__ void store(unsigned char* tile, int e, const Entry& v) const {
    reinterpret_cast<float4*>(tile)[e] = v.a;
    reinterpret_cast<float2*>(tile + sizeof(float4) * kWalkTile)[e] = v.v;
  }
  using Park = ForceSums;  // zero sums; the epilogue reads the slot's own planes
  __device__ Park park() const { return ForceSums{}; }
  __device__ void parked(const Park& zero, size_t o, size_t q) const {
    force_epilogue<kTail>(p, k, zero, false, o, q);
  }
  __device__ Acc start(size_t o, size_t q) const {
    return {{__ldg(p.px + o), __ldg(p.py + o), __ldg(p.P1 + o), __ldg(p.NPo + q)}, {}};
  }
  __device__ void pairs(Acc& a, const unsigned char* tile, int j0, int j1) const {
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    const float2* t2 = reinterpret_cast<const float2*>(tile + sizeof(float4) * kWalkTile);
    const float hh = k.h * k.h;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) force_pair(a.own, t4[j], t2[j], k.h, hh, k.eps2, a.sums);
  }
  __device__ void finish(const Acc& a, size_t o, size_t q) const {
    force_epilogue<kTail>(p, k, a.sums, true, o, q);
  }
};

cudaError_t set_shmem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Own rows [r0, r0 + R) of [gh, gw, C] planes: ceil(gw / W) strips a row.
template <class Walk>
cudaError_t launch_strips(const Walk& w, int gh, int r0, int R, int gw, int C, void* stream) {
  if (C < 1 || C > kMaxC || r0 < 0 || R < 1 || r0 + R > gh || gw < 1)
    return cudaErrorInvalidValue;
  const size_t shmem = strip_shmem(Walk::kEntry, C);
  cudaError_t err = set_shmem(reinterpret_cast<const void*>(strip_walk<Walk>), shmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((gw + kStripCells - 1) / kStripCells, R);
  strip_walk<Walk><<<grid, kWalkThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      w, gh, r0, gw, C);
  return cudaGetLastError();
}

}  // namespace

// Each entry takes its arguments as the record struct rps_<entry>_args
// (common.cuh, rps::unpack).

// Neighbour planes [gh, gw, C] f32, own rows [r0, r0 + R); own-side planes
// and outputs [R, gw, C].  rho/rhon: outputs (0 at parked walk slots).
struct rps_density_args {
  const float* px;
  const float* py;
  float* rho;
  float* rhon;
  int gh, r0, R, gw, C;
  float h, dnorm, nnorm;
  void* stream;
};

extern "C" int rps_density(const void* packed, int size) {
  rps_density_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  const DensityWalk<false> w{a.px, a.py, a.rho, a.rhon, nullptr, a.h, a.dnorm, a.nnorm, {}};
  return static_cast<int>(launch_strips(w, a.gh, a.r0, a.R, a.gw, a.C, a.stream));
}

// The density walk with the pressure epilogue: the same planes and walk
// scalars, then target, pmult, nmult, alpha, beta.  P1/NPo/NPn: outputs.
struct rps_density_pressure_args {
  const float* px;
  const float* py;
  float* P1;
  float* NPo;
  float* NPn;
  int gh, r0, R, gw, C;
  float h, dnorm, nnorm, target, pmult, nmult, alpha, beta;
  void* stream;
};

extern "C" int rps_density_pressure(const void* packed, int size) {
  rps_density_pressure_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  const DensityWalk<true> w{a.px,    a.py,    a.P1,    a.NPo,
                            a.NPn,   a.h,     a.dnorm, a.nnorm,
                            {a.target, a.pmult, a.nmult, a.alpha, a.beta}};
  return static_cast<int>(launch_strips(w, a.gh, a.r0, a.R, a.gw, a.C, a.stream));
}

// Walk planes px/py (deferred slots parked), P1/NPn/vx/vy; own-only NPo and the
// true predicted positions npx/npy.  Outputs: the final px, py, vx, vy planes.
struct rps_force_integrated_args {
  const float* px;
  const float* py;
  const float* P1;
  const float* NPn;
  const float* vx;
  const float* vy;
  const float* NPo;
  const float* npx;
  const float* npy;
  float* out_px;
  float* out_py;
  float* out_vx;
  float* out_vy;
  int gh, r0, R, gw, C;
  float h, eps2, dt, vscale, x_min, x_max, y_min, y_max, damp;
  void* stream;
};

extern "C" int rps_force_integrated(const void* packed, int size) {
  rps_force_integrated_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  const ForcePlanes p{a.px, a.py, a.P1, a.NPn, a.vx, a.vy, a.NPo, a.npx, a.npy,
                      a.out_px, a.out_py, a.out_vx, a.out_vy};
  const ForceScalars k{a.h, a.eps2, a.dt, a.vscale, a.x_min, a.x_max, a.y_min, a.y_max, a.damp};
  return static_cast<int>(
      launch_strips(ForceWalk<true>{p, k}, a.gh, a.r0, a.R, a.gw, a.C, a.stream));
}

// K3b: the same inputs without npx/npy.  Outputs: the raw fx, fy, fvx, fvy.
struct rps_force_args {
  const float* px;
  const float* py;
  const float* P1;
  const float* NPn;
  const float* vx;
  const float* vy;
  const float* NPo;
  float* fx;
  float* fy;
  float* fvx;
  float* fvy;
  int gh, r0, R, gw, C;
  float h, eps2;
  void* stream;
};

extern "C" int rps_force(const void* packed, int size) {
  rps_force_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  const ForcePlanes p{a.px, a.py, a.P1, a.NPn, a.vx, a.vy, a.NPo, nullptr, nullptr,
                      a.fx, a.fy, a.fvx, a.fvy};
  const ForceScalars k{a.h, a.eps2, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  return static_cast<int>(
      launch_strips(ForceWalk<false>{p, k}, a.gh, a.r0, a.R, a.gw, a.C, a.stream));
}

// K6: the density walk (both epilogues), fused and raw walks on the
// pair-packed layout's planes: the strip walks above, on the same records.
using rps_pair_density_args = rps_density_args;
using rps_pair_density_pressure_args = rps_density_pressure_args;
using rps_pair_force_integrated_args = rps_force_integrated_args;
using rps_pair_force_args = rps_force_args;

extern "C" int rps_pair_density(const void* packed, int size) {
  return rps_density(packed, size);
}

extern "C" int rps_pair_density_pressure(const void* packed, int size) {
  return rps_density_pressure(packed, size);
}

extern "C" int rps_pair_force_integrated(const void* packed, int size) {
  return rps_force_integrated(packed, size);
}

extern "C" int rps_pair_force(const void* packed, int size) {
  return rps_force(packed, size);
}
