// K2 (density walk), K3 (fused pressure + viscosity walk with the frame
// tail in its epilogue), K3b (the same walk with the raw-sum epilogue), and
// K6 (the same three walks in the pair-packed block shape) over [gh, gw, C]
// cell planes.
//
// Replace rust_particle_system_tpu/ops/pallas/sph.py::_make_seg_kernel with
// _density_update (via density_planes), with _force_update +
// _force_finalize_integrated (via force_planes_integrated) and with
// _force_update + _force_finalize (via force_planes): n_dx=3 for the classic
// layout (K2, K3, K3b), n_dx=2 for the pair-packed one (K6, driven by
// ops/pallas/sph_step.py:95-153).
//
// What they compute, per own slot i, over the 3x3 neighbour cells j (self
// included; sentinel-parked slots contribute exactly 0 and are skipped):
//   K2   rho = dnorm * sum v^2, rhon = nnorm * sum v^3, v = max(h - d, 0)
//        (sph.py:295-310).  Slots whose walk position is parked get 0.
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
//   K6   the same outputs, in the same [gh, gw, C] planes, from blocks that
//        each serve a PAIR of cells (2p, 2p+1) of one row.  The TPU packed the
//        pair into one 128-lane row and read the half-shifted units B[p] and
//        B[p+1] (cells 2p-1 .. 2p+2, rows r-1 .. r+1): 6 neighbour tiles per own
//        tile instead of 9.  Here the block stages the live slots of that 3x4
//        window once, column by column, so that each own cell's 3x3 window is
//        one contiguous range of it: cell 2p walks columns 2p-1 .. 2p+1, cell
//        2p+1 walks 2p .. 2p+2.  The TPU also walked the fourth column; those
//        cells are at least a cell width (>= h) away, so they add exact zeros,
//        and skipping them keeps the pair count equal to the classic walk's
//        (a third fewer than the full window).  Each neighbour cell is staged
//        by 6 blocks instead of 9.
//
// Own rows.  A launch walks the own rows [r0, r0 + R) of neighbour planes of
// gh rows: r0 = 0 and R = gh on the whole grid, or r0 = 1 and R = gh - 2 on a
// band's slab whose rows 0 and gh - 1 are ghost rows of the neighbour bands
// (rust_particle_system_tpu/ops/pallas/sph_step.py::_forces_from_cells with
// its halo, on the band-sharded mesh).  The grid has R block rows, so a ghost
// row costs its staging by the adjacent own row and nothing else.  The
// own-side planes (NPo, npx, npy) and the outputs are [R, gw, C].
//
// Bound on the H100: arithmetic on the pair loop (one sqrt and one divide per
// pair in K3), not memory: each block reads its neighbour cells once.  The
// TPU evaluated all C x 9C slot pairs as dense vector tiles, lane-padded to
// 128, gated by 32-slot chunks.  Here a block stages only the LIVE neighbour
// slots in shared memory (compacted with ballots), so the pair loop runs over
// the live count, not 9C, and threads of dead own slots skip it.  Every thread
// of an own cell reads the same staged neighbour at a time: a shared-memory
// broadcast.  1.0f / sqrtf is used, not rsqrtf, which is not correctly
// rounded.  nvcc contracts a * b + c into fused multiply-adds (its default, as
// XLA does on the CPU); the plain version does not, so the two differ by
// rounding only.

#include "common.cuh"

namespace {

using rps::kLiveBelow;

// Stage the live slots of the in-grid 3x3 neighbours of (r, c) into shared
// arrays dst[ch][0..m), cell order (dy, dx) row-major, slot order within a
// cell.  Returns m.  Every thread of the block must call it.
template <int NCH>
__device__ int stage_live_neighbours(const float* const (&src)[NCH],
                                     float* const (&dst)[NCH], int* scratch,
                                     int r, int c, int gh, int gw, int C) {
  const int s = threadIdx.x;
  int m = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int rr = r + dy, cc = c + dx;
      if (rr < 0 || rr >= gh || cc < 0 || cc >= gw) continue;  // block-uniform
      const size_t o = (static_cast<size_t>(rr) * gw + cc) * C + s;
      const bool live = s < C && src[0][o] < kLiveBelow;
      const bool p[1] = {live};
      int inc[1], tot[1];
      rps::block_count<1>(p, inc, tot, scratch);
      if (live) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) dst[ch][m + inc[0] - 1] = src[ch][o];
      }
      m += tot[0];
    }
  }
  __syncthreads();
  return m;
}

// A thread's own slot and the staged neighbour range it walks.
struct Own {
  size_t o;     // own slot offset in the neighbour planes
  size_t q;     // own slot offset in the own-side planes and the outputs
  int lo, hi;   // staged neighbours [lo, hi)
  bool valid;   // the thread owns a slot of an in-grid cell
};

// Plane row, offsets and validity of a thread's slot s of cell (r, c).
__device__ __forceinline__ Own own_slot(int r, int r0, int c, int s, int gw, int C,
                                        int lo, int hi, bool valid) {
  return {(static_cast<size_t>(r) * gw + c) * C + s,
          (static_cast<size_t>(r - r0) * gw + c) * C + s, lo, hi, valid};
}

// Cells a block stages: its 3x3 window, or a pair's 3x4 window.
template <bool kPair>
constexpr int kWindowCells = kPair ? 12 : 9;

// Classic block: cell (r, c) = (r0 + blockIdx.y, blockIdx.x), thread s owns
// slot s.
template <int NCH>
__device__ Own stage_cell(const float* const (&src)[NCH], float* const (&dst)[NCH],
                          int* scratch, int gh, int r0, int gw, int C) {
  const int c = blockIdx.x, r = r0 + blockIdx.y, s = threadIdx.x;
  const int m = stage_live_neighbours<NCH>(src, dst, scratch, r, c, gh, gw, C);
  return own_slot(r, r0, c, s, gw, C, 0, m, s < C);
}

// Pair block (K6): cells (r, 2p) and (r, 2p + 1), p = blockIdx.x and
// r = r0 + blockIdx.y; thread t
// owns slot t % C of cell 2p + t / C (t >= 2C: ballots only).  The live slots
// of columns 2p-1 .. 2p+2, rows r-1 .. r+1 are staged column-major (column
// outer, row inner), two cells per round; col[k] is where window column k
// starts, so cell 2p + h's 3x3 window is the range [col[h], col[h + 3]).
// An odd gw leaves the last pair's second cell out of the grid: it is staged
// as empty and owns nothing, like the TPU's dead phantom cell.
template <int NCH>
__device__ Own stage_pair(const float* const (&src)[NCH], float* const (&dst)[NCH],
                          int* scratch, int gh, int r0, int gw, int C) {
  const int p = blockIdx.x, r = r0 + blockIdx.y, t = threadIdx.x;
  const int half = t / C, s = t - half * C;
  int col[5];
  col[0] = 0;
  int m = 0;
  for (int k = 0; k < 12; k += 2) {
    const int cell = k + half;  // window cell this thread loads this round
    const int rr = r - 1 + cell % 3, cc = 2 * p - 1 + cell / 3;
    bool live = false;
    size_t o = 0;
    if (half < 2 && rr >= 0 && rr < gh && cc >= 0 && cc < gw) {
      o = (static_cast<size_t>(rr) * gw + cc) * C + s;
      live = src[0][o] < kLiveBelow;
    }
    // Threads of cell k precede those of cell k + 1, so one block-wide
    // prefix places both cells; the second count splits them.
    const bool pr[2] = {live, live && half == 0};
    int inc[2], tot[2];
    rps::block_count<2>(pr, inc, tot, scratch);
    if (live) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) dst[ch][m + inc[0] - 1] = src[ch][o];
    }
    if (k % 3 == 2) col[k / 3 + 1] = m + tot[1];  // cell k ends a column
    if (k % 3 == 1) col[k / 3 + 1] = m + tot[0];  // cell k + 1 ends a column
    m += tot[0];
  }
  __syncthreads();
  const int own = half < 2 ? half : 1;
  const int c = 2 * p + own;
  return own_slot(r, r0, c, s, gw, C, col[own], col[own + 3], half < 2 && c < gw);
}

template <bool kPair, int NCH>
__device__ Own stage(const float* const (&src)[NCH], float* const (&dst)[NCH],
                     int* scratch, int gh, int r0, int gw, int C) {
  if constexpr (kPair) {
    return stage_pair<NCH>(src, dst, scratch, gh, r0, gw, C);
  } else {
    return stage_cell<NCH>(src, dst, scratch, gh, r0, gw, C);
  }
}

template <bool kPair>
__global__ void density_kernel(const float* __restrict__ px, const float* __restrict__ py,
                               float* __restrict__ rho, float* __restrict__ rhon,
                               int gh, int r0, int gw, int C, float h, float dnorm,
                               float nnorm) {
  extern __shared__ float sm[];
  const int cap = kWindowCells<kPair> * C;
  float* const dst[2] = {sm, sm + cap};
  int* scratch = reinterpret_cast<int*>(sm + 2 * cap);
  const float* const src[2] = {px, py};
  const Own w = stage<kPair, 2>(src, dst, scratch, gh, r0, gw, C);
  if (!w.valid) return;

  const size_t o = w.o, q = w.q;
  const float ox = px[o], oy = py[o];
  if (!(ox < kLiveBelow)) {
    rho[q] = 0.0f;
    rhon[q] = 0.0f;
    return;
  }
  const float* sx = dst[0];
  const float* sy = dst[1];
  float s2 = 0.0f, s3 = 0.0f;
  for (int j = w.lo; j < w.hi; ++j) {
    const float dx = sx[j] - ox, dy = sy[j] - oy;
    const float d = sqrtf(dx * dx + dy * dy);
    const float v = fmaxf(h - d, 0.0f);
    const float vv = v * v;
    s2 += vv;
    s3 += vv * v;
  }
  rho[q] = dnorm * s2;
  rhon[q] = nnorm * s3;
}

struct ForceScalars {
  float h, eps2, dt, vscale, x_min, x_max, y_min, y_max, damp;
};

__device__ __forceinline__ void bounce(float& x, float& v, float lo, float hi,
                                       float damp) {
  v = (x <= lo) ? fabsf(v) * damp : v;
  v = (x >= hi) ? -fabsf(v) * damp : v;
  x = fminf(fmaxf(x, lo), hi);
}

template <bool kPair, bool kTail>
__global__ void force_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ P1, const float* __restrict__ NPn,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ NPo, const float* __restrict__ npx,
    const float* __restrict__ npy, float* __restrict__ out_px,
    float* __restrict__ out_py, float* __restrict__ out_vx,
    float* __restrict__ out_vy, int gh, int r0, int gw, int C, ForceScalars k) {
  extern __shared__ float sm[];
  const int cap = kWindowCells<kPair> * C;
  float* const dst[6] = {sm, sm + cap, sm + 2 * cap, sm + 3 * cap,
                         sm + 4 * cap, sm + 5 * cap};
  int* scratch = reinterpret_cast<int*>(sm + 6 * cap);
  const float* const src[6] = {px, py, P1, NPn, vx, vy};
  const Own w = stage<kPair, 6>(src, dst, scratch, gh, r0, gw, C);
  if (!w.valid) return;

  const size_t o = w.o, q = w.q;
  const float ox = px[o], oy = py[o], oP1 = P1[o], oNPn = NPn[o];
  const float ovx = vx[o], ovy = vy[o], oNPo = NPo[q];
  const float hh = k.h * k.h;
  const bool walk_live = ox < kLiveBelow;

  float fx = 0.0f, fy = 0.0f, S = 0.0f, Sx = 0.0f, Sy = 0.0f;
  if (walk_live) {
    const float *sx = dst[0], *sy = dst[1], *sP1 = dst[2], *sNPn = dst[3];
    const float *svx = dst[4], *svy = dst[5];
    for (int j = w.lo; j < w.hi; ++j) {
      const float dx = sx[j] - ox, dy = sy[j] - oy;
      const float d2 = dx * dx + dy * dy;
      const bool near0 = d2 <= k.eps2;
      const float inv_d = near0 ? 0.0f : 1.0f / sqrtf(d2);
      const float d = d2 * inv_d;
      const float v = fmaxf(k.h - d, 0.0f);
      const float vv = v * v;
      const float mag = (oP1 + sP1[j]) * v + (oNPo + sNPn[j]) * vv;
      const float mm = mag * inv_d;
      const float u = fmaxf(hh - d2, 0.0f);
      const float u3 = u * u * u;
      fx += dx * mm;
      fy += dy * mm + (near0 ? mag : 0.0f);
      S += u3;
      Sx += svx[j] * u3;
      Sy += svy[j] * u3;
    }
  }
  // Self pair (d = 0, fy fallback) removed in closed form; viscosity combine.
  fy -= (oP1 + oP1) * k.h + (oNPo + oNPn) * hh;
  const float fvx = Sx - ovx * S, fvy = Sy - ovy * S;
  if constexpr (!kTail) {
    out_px[q] = fx;
    out_py[q] = fy;
    out_vx[q] = fvx;
    out_vy[q] = fvy;
    return;
  }
  const float onpx = npx[q], onpy = npy[q];
  float nvx = ovx + fx * k.dt + fvx * k.vscale;
  float nvy = ovy + fy * k.dt + fvy * k.vscale;
  const bool live = onpx < kLiveBelow;
  if (!walk_live && live) {  // deferred: keep the post-gravity velocity
    nvx = ovx;
    nvy = ovy;
  }
  float x2 = onpx + (nvx - ovx) * k.dt;
  float y2 = onpy + (nvy - ovy) * k.dt;
  bounce(x2, nvx, k.x_min, k.x_max, k.damp);
  bounce(y2, nvy, k.y_min, k.y_max, k.damp);
  out_px[q] = live ? x2 : rps::kSentinel;
  out_py[q] = live ? y2 : rps::kSentinel;
  out_vx[q] = live ? nvx : 0.0f;
  out_vy[q] = live ? nvy : 0.0f;
}

cudaError_t set_shmem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Grid and block of a walk: one block per own cell (classic) or cell pair.
template <bool kPair>
cudaError_t walk_shape(int gh, int r0, int R, int gw, int C, dim3* grid, int* threads) {
  if (C < 1 || C > (kPair ? 512 : 1024) || r0 < 0 || R < 1 || r0 + R > gh)
    return cudaErrorInvalidValue;
  *grid = dim3(kPair ? (gw + 1) / 2 : gw, R);
  *threads = rps::block_threads(kPair ? 2 * C : C);
  return cudaSuccess;
}

template <bool kPair>
cudaError_t launch_density(const float* px, const float* py, float* rho, float* rhon,
                           int gh, int r0, int R, int gw, int C, float h, float dnorm,
                           float nnorm, void* stream) {
  dim3 grid;
  int threads;
  cudaError_t err = walk_shape<kPair>(gh, r0, R, gw, C, &grid, &threads);
  if (err != cudaSuccess) return err;
  const size_t shmem = 2 * kWindowCells<kPair> * static_cast<size_t>(C) * sizeof(float) +
                       64 * sizeof(int);
  err = set_shmem(reinterpret_cast<const void*>(density_kernel<kPair>), shmem);
  if (err != cudaSuccess) return err;
  density_kernel<kPair><<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      px, py, rho, rhon, gh, r0, gw, C, h, dnorm, nnorm);
  return cudaGetLastError();
}

template <bool kPair, bool kTail>
cudaError_t launch_force(const float* px, const float* py, const float* P1,
                         const float* NPn, const float* vx, const float* vy,
                         const float* NPo, const float* npx, const float* npy,
                         float* o0, float* o1, float* o2, float* o3, int gh, int r0,
                         int R, int gw, int C, ForceScalars k, void* stream) {
  dim3 grid;
  int threads;
  cudaError_t err = walk_shape<kPair>(gh, r0, R, gw, C, &grid, &threads);
  if (err != cudaSuccess) return err;
  const size_t shmem = 6 * kWindowCells<kPair> * static_cast<size_t>(C) * sizeof(float) +
                       64 * sizeof(int);
  err = set_shmem(reinterpret_cast<const void*>(force_kernel<kPair, kTail>), shmem);
  if (err != cudaSuccess) return err;
  force_kernel<kPair, kTail><<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      px, py, P1, NPn, vx, vy, NPo, npx, npy, o0, o1, o2, o3, gh, r0, gw, C, k);
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

template <bool kPair>
static int density_entry(const void* packed, int size) {
  rps_density_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_density<kPair>(a.px, a.py, a.rho, a.rhon, a.gh, a.r0, a.R,
                                                a.gw, a.C, a.h, a.dnorm, a.nnorm, a.stream));
}

extern "C" int rps_density(const void* packed, int size) {
  return density_entry<false>(packed, size);
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

template <bool kPair>
static int force_integrated_entry(const void* packed, int size) {
  rps_force_integrated_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  const ForceScalars k{a.h, a.eps2, a.dt, a.vscale, a.x_min, a.x_max, a.y_min, a.y_max, a.damp};
  return static_cast<int>(launch_force<kPair, true>(
      a.px, a.py, a.P1, a.NPn, a.vx, a.vy, a.NPo, a.npx, a.npy, a.out_px, a.out_py, a.out_vx,
      a.out_vy, a.gh, a.r0, a.R, a.gw, a.C, k, a.stream));
}

extern "C" int rps_force_integrated(const void* packed, int size) {
  return force_integrated_entry<false>(packed, size);
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

template <bool kPair>
static int force_entry(const void* packed, int size) {
  rps_force_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  const ForceScalars k{a.h, a.eps2, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  return static_cast<int>(launch_force<kPair, false>(
      a.px, a.py, a.P1, a.NPn, a.vx, a.vy, a.NPo, nullptr, nullptr, a.fx, a.fy, a.fvx, a.fvy,
      a.gh, a.r0, a.R, a.gw, a.C, k, a.stream));
}

extern "C" int rps_force(const void* packed, int size) {
  return force_entry<false>(packed, size);
}

// K6: rps_density, rps_force_integrated and rps_force in the pair block shape
// (the same records, the same outputs).
using rps_pair_density_args = rps_density_args;
using rps_pair_force_integrated_args = rps_force_integrated_args;
using rps_pair_force_args = rps_force_args;

extern "C" int rps_pair_density(const void* packed, int size) {
  return density_entry<true>(packed, size);
}

extern "C" int rps_pair_force_integrated(const void* packed, int size) {
  return force_integrated_entry<true>(packed, size);
}

extern "C" int rps_pair_force(const void* packed, int size) {
  return force_entry<true>(packed, size);
}
