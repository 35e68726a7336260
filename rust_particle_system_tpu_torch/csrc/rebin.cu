// K1 and K7: the lossless hole-fill rebin of plane-resident state (variant 6
// semantics), on the whole grid (K1) or on one band's slab of it (K7).
//
// Replaces rust_particle_system_tpu/ops/pallas/rebin.py::_make_kernel_v6,
// driven by _rebin_v6 (K1) and by _rebin_v6_band (K7).  Output planes and
// counts are bit-identical to it: values only move, never change, and every
// decision is an integer rank.
//
// One pair of kernels serves both.  Every row test (the edge guards, the key
// row compares) is in GLOBAL grid rows, so a block of a band sees exactly the
// decisions the same row's block sees on the whole grid.  A launch owns the
// global rows [row0, row0 + rows); global row r of the input sits at input row
// r - row0 + in_off, and its outputs at row r - row0.  K1 is row0 = 0,
// in_off = 0 on the [gh, gw, C] planes.  K7 takes the band's [R, gw, C] slab
// extended by the ghost rows a neighbour band owns, in_off = 2: input rows
// row0-2 (x/y only are read there), row0-1, the R own rows, row0+R.  Reads of
// rows outside the grid are guarded by the global-row conditions, so ghost
// rows past the mesh's edges may hold anything.
//
// What it computes, per destination cell (r, c), with keys taken from (x, y)
// by the IEEE floor expression (rebin.py:489-494):
//   pass Y   stayers (live, key row == r) keep their slot; arrivals from rows
//            r-1 then r+1 (slot order; "keep" is a clamped hop toward the key
//            row, rebin.py:546-547) fill the DEAD own slots in slot order; an
//            arrival of window rank j fills the hole of rank j iff j < #holes.
//   Y-retention  a row-r mover that row r-1 / r+1 did not adopt stays in its
//            slot (rebin.py:621-639).  Row r-1's decision needs row r-2's
//            keep count, so rows r-2..r+1 of x/y are read.
//   pass X   the same within the row, on the pass-Y result ("mid"): arrivals
//            from columns c-1 then c+1 whose key row is r; slots whose key row
//            is not r stay put (rebin.py:641-662).
//   X-retention  needs mid of columns c-2..c+1 (rebin.py:682-689).
//   counts   live slots per cell after both passes.
//
// Bound on the H100: memory.  Each pass reads ~10 and writes k=5 plane words
// per slot (~200 MB per frame at 1M particles, C=128); the ranks are a few
// ballots per slot.  The TPU built ranks from triangular matmuls and applied
// them with one-hot matmuls because its lanes cannot scatter; here ranks are
// __ballot_sync + __popc per warp plus a shared prefix over the warps, and an
// arrival is placed by one shared-memory index write.  A whole grid row does
// not fit in shared memory at 214 cells x 128 slots x 5 channels (548 KB), so
// the two passes are two launches with "mid" in device memory: a pass-X block
// reads its four source columns of mid from L2/HBM.
//
// The JAX kernel's air-window skip (rebin.py:512-538) is an exact shortcut of
// the same result and is not needed: a block with nothing live does a few
// empty ballots and writes fills.

#include "common.cuh"

namespace {

using rps::cell_of;
using rps::for_channels;
using rps::InPlanes;
using rps::kLiveBelow;
using rps::OutPlanes;

struct Geom {
  int k, gh, gw, C;
  int row0, rows, in_off;  // own global rows [row0, row0 + rows); input row offset
  float x_min, y_min, cell_w, cell_h;
};

// Slot s of cell (r, c), global row r, in the input planes.
__device__ __forceinline__ size_t in_index(const Geom& g, int r, int c, int s) {
  return (static_cast<size_t>(r - g.row0 + g.in_off) * g.gw + c) * g.C + s;
}

// The same slot in the own-row planes (mid, out).
__device__ __forceinline__ size_t own_index(const Geom& g, int r, int c, int s) {
  return (static_cast<size_t>(r - g.row0) * g.gw + c) * g.C + s;
}

// Pass Y + Y-retention for cell (row0 + blockIdx.y, blockIdx.x): in -> mid.
__global__ void rebin_pass_y(InPlanes in, float* __restrict__ mid, rps::Fills fills,
                             Geom g) {
  extern __shared__ int smem[];
  int* scratch = smem;        // 8 * 32
  int* src = smem + 8 * 32;   // C: window index of the arrival of each rank
  const int c = blockIdx.x, r = g.row0 + blockIdx.y, s = threadIdx.x;
  const bool act = s < g.C;
  const size_t plane = static_cast<size_t>(g.rows) * g.gw * g.C;
  const bool has_up = r >= 1, has_dn = r <= g.gh - 2;
  const float* __restrict__ x = in.p[0];
  const float* __restrict__ y = in.p[1];

  bool live0 = false;
  int ky0 = 0;
  bool keep_m1 = false, keep_p1 = false, dead_m1 = false, dead_p1 = false;
  bool keep_m2_into_m1 = false;
  if (act) {
    const size_t o = in_index(g, r, c, s);
    live0 = x[o] < kLiveBelow;
    ky0 = cell_of(y[o], g.y_min, g.cell_h, g.gh);
    if (has_up) {
      const size_t u = in_index(g, r - 1, c, s);
      const bool l = x[u] < kLiveBelow;
      dead_m1 = !l;
      keep_m1 = l && cell_of(y[u], g.y_min, g.cell_h, g.gh) >= r;
    }
    if (has_dn) {
      const size_t d = in_index(g, r + 1, c, s);
      const bool l = x[d] < kLiveBelow;
      dead_p1 = !l;
      keep_p1 = l && cell_of(y[d], g.y_min, g.cell_h, g.gh) <= r;
    }
    if (r >= 2) {  // row r-1's up group: competes with row r for r-1's holes
      const size_t u2 = in_index(g, r - 2, c, s);
      keep_m2_into_m1 = x[u2] < kLiveBelow &&
                        cell_of(y[u2], g.y_min, g.cell_h, g.gh) >= r - 1;
    }
  }
  const bool dead = act && !live0;
  const bool into_m1 = live0 && has_up && ky0 <= r - 1;  // row r-1's down group
  const bool into_p1 = live0 && has_dn && ky0 >= r + 1;  // row r+1's up group

  const bool p[8] = {keep_m1, keep_p1, dead, into_m1, into_p1, keep_m2_into_m1,
                     dead_m1, dead_p1};
  int inc[8], tot[8];
  rps::block_count<8>(p, inc, tot, scratch);
  const int n_up = tot[0], n_arr = tot[0] + tot[1], n_holes = tot[2];

  if (keep_m1 && inc[0] - 1 < n_holes) src[inc[0] - 1] = s;
  if (keep_p1 && n_up + inc[1] - 1 < n_holes) src[n_up + inc[1] - 1] = g.C + s;
  __syncthreads();
  if (!act) return;

  const bool adopted = (into_m1 && tot[5] + inc[3] - 1 < tot[6]) ||
                       (into_p1 && inc[4] - 1 < tot[7]);
  const bool keep_own = live0 && (ky0 == r || !adopted);  // stayer or retained
  const int hrank = inc[2] - 1;
  const size_t o = own_index(g, r, c, s);
  if (keep_own) {
    const size_t i = in_index(g, r, c, s);
    for_channels(g.k, [&](int ch) { mid[ch * plane + o] = in.p[ch][i]; });
  } else if (dead && hrank < n_arr) {
    const int w = src[hrank];
    const size_t from = w < g.C ? in_index(g, r - 1, c, w)
                                : in_index(g, r + 1, c, w - g.C);
    for_channels(g.k, [&](int ch) { mid[ch * plane + o] = in.p[ch][from]; });
  } else {
    for_channels(g.k, [&](int ch) { mid[ch * plane + o] = fills.v[ch]; });
  }
}

// Pass X + X-retention + counts for cell (row0 + blockIdx.y, blockIdx.x):
// mid -> out.  It reads the cell's own row only.
__global__ void rebin_pass_x(const float* __restrict__ mid, OutPlanes out,
                             int* __restrict__ counts, rps::Fills fills, Geom g) {
  extern __shared__ int smem[];
  int* scratch = smem;
  int* src = smem + 8 * 32;
  const int c = blockIdx.x, r = g.row0 + blockIdx.y, s = threadIdx.x;
  const bool act = s < g.C;
  const size_t plane = static_cast<size_t>(g.rows) * g.gw * g.C;
  const bool has_l = c >= 1, has_r = c <= g.gw - 2;

  bool liveM = false;
  int mkx = 0, mky = 0;
  bool kg0 = false, kg1 = false, dead_l = false, dead_r = false, g0_of_l = false;
  if (act) {
    const size_t o = own_index(g, r, c, s);
    liveM = mid[o] < kLiveBelow;
    mkx = cell_of(mid[o], g.x_min, g.cell_w, g.gw);
    mky = cell_of(mid[plane + o], g.y_min, g.cell_h, g.gh);
    if (has_l) {
      const size_t u = own_index(g, r, c - 1, s);
      const bool l = mid[u] < kLiveBelow;
      dead_l = !l;
      kg0 = l && cell_of(mid[plane + u], g.y_min, g.cell_h, g.gh) == r &&
            cell_of(mid[u], g.x_min, g.cell_w, g.gw) >= c;
    }
    if (has_r) {
      const size_t d = own_index(g, r, c + 1, s);
      const bool l = mid[d] < kLiveBelow;
      dead_r = !l;
      kg1 = l && cell_of(mid[plane + d], g.y_min, g.cell_h, g.gh) == r &&
            cell_of(mid[d], g.x_min, g.cell_w, g.gw) <= c;
    }
    if (c >= 2) {  // column c-1's left group: competes with column c for its holes
      const size_t u2 = own_index(g, r, c - 2, s);
      g0_of_l = mid[u2] < kLiveBelow &&
                cell_of(mid[plane + u2], g.y_min, g.cell_h, g.gh) == r &&
                cell_of(mid[u2], g.x_min, g.cell_w, g.gw) >= c - 1;
    }
  }
  const bool dead = act && !liveM;
  const bool in_row = liveM && mky == r;
  const bool into_l = in_row && has_l && mkx <= c - 1;  // column c-1's right group
  const bool into_r = in_row && has_r && mkx >= c + 1;  // column c+1's left group

  const bool p[8] = {kg0, kg1, dead, into_l, into_r, g0_of_l, dead_l, dead_r};
  int inc[8], tot[8];
  rps::block_count<8>(p, inc, tot, scratch);
  const int n_left = tot[0], n_arr = tot[0] + tot[1], n_holes = tot[2];

  if (kg0 && inc[0] - 1 < n_holes) src[inc[0] - 1] = s;
  if (kg1 && n_left + inc[1] - 1 < n_holes) src[n_left + inc[1] - 1] = g.C + s;
  __syncthreads();

  bool live_out = false;
  if (act) {
    const bool adopted = (into_l && tot[5] + inc[3] - 1 < tot[6]) ||
                         (into_r && inc[4] - 1 < tot[7]);
    const bool keep_own = liveM && (!in_row || mkx == c || !adopted);
    const int hrank = inc[2] - 1;
    const size_t o = own_index(g, r, c, s);
    if (keep_own) {
      for_channels(g.k, [&](int ch) { out.p[ch][o] = mid[ch * plane + o]; });
      live_out = true;
    } else if (dead && hrank < n_arr) {
      const int w = src[hrank];
      const size_t from = w < g.C ? own_index(g, r, c - 1, w)
                                  : own_index(g, r, c + 1, w - g.C);
      for_channels(g.k, [&](int ch) { out.p[ch][o] = mid[ch * plane + from]; });
      live_out = true;
    } else {
      for_channels(g.k, [&](int ch) { out.p[ch][o] = fills.v[ch]; });
    }
  }
  const bool q[1] = {live_out};
  int qi[1], qt[1];
  rps::block_count<1>(q, qi, qt, scratch);
  if (s == 0) counts[(r - g.row0) * g.gw + c] = qt[0];
}

}  // namespace

// in_host: host array of k device pointers, each a [rows + in_off + 1, gw, C]
// f32 plane (channels 0/1 are x/y), or [gh, gw, C] with in_off = 0 and
// rows = gh (K1); out_host: k [rows, gw, C] planes; mid: [k, rows, gw, C] f32
// scratch; counts: [rows*gw] i32.  gh is the whole grid's height; the launch
// owns global rows [row0, row0 + rows).  fills[0] must be >= 0.5 * SENTINEL
// (a filled slot is dead); the wrapper checks it.
static int rebin(const float* const* in_host, float* mid, float* const* out_host,
                 int* counts, const float* fills_host, int k, int gh, int gw, int C,
                 int row0, int rows, int in_off, float x_min, float y_min, float cell_w,
                 float cell_h, void* stream) {
  if (k < 2 || k > rps::kMaxChannels || C < 1 || C > 1024 || rows < 1 || row0 < 0 ||
      row0 + rows > gh || in_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rps::Fills fills{};
  InPlanes in{};
  OutPlanes out{};
  for (int i = 0; i < k; ++i) {
    fills.v[i] = fills_host[i];
    in.p[i] = in_host[i];
    out.p[i] = out_host[i];
  }
  const Geom g{k, gh, gw, C, row0, rows, in_off, x_min, y_min, cell_w, cell_h};
  const dim3 grid(gw, rows);
  const int threads = rps::block_threads(C);
  const size_t shmem = (8 * 32 + C) * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rebin_pass_y<<<grid, threads, shmem, st>>>(in, mid, fills, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rebin_pass_x<<<grid, threads, shmem, st>>>(mid, out, counts, fills, g);
  return static_cast<int>(cudaGetLastError());
}

// (Its arguments: the record struct below, common.cuh's rps::unpack.)
struct rps_rebin_args {
  const float* in[8];
  float* mid;
  float* out[8];
  int* counts;
  float fills[8];
  int k, gh, gw, C, row0, rows, in_off;
  float x_min, y_min, cell_w, cell_h;
  void* stream;
};

extern "C" int rps_rebin(const void* packed, int size) {
  rps_rebin_args r;
  if (!rps::unpack(packed, size, &r)) return static_cast<int>(cudaErrorInvalidValue);
  return rebin(r.in, r.mid, r.out, r.counts, r.fills, r.k, r.gh, r.gw, r.C, r.row0, r.rows,
               r.in_off, r.x_min, r.y_min, r.cell_w, r.cell_h, r.stream);
}
