// K9: one separable hole-fill pass of the rebin, lossy (variant 4) or
// lossless (variant 5), over flat [nc, C] channel planes.
//
// Replaces rust_particle_system_tpu/ops/pallas/rebin.py::_make_kernel_v4 as
// driven by _hole_fill_pass: pass Y is shift = gw with the row test, pass X
// shift = 1 with the cell test.  Output planes, counts and the adoption mask
// are bit-identical to it: values only move, never change, and every decision
// is an integer rank.
//
// The window of destination cell i is FLAT, as in JAX: group 0 is flat cell
// i - shift, group 1 flat cell i + shift, slot order within each.  At a row's
// ends pass X's groups therefore read the far cell of the adjacent row; the
// keep tests reject those lanes exactly as JAX does (lossy: the full key
// compare; lossless: cx > 0 / cx < gw - 1).  Past the ends of the stream a
// lane is dead, or, on a band of the sharded mesh, comes from the ghost rows
// (ghost_lo replaces cells [-shift, 0), ghost_hi cells [nc, nc + shift)).
// Destination rows are global: row = i / gw + row0.
//
// Per destination cell:
//   keep   live window lanes that move here this pass: lossy, key row == row
//          (pass Y) or key cell == cell (pass X); lossless, the clamped hop
//          toward the key (group 0 adopts keys at or past this row/column,
//          group 1 keys at or before it) (rebin.py:242-272);
//   stay   live own slots that stay put (pass Y: key row == row; pass X
//          lossy: key cell == cell; lossless: key row != row, or key column
//          == column) (:274-285);
//   hole   lossy: every slot that does not stay; lossless: the dead slots;
//   the arrival of window rank j fills the hole of rank j while j < #holes;
//   stayers keep their slot, every other slot takes the fill;
//   counts = #stay + min(#keep, #holes);
//   adopted (lossless): keep and rank < #holes, per window lane, in the
//          destination layout [nc, 2C] (group 0 then group 1), as JAX's acc.
//
// Bound on the H100: memory.  A block reads its own slots and the x/y of its
// two window cells, and writes k plane words per slot (plus 2C mask bytes);
// the ranks are ballots.  The TPU computed the ranks with triangular matmuls
// and applied them with one-hot matmuls; here ranks are __ballot_sync +
// __popc per warp plus a shared prefix over the warps, and an arrival is
// placed through one shared-memory index (the lane of each rank).

#include "common.cuh"

namespace {

using rps::cell_of;
using rps::for_channels;
using rps::InPlanes;
using rps::kLiveBelow;
using rps::OutPlanes;

struct PassGeom {
  int k, nc, gw, gh, C, shift, row0;
  int row_only, lossless;
  float x_min, y_min, cell_w, cell_h;
};

// Where window lane (group, slot) of destination cell `cell` lives: kind 0
// nowhere (dead), 1 the flat planes, 2 ghost_lo, 3 ghost_hi; `idx` the word
// index into that array.
struct Lane {
  int kind;
  size_t idx;
};

__device__ __forceinline__ Lane window_lane(const PassGeom& g, int cell, int group,
                                            int slot, bool has_lo, bool has_hi) {
  const int src = group == 0 ? cell - g.shift : cell + g.shift;
  if (src >= 0 && src < g.nc) return {1, static_cast<size_t>(src) * g.C + slot};
  if (src < 0 && has_lo) return {2, static_cast<size_t>(src + g.shift) * g.C + slot};
  if (src >= g.nc && has_hi) return {3, static_cast<size_t>(src - g.nc) * g.C + slot};
  return {0, 0};
}

__device__ __forceinline__ const float* lane_plane(const Lane& l, const InPlanes& in,
                                                   const InPlanes& lo,
                                                   const InPlanes& hi, int ch) {
  return l.kind == 1 ? in.p[ch] : (l.kind == 2 ? lo.p[ch] : hi.p[ch]);
}

__global__ void hole_fill_pass(InPlanes in, InPlanes ghost_lo, InPlanes ghost_hi,
                               OutPlanes out, int* __restrict__ counts,
                               unsigned char* __restrict__ adopted, rps::Fills fills,
                               PassGeom g) {
  extern __shared__ int smem[];
  int* scratch = smem;       // 4 * 32
  int* src = smem + 4 * 32;  // C: window lane of the arrival of each rank
  const int cell = blockIdx.x, s = threadIdx.x;
  const bool act = s < g.C;
  const int cy = cell / g.gw + g.row0, cx = cell % g.gw;
  const bool has_lo = ghost_lo.p[0] != nullptr, has_hi = ghost_hi.p[0] != nullptr;

  bool keep[2] = {false, false};
  bool live_own = false, stay = false;
  if (act) {
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      const Lane l = window_lane(g, cell, grp, s, has_lo, has_hi);
      if (l.kind == 0) continue;
      const float x = lane_plane(l, in, ghost_lo, ghost_hi, 0)[l.idx];
      if (!(x < kLiveBelow)) continue;
      const int ky = cell_of(lane_plane(l, in, ghost_lo, ghost_hi, 1)[l.idx], g.y_min,
                             g.cell_h, g.gh);
      const int kx = cell_of(x, g.x_min, g.cell_w, g.gw);
      if (!g.lossless) {
        keep[grp] = ky == cy && (g.row_only || kx == cx);
      } else if (g.row_only) {
        keep[grp] = grp == 0 ? ky >= cy : ky <= cy;
      } else {
        keep[grp] = ky == cy && (grp == 0 ? (kx >= cx && cx > 0)
                                          : (kx <= cx && cx < g.gw - 1));
      }
    }
    const size_t o = static_cast<size_t>(cell) * g.C + s;
    const float x = in.p[0][o];
    live_own = x < kLiveBelow;
    if (live_own) {
      const int ky = cell_of(in.p[1][o], g.y_min, g.cell_h, g.gh);
      const int kx = cell_of(x, g.x_min, g.cell_w, g.gw);
      if (g.row_only)
        stay = ky == cy;
      else if (g.lossless)
        stay = ky != cy || kx == cx;
      else
        stay = ky == cy && kx == cx;
    }
  }
  const bool hole = act && (g.lossless ? !live_own : !stay);

  const bool p[4] = {keep[0], keep[1], hole, stay};
  int inc[4], tot[4];
  rps::block_count<4>(p, inc, tot, scratch);
  const int n_up = tot[0], n_arr = tot[0] + tot[1], n_holes = tot[2];

  const bool adopt0 = keep[0] && inc[0] - 1 < n_holes;
  const bool adopt1 = keep[1] && n_up + inc[1] - 1 < n_holes;
  if (adopt0) src[inc[0] - 1] = s;
  if (adopt1) src[n_up + inc[1] - 1] = g.C + s;
  __syncthreads();
  if (!act) return;

  if (g.lossless) {
    const size_t a = static_cast<size_t>(cell) * 2 * g.C + s;
    adopted[a] = adopt0;
    adopted[a + g.C] = adopt1;
  }
  const size_t o = static_cast<size_t>(cell) * g.C + s;
  const int hrank = inc[2] - 1;
  if (stay) {
    for_channels(g.k, [&](int ch) { out.p[ch][o] = in.p[ch][o]; });
  } else if (hole && hrank < n_arr) {
    const int w = src[hrank];
    const int grp = w >= g.C;
    const Lane l = window_lane(g, cell, grp, w - grp * g.C, has_lo, has_hi);
    for_channels(g.k, [&](int ch) {
      out.p[ch][o] = lane_plane(l, in, ghost_lo, ghost_hi, ch)[l.idx];
    });
  } else {
    for_channels(g.k, [&](int ch) { out.p[ch][o] = fills.v[ch]; });
  }
  if (s == 0) counts[cell] = tot[3] + min(n_arr, n_holes);
}

}  // namespace

// in_host: host array of k device pointers, each a flat [nc, C] f32 plane
// (channels 0/1 are x/y; nc = rows * gw, the rows starting at global row
// row0 of a grid gh rows high).  ghost_lo_host / ghost_hi_host: NULL, or host
// arrays of k device pointers to [shift, C] blocks that take the place of the
// cells before the first and after the last.  out_host: k [nc, C] planes;
// counts: [nc] i32; adopted: [nc, 2C] u8 (lossless; else NULL).  fills[0]
// must be >= 0.5 * SENTINEL (a filled slot is dead); the wrapper checks it.
static int hole_fill(const float* const* in_host, const float* const* ghost_lo_host,
                     const float* const* ghost_hi_host, float* const* out_host, int* counts,
                     unsigned char* adopted, const float* fills_host, int k, int nc, int gw,
                     int gh, int C, int shift, int row0, int row_only, int lossless,
                     float x_min, float y_min, float cell_w, float cell_h, void* stream) {
  if (k < 2 || k > rps::kMaxChannels || C < 1 || C > 1024 || gw < 1 || nc < 1 ||
      nc % gw != 0 || shift < 1 || shift > nc || row0 < 0 || row0 + nc / gw > gh ||
      (lossless && adopted == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rps::Fills fills{};
  InPlanes in{}, lo{}, hi{};
  OutPlanes out{};
  for (int i = 0; i < k; ++i) {
    fills.v[i] = fills_host[i];
    in.p[i] = in_host[i];
    out.p[i] = out_host[i];
    lo.p[i] = ghost_lo_host ? ghost_lo_host[i] : nullptr;
    hi.p[i] = ghost_hi_host ? ghost_hi_host[i] : nullptr;
  }
  const PassGeom g{k, nc, gw, gh, C, shift, row0, row_only, lossless,
                   x_min, y_min, cell_w, cell_h};
  const int threads = rps::block_threads(C);
  const size_t shmem = (4 * 32 + C) * sizeof(int);
  hole_fill_pass<<<nc, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      in, lo, hi, out, counts, adopted, fills, g);
  return static_cast<int>(cudaGetLastError());
}

// (Its arguments: the record struct below, common.cuh's rps::unpack.)
// ghost_lo / ghost_hi hold NULLs where no ghost rows are given.
struct rps_hole_fill_pass_args {
  const float* in[8];
  const float* ghost_lo[8];
  const float* ghost_hi[8];
  float* out[8];
  int* counts;
  unsigned char* adopted;
  float fills[8];
  int k, nc, gw, gh, C, shift, row0, row_only, lossless;
  float x_min, y_min, cell_w, cell_h;
  void* stream;
};

extern "C" int rps_hole_fill_pass(const void* packed, int size) {
  rps_hole_fill_pass_args r;
  if (!rps::unpack(packed, size, &r)) return static_cast<int>(cudaErrorInvalidValue);
  return hole_fill(r.in, r.ghost_lo, r.ghost_hi, r.out, r.counts, r.adopted, r.fills, r.k,
                   r.nc, r.gw, r.gh, r.C, r.shift, r.row0, r.row_only, r.lossless, r.x_min,
                   r.y_min, r.cell_w, r.cell_h, r.stream);
}
