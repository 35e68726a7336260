// K12: the full-window rebin (variants 2 and 3): a stable compaction of each
// cell's keyed candidates over its 9C-lane window, live slots packed low.
//
// Replaces rust_particle_system_tpu/ops/pallas/rebin.py::_make_kernel_v3
// (ranks by a triangular matmul) and ::_make_kernel_v2 (ranks by log-shift
// rolls).  The two compute the same function, pinned to one oracle by the JAX
// tests; one kernel serves both.  Output planes and counts are bit-identical
// to them: values only move.
//
// The window of destination cell i is the JAX one (rebin.py:983-1006): nine
// groups of C lanes, source row offset dy in (-1, 0, 1) major, then column
// offset dx in (-1, 0, 1), then slot.  Group (dy, dx) reads flat cell
// j + dy*gw with j = i + dx, and is dead unless 0 <= j < nc and
// 0 <= j + dy*gw < nc.  The shifts are FLAT, so at a row's ends a dx lane
// reads the far cell of the adjacent row; the keep test (live, key cell ==
// cell i) decides on those lanes as JAX does.
//
// Per destination cell: the candidates of window rank j < C land in slot j in
// window order, the other slots take the fills, and counts = the number of
// candidates, which may exceed C (the overflow is dropped and reported).
//
// Bound on the H100: memory.  A block reads x/y of its nine window cells
// (mostly from L2: neighbouring blocks share them) and moves k words per kept
// candidate; the ranks are nine ballot/popc prefixes at once.  The TPU ranked
// with a [9C, 9C] triangular matmul (v3) or a log-shift roll chain (v2) and
// applied one-hot matmuls; here each kept candidate writes its own slot.

#include "common.cuh"

namespace {

using rps::cell_of;
using rps::for_channels;
using rps::InPlanes;
using rps::kLiveBelow;
using rps::OutPlanes;

struct CompactGeom {
  int k, nc, gw, gh, C;
  float x_min, y_min, cell_w, cell_h;
};

__global__ void rebin_compact(InPlanes in, OutPlanes out, int* __restrict__ counts,
                              rps::Fills fills, CompactGeom g) {
  extern __shared__ int scratch[];  // 9 * 32
  const int cell = blockIdx.x, s = threadIdx.x;
  const bool act = s < g.C;
  const int cy = cell / g.gw, cx = cell % g.gw;

  bool keep[9];
  int from[9];
#pragma unroll
  for (int w = 0; w < 9; ++w) {
    const int j = cell + (w % 3 - 1);
    from[w] = j + (w / 3 - 1) * g.gw;
    keep[w] = false;
    if (act && j >= 0 && j < g.nc && from[w] >= 0 && from[w] < g.nc) {
      const size_t i = static_cast<size_t>(from[w]) * g.C + s;
      const float x = in.p[0][i];
      keep[w] = x < kLiveBelow && cell_of(x, g.x_min, g.cell_w, g.gw) == cx &&
                cell_of(in.p[1][i], g.y_min, g.cell_h, g.gh) == cy;
    }
  }
  int inc[9], tot[9];
  rps::block_count<9>(keep, inc, tot, scratch);
  if (!act) return;

  const size_t base = static_cast<size_t>(cell) * g.C;
  int before = 0;
#pragma unroll
  for (int w = 0; w < 9; ++w) {
    const int rank = before + inc[w] - 1;
    if (keep[w] && rank < g.C) {
      const size_t i = static_cast<size_t>(from[w]) * g.C + s;
      for_channels(g.k, [&](int ch) { out.p[ch][base + rank] = in.p[ch][i]; });
    }
    before += tot[w];
  }
  if (s >= before) for_channels(g.k, [&](int ch) { out.p[ch][base + s] = fills.v[ch]; });
  if (s == 0) counts[cell] = before;
}

}  // namespace

// in_host / out_host: host arrays of k device pointers, each a [gh, gw, C]
// f32 plane (channels 0/1 are x/y); counts: [gh*gw] i32, the candidate totals.
// fills[0] must be >= 0.5 * SENTINEL (a filled slot is dead); the wrapper
// checks it.
static int compact(const float* const* in_host, float* const* out_host, int* counts,
                   const float* fills_host, int k, int gh, int gw, int C, float x_min,
                   float y_min, float cell_w, float cell_h, void* stream) {
  if (k < 2 || k > rps::kMaxChannels || C < 1 || C > 1024 || gw < 1 || gh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rps::Fills fills{};
  InPlanes in{};
  OutPlanes out{};
  for (int i = 0; i < k; ++i) {
    fills.v[i] = fills_host[i];
    in.p[i] = in_host[i];
    out.p[i] = out_host[i];
  }
  const CompactGeom g{k, gh * gw, gw, gh, C, x_min, y_min, cell_w, cell_h};
  const int threads = rps::block_threads(C);
  rebin_compact<<<gh * gw, threads, 9 * 32 * sizeof(int),
                  static_cast<cudaStream_t>(stream)>>>(in, out, counts, fills, g);
  return static_cast<int>(cudaGetLastError());
}

// (Its arguments: the record struct below, common.cuh's rps::unpack.)
struct rps_rebin_compact_args {
  const float* in[8];
  float* out[8];
  int* counts;
  float fills[8];
  int k, gh, gw, C;
  float x_min, y_min, cell_w, cell_h;
  void* stream;
};

extern "C" int rps_rebin_compact(const void* packed, int size) {
  rps_rebin_compact_args r;
  if (!rps::unpack(packed, size, &r)) return static_cast<int>(cudaErrorInvalidValue);
  return compact(r.in, r.out, r.counts, r.fills, r.k, r.gh, r.gw, r.C, r.x_min, r.y_min,
                 r.cell_w, r.cell_h, r.stream);
}
