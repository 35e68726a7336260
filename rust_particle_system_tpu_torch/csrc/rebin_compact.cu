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
// Bound on the H100: memory (the k planes read once and written once).  The
// TPU ranked with a [9C, 9C] triangular matmul (v3) or a log-shift roll chain
// (v2) and applied one-hot matmuls.  Here a block owns T = tile_cells(C)
// adjacent flat destination cells [f0, f0 + T), so each slot is keyed once a
// block and each value moves once:
//   staging  the block's sources are three flat ranges, one per dy: source
//            cell m = j + dy*gw for j in [f0 - 1, f0 + T] (j = i + dx).  A warp
//            per source cell loads its x/y once, coalesced, kStageChunks
//            chunks of 32 slots in flight, keys each slot once with
//            rps::cell_of (kc = ky*gw + kx) and writes one word per slot to
//            shared memory: kc if the slot is live, else -1 (also where j or m
//            lies outside [0, nc): the group guard, which depends on (dy, j)
//            alone).  The warps that read the word test it against their own
//            cell i, one of j - 1, j, j + 1, so a key elsewhere matches none
//            (kc >= 0: -1 matches none either).  Staging by flat ranges
//            reproduces the row-end wrap without a special case.
//   a __syncthreads.
//   ranking  a warp per own cell walks its nine groups in window order over
//            the staged words, one ballot of word == i per 32-slot chunk, the
//            running rank in registers (no block-wide count).  A candidate of
//            rank < C reads its k values once from the input planes and writes
//            them once to slot rank (a chunk's candidates land in consecutive
//            slots); past C the warp only counts.  Slots from min(count, C) up
//            take the fills; counts[i] is the total.
// x/y are read from L2 by three blocks (one per dy range) and once more by the
// move; the other channels once.  Measured on the card (PERF.md, section 6),
// occupancy sets the pace: the block and its register cap (kCompactMinBlocks:
// 40 registers, no spill) are the fastest of the geometries timed there.  K1's
// cuts (the least float that reaches a cell, in place of the division) keyed
// no faster there, so the staging divides.

#include "common.cuh"

namespace {

using rps::cell_of;
using rps::for_channels;
using rps::InPlanes;
using rps::kLiveBelow;
using rps::OutPlanes;

constexpr int kCompactWarps = 16;                    // warps a block
constexpr int kCompactThreads = 32 * kCompactWarps;  // threads a block
constexpr int kCompactMinBlocks = 3;                 // blocks an SM: at most 42 registers
constexpr int kStageChunks = 4;                      // chunks a staging warp loads at once
constexpr int kMaxC = 1024;                          // the largest C the rebin takes

__host__ __device__ constexpr int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Own (destination) cells of a block at C slots a cell; its staging holds
// three ranges of T + 2 source cells.
__host__ __device__ constexpr int tile_cells(int C) { return clamp_int(2048 / C, 4, 16); }

// Shared bytes of a block: one word per staged slot.
__host__ __device__ constexpr size_t compact_shmem(int C) {
  return static_cast<size_t>(4) * 3 * (tile_cells(C) + 2) * C;
}
static_assert(compact_shmem(kMaxC) <= 232448, "a tile fits one H100 block's shared memory");

struct CompactGeom {
  int k, nc, gw, gh, C;
  float x_min, y_min, cell_w, cell_h;
};

// Block x: own flat cells [x T, x T + T) (those inside the grid).
__global__ void __launch_bounds__(kCompactThreads, kCompactMinBlocks)
    rebin_compact(InPlanes in, OutPlanes out, int* __restrict__ counts, rps::Fills fills,
                  CompactGeom g) {
  extern __shared__ int smem[];
  const int C = g.C, T = tile_cells(C), S = T + 2;
  const int f0 = blockIdx.x * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* words = smem;  // [3][S][C]: range dy + 1, source cell (f0 - 1 + u) + dy*gw

  for (int w = warp; w < 3 * S; w += kCompactWarps) {
    const int dy = w / S - 1, u = w % S;
    const int j = f0 - 1 + u, m = j + dy * g.gw;
    int* word = words + w * C;
    if (j < 0 || j >= g.nc || m < 0 || m >= g.nc) {
      for (int s = lane; s < C; s += 32) word[s] = -1;
      continue;
    }
    const float* xs = in.p[0] + static_cast<size_t>(m) * C;
    const float* ys = in.p[1] + static_cast<size_t>(m) * C;
    for (int s0 = lane; s0 < C; s0 += 32 * kStageChunks) {
      float x[kStageChunks], y[kStageChunks];
#pragma unroll
      for (int b = 0; b < kStageChunks; ++b) {
        const int s = s0 + 32 * b;
        x[b] = s < C ? __ldg(xs + s) : kLiveBelow;
        y[b] = s < C ? __ldg(ys + s) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kStageChunks; ++b) {
        const int kc = cell_of(y[b], g.y_min, g.cell_h, g.gh) * g.gw +
                       cell_of(x[b], g.x_min, g.cell_w, g.gw);
        if (s0 + 32 * b < C) word[s0 + 32 * b] = x[b] < kLiveBelow ? kc : -1;
      }
    }
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  for (int t = warp; t < T; t += kCompactWarps) {
    const int i = f0 + t;
    if (i >= g.nc) break;
    const size_t base = static_cast<size_t>(i) * C;
    int before = 0;  // candidates in the groups and chunks walked
#pragma unroll 1
    for (int grp = 0; grp < 9; ++grp) {
      const int dy = grp / 3 - 1, dx = grp % 3 - 1;
      const int* word = words + ((dy + 1) * S + t + dx + 1) * C;
      for (int s0 = 0; s0 < C; s0 += 32) {
        const int s = s0 + lane;
        const bool cand = s < C && word[s] == i;
        const unsigned b = __ballot_sync(0xffffffffu, cand);
        const int rank = before + __popc(b & below);
        if (cand && rank < C) {
          const size_t from = static_cast<size_t>(i + dx + dy * g.gw) * C + s;
          float v[rps::kMaxChannels];
          for_channels(g.k, [&](int ch) { v[ch] = __ldg(in.p[ch] + from); });
          for_channels(g.k, [&](int ch) { out.p[ch][base + rank] = v[ch]; });
        }
        before += __popc(b);
      }
    }
    for (int s = lane; s < C; s += 32)
      if (s >= before) for_channels(g.k, [&](int ch) { out.p[ch][base + s] = fills.v[ch]; });
    if (lane == 0) counts[i] = before;
  }
}

}  // namespace

// in_host / out_host: host arrays of k device pointers, each a [gh, gw, C]
// f32 plane (channels 0/1 are x/y); counts: [gh*gw] i32, the candidate totals.
// fills[0] must be >= 0.5 * SENTINEL (a filled slot is dead); the wrapper
// checks it.
static int compact(const float* const* in_host, float* const* out_host, int* counts,
                   const float* fills_host, int k, int gh, int gw, int C, float x_min,
                   float y_min, float cell_w, float cell_h, void* stream) {
  if (k < 2 || k > rps::kMaxChannels || C < 1 || C > kMaxC || gw < 1 || gh < 1 ||
      static_cast<long long>(gh) * gw >= (1LL << 31))
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
  const int T = tile_cells(C);
  const size_t shmem = compact_shmem(C);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rebin_compact, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rebin_compact<<<(g.nc + T - 1) / T, kCompactThreads, shmem,
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
