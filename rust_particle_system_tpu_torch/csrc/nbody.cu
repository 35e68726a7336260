// K8: all-pairs softened N-body accelerations, [n, 2] positions in, [n, 2]
// accelerations out.
//
// Replaces rust_particle_system_tpu/ops/pallas/nbody.py::_kernel (driven by
// nbody_accel_pallas):
//   a_i = sum_j delta_ij * (G s^3 - R eps s^4),  s = (|delta_ij|^2 + eps^2)^-1/2
// over every j, the particle itself included: its delta is 0, so it adds
// exactly 0 and needs no mask.
//
// Bound on the H100: arithmetic (16 operations a pair, an FMA counted as two,
// one of them a reciprocal square root; n^2 pairs), not memory (16 n bytes);
// in practice the issue rate of its instructions a pair, one of them on the
// SFU.  The TPU swept
// [256 x 1024] tiles of the pair matrix in VMEM and padded n with far-away
// ghost particles.  Here the pair matrix is cut both ways so that the card
// has enough warps to hide each pair's dependent chain:
//   i    a block owns kBlockI = 32 * kPerThread particles i; each thread holds
//        kPerThread of them (i0 + u * 32 + lane) in registers, so each j it
//        reads from shared memory serves kPerThread pairs;
//   j    the block's kSlices warps each sweep one contiguous slice of j
//        (a multiple of 32 long; the last slice ragged, cut by its length, not
//        padded), staging 32 positions at a time in the warp's own shared
//        buffer (no block-wide sync in the sweep) with the next 32 in flight;
//   sum  each warp's partial sums go to shared memory, and one thread per i
//        adds the slices in slice order: a fixed order, no atomics, so two
//        runs give the same bits.  Within a slice the sum runs in j order.
// At n = 16,384: 256 blocks of 16 warps, 4,096 warps on 132 SMs.  The
// positions (128 KB) stay in L2, so the staging is plain loads.  ptxas
// (sm_90a, -O3): 40 registers, no spill, 12,288 bytes of shared memory.  The
// per-pair expression is regrouped as w = s^3 (G - R eps s); rsqrtf (not
// correctly rounded) is the counterpart of the TPU's rsqrt: no threshold
// depends on it.  Measured on the card (PERF.md, section 6) the sweep is
// issue-bound, ~14 instructions a pair: rsqrtf's guard for a subnormal
// argument is 3 of them (a compare and two predicated multiplies around
// MUFU.RSQ), and a copy with rsqrt.approx.ftz, which has none, is ~15% faster;
// 4 particles a thread or 32 slices gain nothing measurable.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kPerThread = 2;                // I: particles i a thread holds
constexpr int kSlices = 16;                  // S: j slices, one warp each
constexpr int kThreads = 32 * kSlices;       // threads a block
constexpr int kBlockI = 32 * kPerThread;     // particles i a block owns
constexpr int kChunk = 32;                   // positions a warp stages at once

__global__ void __launch_bounds__(kThreads)
    nbody_kernel(const float2* __restrict__ pos, float2* __restrict__ acc, int n,
                 float g_const, float rep_soft, float eps2) {
  __shared__ float4 stage[kSlices][kChunk / 2];  // two positions an entry
  __shared__ float2 part[kSlices][kBlockI];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int i0 = blockIdx.x * kBlockI;
  float px[kPerThread], py[kPerThread], ax[kPerThread], ay[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = i0 + u * 32 + lane;
    const float2 p = i < n ? pos[i] : make_float2(0.0f, 0.0f);
    px[u] = p.x;
    py[u] = p.y;
    ax[u] = 0.0f;
    ay[u] = 0.0f;
  }
  const auto pair = [&](float xj, float yj) {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const float dx = xj - px[u], dy = yj - py[u];
      const float inv = rsqrtf(fmaf(dx, dx, fmaf(dy, dy, eps2)));
      const float w = inv * inv * inv * fmaf(-rep_soft, inv, g_const);
      ax[u] = fmaf(dx, w, ax[u]);
      ay[u] = fmaf(dy, w, ay[u]);
    }
  };

  // This warp's slice of j: [j_lo, j_hi).
  const int len = (n + kSlices * kChunk - 1) / (kSlices * kChunk) * kChunk;
  const int j_lo = min(n, slice * len), j_hi = min(n, j_lo + len);
  float2* own = reinterpret_cast<float2*>(stage[slice]);
  float2 next = j_lo + lane < j_hi ? pos[j_lo + lane] : make_float2(0.0f, 0.0f);
  for (int j0 = j_lo; j0 < j_hi; j0 += kChunk) {
    __syncwarp();  // the warp is done with the last chunk
    own[lane] = next;
    __syncwarp();
    if (j0 + kChunk + lane < j_hi) next = pos[j0 + kChunk + lane];
    const int m = min(kChunk, j_hi - j0);
    if (m == kChunk) {
#pragma unroll
      for (int k = 0; k < kChunk / 2; ++k) {
        const float4 two = stage[slice][k];
        pair(two.x, two.y);
        pair(two.z, two.w);
      }
    } else {
      for (int k = 0; k < m; ++k) pair(own[k].x, own[k].y);
    }
  }

#pragma unroll
  for (int u = 0; u < kPerThread; ++u) part[slice][u * 32 + lane] = make_float2(ax[u], ay[u]);
  __syncthreads();
  if (threadIdx.x < kBlockI && i0 + static_cast<int>(threadIdx.x) < n) {
    float sx = 0.0f, sy = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      sx += part[s][threadIdx.x].x;
      sy += part[s][threadIdx.x].y;
    }
    acc[i0 + threadIdx.x] = make_float2(sx, sy);
  }
}

}  // namespace

// pos, acc: [n, 2] f32 (acc is written).  rep_soft = repulsion * softening,
// eps2 = softening^2, both formed in f32 by the caller.
// (The record struct rps_<entry>_args of each entry: common.cuh, rps::unpack.)
struct rps_nbody_accel_args {
  const float* pos;
  float* acc;
  int n;
  float g_const, rep_soft, eps2;
  void* stream;
};

extern "C" int rps_nbody_accel(const void* packed, int size) {
  rps_nbody_accel_args r;
  if (!rps::unpack(packed, size, &r) || r.n < 1) return static_cast<int>(cudaErrorInvalidValue);
  nbody_kernel<<<(r.n + kBlockI - 1) / kBlockI, kThreads, 0,
                 static_cast<cudaStream_t>(r.stream)>>>(
      reinterpret_cast<const float2*>(r.pos), reinterpret_cast<float2*>(r.acc), r.n,
      r.g_const, r.rep_soft, r.eps2);
  return static_cast<int>(cudaGetLastError());
}
