// K8: all-pairs softened N-body accelerations, [n, 2] positions in, [n, 2]
// accelerations out.
//
// Replaces rust_particle_system_tpu/ops/pallas/nbody.py::_kernel (driven by
// nbody_accel_pallas):
//   a_i = sum_j delta_ij * (G s^3 - R eps s^4),  s = (|delta_ij|^2 + eps^2)^-1/2
// over every j, the particle itself included: its delta is 0, so it adds
// exactly 0 and needs no mask.
//
// Bound on the H100: arithmetic (about 20 operations and one reciprocal square
// root per pair, n^2 pairs), not memory (16 n bytes).  The TPU swept [256 x
// 1024] tiles of the pair matrix in VMEM and padded n with far-away ghost
// particles; here one thread owns one particle i and the block walks all j
// in tiles staged through shared memory (the classic GPU tiling: each
// position is read from device memory once per block, then broadcast from
// shared memory to every thread).  A ragged last tile is cut by its length,
// not padded.  Sums are float32, in j order.  rsqrtf (not correctly rounded)
// is the counterpart of the TPU's rsqrt: no threshold depends on it.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // i per block; also the j tile

__global__ void nbody_kernel(const float2* __restrict__ pos, float2* __restrict__ acc,
                             int n, float g_const, float rep_soft, float eps2) {
  __shared__ float2 tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float2 pi = i < n ? pos[i] : make_float2(0.0f, 0.0f);
  float ax = 0.0f, ay = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < n) tile[threadIdx.x] = pos[j];
    __syncthreads();
    const int m = min(kThreads, n - j0);
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const float dx = tile[k].x - pi.x, dy = tile[k].y - pi.y;
      const float d2 = dx * dx + dy * dy + eps2;
      const float inv = rsqrtf(d2);
      const float inv3 = inv * inv * inv;
      const float w = g_const * inv3 - rep_soft * inv3 * inv;
      ax += dx * w;
      ay += dy * w;
    }
    __syncthreads();
  }
  if (i < n) acc[i] = make_float2(ax, ay);
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
  nbody_kernel<<<(r.n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(r.stream)>>>(
      reinterpret_cast<const float2*>(r.pos), reinterpret_cast<float2*>(r.acc), r.n,
      r.g_const, r.rep_soft, r.eps2);
  return static_cast<int>(cudaGetLastError());
}
