// Shared helpers for the plane kernels (sm_90a, plain C interface).
//
// Layout contract (the port's ops/cuda/*.py): every plane is a contiguous
// float32 [gh, gw, C] tensor; slot s of cell (r, c) sits at ((r*gw + c)*C + s).
// Dead slots carry x = y = SENTINEL.  A per-cell kernel gives one block to
// one cell; its blockDim.x is C rounded up to a multiple of 32, thread s owns
// slot s, and threads s >= C only take part in the block-wide ballots.  (The
// strip walks of sph.cu map threads to live particles instead.)
#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace rps {

constexpr float kSentinel = 1.0e6f;
constexpr float kLiveBelow = 0.5f * kSentinel;  // live <=> x < 0.5 * SENTINEL
constexpr int kMaxChannels = 8;  // also the length of the records' plane arrays

struct Fills {
  float v[kMaxChannels];
};

// The k channel planes of a call, passed by value (channel 0 is x, 1 is y).
struct InPlanes {
  const float* p[kMaxChannels];
};
struct OutPlanes {
  float* p[kMaxChannels];
};

// Runs f(ch) for ch < k.  The loop is unrolled to kMaxChannels so that
// in.p[ch], out.p[ch] and fills.v[ch] index the kernel parameters with
// constants: a run-time index would copy the parameter structs to local memory.
template <class F>
__device__ __forceinline__ void for_channels(int k, F f) {
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch)
    if (ch < k) f(ch);
}

// clip(int(floor((v - lo) / width)), 0, n - 1): the IEEE expression of the
// JAX package's keying (ops/grid.py::cell_coords, rebin.py:489-494).  Built
// without --use_fast_math, so '/' is the correctly rounded division.
__device__ __forceinline__ int cell_of(float v, float lo, float width, int n) {
  int k = static_cast<int>(floorf((v - lo) / width));
  return min(max(k, 0), n - 1);
}

// Block-wide inclusive prefix counts of NF predicates at once: warp ballots
// and popcounts, then the warps' totals through shared memory.  `scratch`
// holds NF * 32 ints.  Every thread of the block must call it (it contains
// two __syncthreads).  incl[f] counts threads t <= threadIdx.x with p[f];
// total[f] counts the whole block.
template <int NF>
__device__ __forceinline__ void block_count(const bool (&p)[NF], int (&incl)[NF],
                                            int (&total)[NF], int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0..lane
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const unsigned b = __ballot_sync(0xffffffffu, p[f]);
    incl[f] = __popc(b & upto);
    if (lane == 0) scratch[f * 32 + warp] = __popc(b);
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    int before = 0, all = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int t = scratch[f * 32 + w];
      before += (w < warp) ? t : 0;
      all += t;
    }
    incl[f] += before;
    total[f] = all;
  }
  __syncthreads();
}

inline int block_threads(int C) { return ((C + 31) / 32) * 32; }

// Every C entry rps_<name>(const void* packed, int size) takes its arguments
// as one record: the bytes of struct rps_<name>_args as this compiler lays it
// out, which the binding (ops/cuda/_lib.py, RECORDS) packs field by field in
// native layout.  The entry refuses a record of any other size.
template <class T>
inline bool unpack(const void* packed, int size, T* out) {
  if (packed == nullptr || size != static_cast<int>(sizeof(T))) return false;
  std::memcpy(out, packed, sizeof(T));
  return true;
}

}  // namespace rps
