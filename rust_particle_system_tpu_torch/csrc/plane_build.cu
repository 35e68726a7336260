// K5: cell-sorted particle rows -> cell slot planes.
//
// Replaces rust_particle_system_tpu/ops/pallas/plane_build.py::_make_roll_kernel
// (via cell_planes_aos).  Semantics (plane_build.py:86-94): slot s of cell c is
// row starts[c] + s while s < min(count_c, C); otherwise the channel's fill.
//
// Bound on the H100: pure data movement, n*k*4 bytes read and nc*C*k*4 written
// (~80 MB at the main-path shape), run once at init.  The TPU needed a
// two-row window gather plus a log-shift roll because it cannot gather per
// slot cheaply; here one thread per output element gathers its source word
// directly.  Consecutive threads write consecutive words, and consecutive
// slots of a cell read consecutive rows, so both sides coalesce.

#include "common.cuh"

namespace {

__global__ void plane_build_kernel(const float* __restrict__ rows,
                                   const int* __restrict__ starts,
                                   float* __restrict__ out, rps::Fills fills,
                                   int k, int nc, int C) {
  const long long total = static_cast<long long>(nc) * C * k;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % k);
    const long long cs = i / k;
    const int s = static_cast<int>(cs % C);
    const int c = static_cast<int>(cs / C);
    const int s0 = starts[c];
    const int count = min(starts[c + 1] - s0, C);
    out[i] = (s < count) ? rows[(static_cast<long long>(s0) + s) * k + ch]
                         : fills.v[ch];
  }
}

}  // namespace

static int plane_build(const float* rows, const int* starts, float* out,
                       const float* fills_host, int k, int nc, int C, void* stream) {
  if (k < 1 || k > rps::kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  rps::Fills fills{};
  for (int i = 0; i < k; ++i) fills.v[i] = fills_host[i];
  const long long total = static_cast<long long>(nc) * C * k;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? (want > 0 ? want : 1) : 65536);
  plane_build_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, starts, out, fills, k, nc, C);
  return static_cast<int>(cudaGetLastError());
}

// (Its arguments: the record struct below, common.cuh's rps::unpack.)
struct rps_plane_build_args {
  const float* rows;
  const int* starts;
  float* out;
  float fills[8];
  int k, nc, C;
  void* stream;
};

extern "C" int rps_plane_build(const void* packed, int size) {
  rps_plane_build_args r;
  if (!rps::unpack(packed, size, &r)) return static_cast<int>(cudaErrorInvalidValue);
  return plane_build(r.rows, r.starts, r.out, r.fills, r.k, r.nc, r.C, r.stream);
}
