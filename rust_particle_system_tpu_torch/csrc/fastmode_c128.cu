// K14d-f: the fast mode's stage A and C contraction forms at C = 128 slots a
// cell, on a synthetic basis (protos/fastmode_c128.py).  The TPU probe times
// the two native forms a cell-per-row layout allows; the basis is built from
// the per-(cell, slot) weights w instead of from positions, so the probe
// measures the contraction and not the Chebyshev recurrence.  With
// phi_a(s) = w[s] * a + a (a the basis index, as float32):
//
// K14d rps_c128_a_dot  (make_a_dot, the pallas_call at :91)
//        out[cell, a, b] = sum_s (phi_a(s) * w[s]) * phi_b(s),  a, b < 13;
// K14e rps_c128_a_vpu  (make_a_vpu, :119)
//        out[cell, r] = sum_s phi_r(s) * w[s],                   r < 176;
// K14f rps_c128_c_vpu  (make_c_vpu, :147)
//        out[cell, s] = sum_r phi_r(s) * L[cell, r],             s < 128.
//
// One block per cell: the cell's 128 weights (and for K14f its 176 L values)
// are staged in shared memory; a thread per output element forms phi with
// _rn intrinsics (no FMA contraction, as the plain version rounds it) and
// sums its terms in slot (or r) order with fmaf.  Bound on the H100: FP32
// operations (~0.4-0.8 G a call against ~10 MB moved).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kB1 = 13;    // deg-12 1-D basis
constexpr int kB2P = 176;  // 169 2-D terms padded to the TPU's sublane tile
constexpr int kCP = 128;   // slots a cell

__device__ __forceinline__ float phi(float w, float a) {
  return __fadd_rn(__fmul_rn(w, a), a);
}

// K14d: block = cell, thread 13a + b (169 threads).
__global__ void a_dot_kernel(const float* __restrict__ w, float* __restrict__ out) {
  __shared__ float ws[kCP];
  const int cell = blockIdx.x;
  for (int s = threadIdx.x; s < kCP; s += blockDim.x) ws[s] = w[cell * kCP + s];
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= kB1 * kB1) return;
  const float a = static_cast<float>(t / kB1), b = static_cast<float>(t % kB1);
  float acc = 0.0f;
  for (int s = 0; s < kCP; ++s) {
    const float x = ws[s];
    acc = fmaf(__fmul_rn(phi(x, a), x), phi(x, b), acc);
  }
  out[cell * kB1 * kB1 + t] = acc;
}

// K14e: block = cell, thread r (176 threads).
__global__ void a_vpu_kernel(const float* __restrict__ w, float* __restrict__ out) {
  __shared__ float ws[kCP];
  const int cell = blockIdx.x;
  for (int s = threadIdx.x; s < kCP; s += blockDim.x) ws[s] = w[cell * kCP + s];
  __syncthreads();
  const int r = threadIdx.x;
  const float rf = static_cast<float>(r);
  float acc = 0.0f;
  for (int s = 0; s < kCP; ++s) acc = fmaf(phi(ws[s], rf), ws[s], acc);
  out[cell * kB2P + r] = acc;
}

// K14f: block = cell, thread s (128 threads).
__global__ void c_vpu_kernel(const float* __restrict__ w, const float* __restrict__ l,
                             float* __restrict__ out) {
  __shared__ float ls[kB2P];
  const int cell = blockIdx.x;
  for (int r = threadIdx.x; r < kB2P; r += blockDim.x) ls[r] = l[cell * kB2P + r];
  __syncthreads();
  const int s = threadIdx.x;
  const float x = w[cell * kCP + s];
  float acc = 0.0f;
  for (int r = 0; r < kB2P; ++r) acc = fmaf(phi(x, static_cast<float>(r)), ls[r], acc);
  out[cell * kCP + s] = acc;
}

}  // namespace

// Each entry takes its arguments as the record struct rps_<entry>_args
// (common.cuh, rps::unpack).

// w: [n_cells, 128]; out: [n_cells, 13, 13].
struct rps_c128_a_dot_args {
  const float* w;
  float* out;
  int n_cells;
  void* stream;
};

extern "C" int rps_c128_a_dot(const void* packed, int size) {
  rps_c128_a_dot_args r;
  if (!rps::unpack(packed, size, &r) || r.n_cells < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a_dot_kernel<<<r.n_cells, kB1 * kB1, 0, static_cast<cudaStream_t>(r.stream)>>>(r.w, r.out);
  return static_cast<int>(cudaGetLastError());
}

// w: [n_cells, 128]; out: [n_cells, 176].
struct rps_c128_a_vpu_args {
  const float* w;
  float* out;
  int n_cells;
  void* stream;
};

extern "C" int rps_c128_a_vpu(const void* packed, int size) {
  rps_c128_a_vpu_args r;
  if (!rps::unpack(packed, size, &r) || r.n_cells < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a_vpu_kernel<<<r.n_cells, kB2P, 0, static_cast<cudaStream_t>(r.stream)>>>(r.w, r.out);
  return static_cast<int>(cudaGetLastError());
}

// w: [n_cells, 128], l: [n_cells, 176]; out: [n_cells, 128].
struct rps_c128_c_vpu_args {
  const float* w;
  const float* l;
  float* out;
  int n_cells;
  void* stream;
};

extern "C" int rps_c128_c_vpu(const void* packed, int size) {
  rps_c128_c_vpu_args r;
  if (!rps::unpack(packed, size, &r) || r.n_cells < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  c_vpu_kernel<<<r.n_cells, kCP, 0, static_cast<cudaStream_t>(r.stream)>>>(r.w, r.l, r.out);
  return static_cast<int>(cudaGetLastError());
}
