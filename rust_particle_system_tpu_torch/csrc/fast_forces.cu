// K14a and K14c: the per-cell stages of the fast mode, a lossy moment-transfer
// (FMM M2L) force for the poly-in-d^2 SPH family.
//
// K14a rps_fm_moments replaces protos/mxu_fast_forces.py::make_moment_kernel
// (driven by moments, the pallas_call at :182): per cell and weight channel c,
//   M[cell, c, 16a + b] = sum_slots w_c * T_a(u) * T_b(v),   a, b < NB,
// and 0 in the rest of the [16, 16] block.  K14c rps_fm_eval replaces
// make_eval_kernel (driven by evaluate, the pallas_call at :264): per cell,
// output pair p and live slot,
//   E_p[slot] = sum_a T_a(u) * sum_b L[cell, p, 16a + b] * T_b(v),
// and 0 on dead slots.  u = 2 (x - x_min - cx h) / h - 1 (v likewise, 0 on
// dead slots); T_0 = 1, T_1 = t, T_k = 2t T_{k-1} - T_{k-2}.
//
// Bound on the H100: bytes.  Per live slot K14a does ~340 n_w flops, K14c
// ~364 n_pairs, against 1 KB a cell of moments written (n_w = 4) or ~0.7 KB
// of transfers read (7 pairs, the 169 used of each 256).  The TPU ran both as
// batched [13, C] x [C, 13] mini-matmuls over 8 cells a program; here K14a
// stages the slots' 13 T_a(u) and 13 T_b(v) in shared memory and thread
// 16a + b of a 256-thread block sums its (a, b) over the slots for every
// channel, one block per cell; K14c stages the cell's n_pairs transfer blocks
// in shared memory and each thread takes a slot, builds its T_a(u), T_b(v) in
// registers and contracts them with every block.  Tensor cores (mma.sync or
// wgmma for the [13, C] x [C, 13] products) are left for a later version.
//
// The element-wise steps (u, v and the recurrence) use _rn intrinsics, so nvcc
// contracts none of them into an FMA and they round as the plain PyTorch
// version does op for op; only the order of the sums over slots and over b
// differs from torch.bmm's.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kPad = 16;         // the [16, 16] block of one (cell, channel)
constexpr int kBlock = kPad * kPad;  // K14a: thread 16a + b
constexpr int kMaxWeights = 4;

struct Geom {
  int gw, C, nb;
  float x_min, y_min, h;
};

// Cell-local coordinate of x in a cell starting at lo + c h: JAX's
// 2.0 * (x - lo - c * h) / h - 1.0, op by op.
__device__ __forceinline__ float local(float x, float lo, float c, float h) {
  const float d = __fsub_rn(__fsub_rn(x, lo), __fmul_rn(c, h));
  return __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, d), h), 1.0f);
}

// T_0..T_{kPad-1}(t) into t_out[k] (k < nb are meaningful); the loop is
// unrolled so that a register array stays in registers.
__device__ __forceinline__ void cheb(float t, int nb, float (&tk)[kPad]) {
  const float t2 = __fmul_rn(2.0f, t);
  tk[0] = 1.0f;
  tk[1] = t;
#pragma unroll
  for (int k = 2; k < kPad; ++k)
    tk[k] = k < nb ? __fsub_rn(__fmul_rn(t2, tk[k - 1]), tk[k - 2]) : 0.0f;
}

// JAX: cell = program row as f32, cy = floor(cell / gw), cx = cell - cy * gw.
__device__ __forceinline__ void cell_xy(int cell, int gw, float& cx, float& cy) {
  const float cf = static_cast<float>(cell);
  cy = floorf(__fdiv_rn(cf, static_cast<float>(gw)));
  cx = __fsub_rn(cf, __fmul_rn(cy, static_cast<float>(gw)));
}

// K14a: one block of 256 threads per cell.  Shared: T_a(u) and T_b(v) as
// [C][16] and the masked weights as [n_w][C].
__global__ void fm_moments_kernel(const float* __restrict__ px, const float* __restrict__ py,
                                  rps::InPlanes w, float* __restrict__ m, int n_w, Geom g) {
  extern __shared__ float sh[];
  float* tu = sh;
  float* tv = tu + g.C * kPad;
  float* ws = tv + g.C * kPad;
  const int cell = blockIdx.x;
  float cx, cy;
  cell_xy(cell, g.gw, cx, cy);
  const size_t base = static_cast<size_t>(cell) * g.C;
  for (int s = threadIdx.x; s < g.C; s += blockDim.x) {
    const float x = px[base + s], y = py[base + s];
    const bool live = x < rps::kLiveBelow;
    float t[kPad];
    cheb(live ? local(x, g.x_min, cx, g.h) : 0.0f, g.nb, t);
#pragma unroll
    for (int k = 0; k < kPad; ++k) tu[s * kPad + k] = t[k];
    cheb(live ? local(y, g.y_min, cy, g.h) : 0.0f, g.nb, t);
#pragma unroll
    for (int k = 0; k < kPad; ++k) tv[s * kPad + k] = t[k];
#pragma unroll
    for (int c = 0; c < kMaxWeights; ++c)
      if (c < n_w) ws[c * g.C + s] = live ? w.p[c][base + s] : 0.0f;
  }
  __syncthreads();
  const int a = threadIdx.x / kPad, b = threadIdx.x % kPad;
  const bool used = a < g.nb && b < g.nb;
  float acc[kMaxWeights] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (used) {
    for (int s = 0; s < g.C; ++s) {
      const float ta = tu[s * kPad + a], tb = tv[s * kPad + b];
#pragma unroll
      for (int c = 0; c < kMaxWeights; ++c)
        if (c < n_w) acc[c] = fmaf(__fmul_rn(ws[c * g.C + s], ta), tb, acc[c]);
    }
  }
  float* out = m + static_cast<size_t>(cell) * n_w * kBlock + threadIdx.x;
#pragma unroll
  for (int c = 0; c < kMaxWeights; ++c)
    if (c < n_w) out[c * kBlock] = used ? acc[c] : 0.0f;
}

// K14c: one block per cell, thread s owns slot s.  Shared: the cell's
// n_pairs transfer blocks.
__global__ void fm_eval_kernel(const float* __restrict__ px, const float* __restrict__ py,
                               const float* __restrict__ L, rps::OutPlanes out, int n_pairs,
                               Geom g) {
  __shared__ float ls[rps::kMaxChannels * kBlock];
  const int cell = blockIdx.x;
  const float* lc = L + static_cast<size_t>(cell) * n_pairs * kBlock;
  for (int i = threadIdx.x; i < n_pairs * kBlock; i += blockDim.x) ls[i] = lc[i];
  __syncthreads();
  float cx, cy;
  cell_xy(cell, g.gw, cx, cy);
  const size_t base = static_cast<size_t>(cell) * g.C;
  for (int s = threadIdx.x; s < g.C; s += blockDim.x) {
    const float x = px[base + s], y = py[base + s];
    const bool live = x < rps::kLiveBelow;
    float tu[kPad], tv[kPad];
    cheb(live ? local(x, g.x_min, cx, g.h) : 0.0f, g.nb, tu);
    cheb(live ? local(y, g.y_min, cy, g.h) : 0.0f, g.nb, tv);
    rps::for_channels(n_pairs, [&](int p) {
      const float* lp = ls + p * kBlock;
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < kPad; ++a) {
        if (a < g.nb) {
          float ya = 0.0f;
#pragma unroll
          for (int b = 0; b < kPad; ++b)
            if (b < g.nb) ya = fmaf(lp[a * kPad + b], tv[b], ya);
          acc = __fadd_rn(acc, __fmul_rn(tu[a], ya));
        }
      }
      out.p[p][base + s] = live ? acc : 0.0f;
    });
  }
}

}  // namespace

// px, py: [nc, C] planes; w_host: n_w (1..4) weight plane pointers; m:
// [nc, n_w, 256] (written whole).  nb = deg + 1 in 2..16; C <= 256.
static int fm_moments(const float* px, const float* py, const float* const* w_host, float* m,
                      int n_w, int nc, int gw, int C, int nb, float x_min, float y_min,
                      float h, void* stream) {
  if (n_w < 1 || n_w > kMaxWeights || nc < 1 || gw < 1 || C < 1 || C > 256 || nb < 2 ||
      nb > kPad)
    return static_cast<int>(cudaErrorInvalidValue);
  rps::InPlanes w{};
  for (int c = 0; c < n_w; ++c) w.p[c] = w_host[c];
  const size_t shmem = static_cast<size_t>(C) * (2 * kPad + n_w) * sizeof(float);
  fm_moments_kernel<<<nc, kBlock, shmem, static_cast<cudaStream_t>(stream)>>>(
      px, py, w, m, n_w, Geom{gw, C, nb, x_min, y_min, h});
  return static_cast<int>(cudaGetLastError());
}

// px, py: [nc, C] planes; L: [nc, n_pairs, 256]; out_host: n_pairs (1..8)
// output plane pointers ([nc, C] each).  nb = deg + 1 in 2..16; C <= 1024.
static int fm_eval(const float* px, const float* py, const float* L, float* const* out_host,
                   int n_pairs, int nc, int gw, int C, int nb, float x_min, float y_min,
                   float h, void* stream) {
  if (n_pairs < 1 || n_pairs > rps::kMaxChannels || nc < 1 || gw < 1 || C < 1 || C > 1024 ||
      nb < 2 || nb > kPad)
    return static_cast<int>(cudaErrorInvalidValue);
  rps::OutPlanes out{};
  for (int p = 0; p < n_pairs; ++p) out.p[p] = out_host[p];
  fm_eval_kernel<<<nc, rps::block_threads(C), 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, L, out, n_pairs, Geom{gw, C, nb, x_min, y_min, h});
  return static_cast<int>(cudaGetLastError());
}

// The entries' arguments: the record structs below, common.cuh's rps::unpack.
struct rps_fm_moments_args {
  const float* px;
  const float* py;
  const float* w[8];  // the first n_w <= kMaxWeights are read
  float* m;
  int n_w, nc, gw, C, nb;
  float x_min, y_min, h;
  void* stream;
};
static_assert(kMaxWeights <= 8, "rps_fm_moments_args holds 8 weight-plane slots");

extern "C" int rps_fm_moments(const void* packed, int size) {
  rps_fm_moments_args r;
  if (!rps::unpack(packed, size, &r)) return static_cast<int>(cudaErrorInvalidValue);
  return fm_moments(r.px, r.py, r.w, r.m, r.n_w, r.nc, r.gw, r.C, r.nb, r.x_min, r.y_min,
                    r.h, r.stream);
}

struct rps_fm_eval_args {
  const float* px;
  const float* py;
  const float* L;
  float* out[8];
  int n_pairs, nc, gw, C, nb;
  float x_min, y_min, h;
  void* stream;
};

extern "C" int rps_fm_eval(const void* packed, int size) {
  rps_fm_eval_args r;
  if (!rps::unpack(packed, size, &r)) return static_cast<int>(cudaErrorInvalidValue);
  return fm_eval(r.px, r.py, r.L, r.out, r.n_pairs, r.nc, r.gw, r.C, r.nb, r.x_min, r.y_min,
                 r.h, r.stream);
}
