// K13a-e: toolchain probes.  Not hot-path kernels: each pins one numeric
// property of this toolchain and card that the port relies on, as the TPU
// probes of tools/tpu_smoke.py and protos/bf16_repro.py pinned Mosaic's.
//
// K13a rps_probe_dot_f32   C = A B on the CUDA cores in float32, one thread
//      per output, k in order, one fmaf each.  Replaces the in-kernel dot at
//      Precision.HIGHEST of tools/tpu_smoke.py:71 (smoke_dot_precision_trap)
//      and :104 (smoke_onehot_passthrough_precision): full float32, and a
//      one-hot product passes values through bit for bit.
// K13b rps_probe_dot_tf32  the same product on the tensor cores in TF32:
//      mma.sync.aligned.m16n8k8 with each input rounded by cvt.rna.tf32.f32,
//      one warp per 16 x 8 tile of C.  The Hopper analog of the TPU's
//      DEFAULT-precision in-kernel dot (tpu_smoke.py:71): the trap that a
//      float32 product silently keeps ~10 mantissa bits.
// K13c rps_probe_copy      o = x * scale with scale = 1 passed at run time,
//      so the multiply is executed.  Replaces tpu_smoke.py:138
//      (smoke_ids_f32_roundtrip): integers to 2^24 and subnormals survive;
//      the build has no -ftz=true or --use_fast_math.
// K13d rps_probe_bf16      row 0 of an [R, W] bfloat16 array broadcast over
//      the R rows, viewed as [R / 2, 2W], written as float32.  Replaces
//      protos/bf16_repro.py:31 (kernel).
// K13e rps_probe_bf16_outer  o[r, i, j] = bf16(a[r, i]) * bf16(b[r, j]),
//      the product rounded to bfloat16, written as float32: the cast-then-
//      new-axis outer product of protos/bf16_repro.py:65 (main_round4).
//
// Bound: each moves at most a few hundred KB and does at most 128^3
// multiply-adds; launch latency sets their time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void dot_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               float* __restrict__ c, int M, int N, int K) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  const int i = idx / N, j = idx % N;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc = fmaf(a[i * K + k], b[k * N + j], acc);
  c[idx] = acc;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// One warp per 16 x 8 tile of C; A row-major [M, K], B row-major [K, N].
// Fragment layouts of mma.m16n8k8 with .tf32 (PTX ISA): g = lane / 4,
// q = lane % 4; A: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4);
// B: b0 (q, g), b1 (q + 4, g); C: c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q),
// c3 (g + 8, 2q + 1).
__global__ void dot_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ c, int N, int K) {
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.y * 16, n0 = blockIdx.x * 8;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const uint32_t a0 = to_tf32(a[(r0 + g) * K + k0 + q]);
    const uint32_t a1 = to_tf32(a[(r0 + g + 8) * K + k0 + q]);
    const uint32_t a2 = to_tf32(a[(r0 + g) * K + k0 + q + 4]);
    const uint32_t a3 = to_tf32(a[(r0 + g + 8) * K + k0 + q + 4]);
    const uint32_t b0 = to_tf32(b[(k0 + q) * N + n0 + g]);
    const uint32_t b1 = to_tf32(b[(k0 + q + 4) * N + n0 + g]);
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(d0), "f"(d1),
          "f"(d2), "f"(d3));
  }
  c[(r0 + g) * N + n0 + 2 * q] = d0;
  c[(r0 + g) * N + n0 + 2 * q + 1] = d1;
  c[(r0 + g + 8) * N + n0 + 2 * q] = d2;
  c[(r0 + g + 8) * N + n0 + 2 * q + 1] = d3;
}

__global__ void copy_kernel(const float* __restrict__ x, float* __restrict__ o, int n,
                            float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * scale;
}

// The broadcast tile's flat element f is row 0's element f % W, whatever
// shape the tile is viewed as.
__global__ void bf16_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ o,
                            int n, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = __bfloat162float(x[i % W]);
}

// Thread (r, i, j) of o [R, A, B]; a is [R, Wa] (its first A columns are
// read), b is [R, B].  Each input is rounded to bfloat16, the product of two
// bfloat16 values is rounded to bfloat16 (mul.rn.bf16), then widened.
__global__ void bf16_outer_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  float* __restrict__ o, int n, int Wa, int A, int B) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int j = f % B, i = (f / B) % A, r = f / (A * B);
  const __nv_bfloat16 x = __float2bfloat16_rn(a[r * Wa + i]);
  const __nv_bfloat16 y = __float2bfloat16_rn(b[r * B + j]);
  o[f] = __bfloat162float(__hmul(x, y));
}

}  // namespace

// a: [M, K], b: [K, N], c: [M, N], all float32 row-major.
extern "C" int rps_probe_dot_f32(const float* a, const float* b, float* c, int M, int N,
                                 int K, void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  dot_f32_kernel<<<(M * N + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// As rps_probe_dot_f32 with M % 16 == 0, N % 8 == 0, K % 8 == 0.
extern "C" int rps_probe_dot_tf32(const float* a, const float* b, float* c, int M, int N,
                                  int K, void* stream) {
  if (M < 16 || N < 8 || K < 8 || M % 16 || N % 8 || K % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  dot_tf32_kernel<<<dim3(N / 8, M / 16), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, N, K);
  return static_cast<int>(cudaGetLastError());
}

// o[i] = x[i] * scale for i < n.
extern "C" int rps_probe_copy(const float* x, float* o, int n, float scale, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, o, n, scale);
  return static_cast<int>(cudaGetLastError());
}

// x: [rows, W] bfloat16; o: rows * W float32 values (row 0 broadcast).
extern "C" int rps_probe_bf16(const void* x, float* o, int rows, int W, void* stream) {
  if (rows < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = rows * W;
  bf16_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), o, n, W);
  return static_cast<int>(cudaGetLastError());
}

// a: [rows, Wa] float32 (columns 0..A-1 used), b: [rows, B] float32,
// o: [rows, A, B] float32.
extern "C" int rps_probe_bf16_outer(const float* a, const float* b, float* o, int rows, int Wa,
                                    int A, int B, void* stream) {
  if (rows < 1 || A < 1 || B < 1 || A > Wa) return static_cast<int>(cudaErrorInvalidValue);
  const int n = rows * A * B;
  bf16_outer_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, o, n, Wa, A, B);
  return static_cast<int>(cudaGetLastError());
}
