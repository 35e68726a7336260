// K13a-e: toolchain probes.  Not hot-path kernels: each pins one numeric
// property of this toolchain and card that the port relies on, as the TPU
// probes of tools/tpu_smoke.py and protos/bf16_repro.py pinned Mosaic's.
//
// K13a rps_probe_dot_f32   C = A B on the CUDA cores in float32, k in order,
//      one fmaf per step for each output.  Replaces the in-kernel dot at
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
// Bound: each moves at most a few hundred KB and does at most 2 x 128^3
// operations (0.00006 ms at the FP32 peak); none comes near its bound, and a
// call's time is the host's launch path (ops/cuda/_lib.py) plus the
// launch latency and the dependent memory round trips inside the kernel.
// K13a's design cuts those round trips: the old one-thread-per-output loop
// read A and B from device memory 128 times each, with 128 dependent loads
// per thread.  Now a block computes a 16 x 32 tile of C from 64-deep chunks
// of A and B staged in shared memory by cp.async, double-buffered (2 chunks
// in flight at 128^3), and each of its 128 threads keeps 4 outputs of one
// row in registers.  The sums still run over k in order with one fmaf per
// step from 0, so K13a stays bit-equal to the one-thread loop and to
// dot_f32_plain, and the one-hot product stays bit-exact.  It stays FP32 on
// the CUDA cores: TF32 is the trap K13b pins.  K13c moves 8 KB: it reads and
// writes 16 bytes a thread where both pointers allow (a scalar tail covers
// n % 4), a quarter of the memory instructions of one float a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

// K13a's tile: kBM x kBN outputs a block, kTN a thread (one row), chunks of
// kBK along k.  A's rows are padded by 4 floats, so the 4 rows a warp reads
// at one k lie in 4 different banks.
constexpr int kBM = 16, kBN = 32, kBK = 64, kTN = 4;
constexpr int kDotThreads = kBM * kBN / kTN;  // 128
constexpr int kAStride = kBK + 4;

// One float from device to shared memory by cp.async; `valid` false fills 0
// and reads nothing (the source is then any valid address).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__global__ void __launch_bounds__(kDotThreads)
    dot_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c, int M, int N, int K) {
  __shared__ float as[2][kBM * kAStride];
  __shared__ __align__(16) float bs[2][kBK * kBN];
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int row = t / (kBN / kTN), col = (t % (kBN / kTN)) * kTN;

  // Chunk k0 .. k0 + kBK - 1 of A's and B's tiles into buffer `buf`, zeros
  // outside the matrices; neighbouring threads take neighbouring columns.
  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kDotThreads; ++i) {
      const int e = t + i * kDotThreads, r = e / kBK, k = e % kBK;
      const bool ok = m0 + r < M && k0 + k < K;
      cp_async_f32(&as[buf][r * kAStride + k],
                   ok ? a + static_cast<long long>(m0 + r) * K + k0 + k : a, ok);
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kDotThreads; ++i) {
      const int e = t + i * kDotThreads, k = e / kBN, n = e % kBN;
      const bool ok = k0 + k < K && n0 + n < N;
      cp_async_f32(&bs[buf][k * kBN + n],
                   ok ? b + static_cast<long long>(k0 + k) * N + n0 + n : b, ok);
    }
    cp_async_commit();
  };

  float acc[kTN] = {0.0f, 0.0f, 0.0f, 0.0f};
  // k in order, one fmaf a step from 0: the one-thread-per-output sum.
  auto step = [&](int buf, int k) {
    const float x = as[buf][row * kAStride + k];
    const float4 y = *reinterpret_cast<const float4*>(&bs[buf][k * kBN + col]);
    acc[0] = fmaf(x, y.x, acc[0]);
    acc[1] = fmaf(x, y.y, acc[1]);
    acc[2] = fmaf(x, y.z, acc[2]);
    acc[3] = fmaf(x, y.w, acc[3]);
  };
  const int chunks = (K + kBK - 1) / kBK;
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < chunks) {  // the next chunk flies while this one is summed
      stage(buf ^ 1, (ch + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kn = min(kBK, K - ch * kBK);
    if (kn == kBK) {
#pragma unroll 16
      for (int k = 0; k < kBK; ++k) step(buf, k);
    } else {
      for (int k = 0; k < kn; ++k) step(buf, k);
    }
    __syncthreads();  // the buffer is restaged two chunks on
  }
  const int m = m0 + row;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < kTN; ++j)
    if (n0 + col + j < N) c[static_cast<long long>(m) * N + n0 + col + j] = acc[j];
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

// o = x * scale: thread i takes floats 4i .. 4i + 3 in one 16-byte load and
// store (kVec, both pointers 16-byte aligned), the first n % 4 threads the
// tail; else one float a thread.  A plain multiply, no -ftz: subnormals stay.
template <bool kVec>
__global__ void copy_kernel(const float* __restrict__ x, float* __restrict__ o, int n,
                            float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kVec) {
    if (i < n) o[i] = x[i] * scale;
    return;
  }
  const int n4 = n >> 2;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    reinterpret_cast<float4*>(o)[i] = v;
  }
  if (i < (n & 3)) o[4 * n4 + i] = x[4 * n4 + i] * scale;
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

// Each entry takes its arguments as the record struct rps_<entry>_args
// (common.cuh, rps::unpack).

// a: [M, K], b: [K, N], c: [M, N], all float32 row-major.
struct rps_probe_dot_f32_args {
  const float* a;
  const float* b;
  float* c;
  int M, N, K;
  void* stream;
};

extern "C" int rps_probe_dot_f32(const void* packed, int size) {
  rps_probe_dot_f32_args r;
  if (!rps::unpack(packed, size, &r) || r.M < 1 || r.N < 1 || r.K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((r.N + kBN - 1) / kBN, (r.M + kBM - 1) / kBM);
  dot_f32_kernel<<<grid, kDotThreads, 0, static_cast<cudaStream_t>(r.stream)>>>(
      r.a, r.b, r.c, r.M, r.N, r.K);
  return static_cast<int>(cudaGetLastError());
}

// As rps_probe_dot_f32 with M % 16 == 0, N % 8 == 0, K % 8 == 0.
struct rps_probe_dot_tf32_args {
  const float* a;
  const float* b;
  float* c;
  int M, N, K;
  void* stream;
};

extern "C" int rps_probe_dot_tf32(const void* packed, int size) {
  rps_probe_dot_tf32_args r;
  if (!rps::unpack(packed, size, &r) || r.M < 16 || r.N < 8 || r.K < 8 || r.M % 16 ||
      r.N % 8 || r.K % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  dot_tf32_kernel<<<dim3(r.N / 8, r.M / 16), 32, 0, static_cast<cudaStream_t>(r.stream)>>>(
      r.a, r.b, r.c, r.N, r.K);
  return static_cast<int>(cudaGetLastError());
}

// o[i] = x[i] * scale for i < n.
struct rps_probe_copy_args {
  const float* x;
  float* o;
  int n;
  float scale;
  void* stream;
};

extern "C" int rps_probe_copy(const void* packed, int size) {
  rps_probe_copy_args r;
  if (!rps::unpack(packed, size, &r) || r.n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(r.stream);
  const uintptr_t either = reinterpret_cast<uintptr_t>(r.x) | reinterpret_cast<uintptr_t>(r.o);
  if (either % 16 == 0) {
    const int threads = r.n / 4 > 0 ? r.n / 4 : 1;
    copy_kernel<true><<<(threads + 255) / 256, 256, 0, st>>>(r.x, r.o, r.n, r.scale);
  } else {
    copy_kernel<false><<<(r.n + 255) / 256, 256, 0, st>>>(r.x, r.o, r.n, r.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [rows, W] bfloat16; o: rows * W float32 values (row 0 broadcast).
struct rps_probe_bf16_args {
  const void* x;
  float* o;
  int rows, W;
  void* stream;
};

extern "C" int rps_probe_bf16(const void* packed, int size) {
  rps_probe_bf16_args r;
  if (!rps::unpack(packed, size, &r) || r.rows < 1 || r.W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = r.rows * r.W;
  bf16_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(r.stream)>>>(
      static_cast<const __nv_bfloat16*>(r.x), r.o, n, r.W);
  return static_cast<int>(cudaGetLastError());
}

// a: [rows, Wa] float32 (columns 0..A-1 used), b: [rows, B] float32,
// o: [rows, A, B] float32.
struct rps_probe_bf16_outer_args {
  const float* a;
  const float* b;
  float* o;
  int rows, Wa, A, B;
  void* stream;
};

extern "C" int rps_probe_bf16_outer(const void* packed, int size) {
  rps_probe_bf16_outer_args r;
  if (!rps::unpack(packed, size, &r) || r.rows < 1 || r.A < 1 || r.B < 1 || r.A > r.Wa)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = r.rows * r.A * r.B;
  bf16_outer_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(r.stream)>>>(
      r.a, r.b, r.o, n, r.Wa, r.A, r.B);
  return static_cast<int>(cudaGetLastError());
}
