// K11: the cell-binned point splat.  Soft-disc sprites of particles binned
// into 8 x 8-pixel render cells, each drawn over its cell's 16 x 16 patch,
// summed straight into the [H, W, 3] and [H, W] image accumulators.
//
// Replaces rust_particle_system_tpu/render/splat_pallas.py::_splat_kernel
// (driven by splat_pallas), with the patch assembly (_assemble) folded in.
//
// Contract (splat_pallas.py:45-107).  The particles are sorted by render cell
// (perm: sorted row -> particle; starts: [gh*gw + 1] run starts).  Cell (cx,
// cy) draws the first min(count, cap) particles of its run, in sort order,
// over the patch whose top-left pixel is (8 cx - 4, 8 cy - 4).  A particle at
// pixel position (px, py) adds alpha * (r, g, b) and alpha at a patch pixel
// with centre (fx, fy): d = sqrt(dx*dx + dy*dy), dx = fx - px,
// tt = clip((d - edge0) / width, 0, 1), alpha = 1 - tt*tt*(3 - 2*tt), and
// alpha < 0.01 -> 0.  Image pixel (y, x) is the sum over the patches that
// cover it.
//
// Design: a pixel gather, no atomics, so the output is deterministic.  One
// block of 64 threads serves one canvas tile of 8 x 8 pixels, offset by the
// 4-pixel margin: tile (ty, tx) holds the pixels (8 ty - 4 + iy,
// 8 tx - 4 + ix), and they lie in exactly the patches of the cells (ty, tx),
// (ty, tx - 1), (ty - 1, tx), (ty - 1, tx - 1): quadrants (0, 0), (0, 1),
// (1, 0), (1, 1) of those patches.  The block stages the drawn particles of
// those <= 4 cells in shared memory, read through perm from the unsorted
// arrays (5 floats a slot: <= 4 * cap * 20 bytes, 5 KB at cap 64); each thread
// then sums its pixel in the Pallas kernel's order: quadrant by quadrant, each
// quadrant's patch sum over its slots in order, added to the pixel's total.
// No [cells, cap, 256] tile, no patch planes and no assembly pass reach
// device memory.  Every product, sum, the division and the square root are
// rounded op by op (_rn intrinsics, no contraction into FMAs): alpha feeds a
// threshold, as in K4 (splat_planes.cu).
//
// Bound on the H100: operations, not bytes.  At 1080p with 1M particles and
// cap 64 it does about 1M x 256 (slot, pixel) evaluations, each a sqrt, a
// division and a smoothstep; it reads 20 bytes a particle plus perm and
// starts (about 25 MB) and writes 4 * H * W floats (33 MB).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kStride = 8;   // render-cell extent in pixels
constexpr int kMargin = 4;   // patch margin on each side
constexpr int kThreads = kStride * kStride;  // one thread per tile pixel

struct Cells {
  int ld, gw, gh, cap, H, W;
  float edge0, width;
};

__device__ __forceinline__ float sprite_alpha(float dx, float dy, const Cells& k) {
  const float d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float tt = fminf(fmaxf(__fdiv_rn(__fsub_rn(d, k.edge0), k.width), 0.0f), 1.0f);
  const float a =
      __fsub_rn(1.0f, __fmul_rn(__fmul_rn(tt, tt), __fsub_rn(3.0f, __fmul_rn(2.0f, tt))));
  return a < 0.01f ? 0.0f : a;
}

__global__ void splat_cells_kernel(const float* __restrict__ px, const float* __restrict__ py,
                                   const float* __restrict__ color,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ starts, float* __restrict__ rgb,
                                   float* __restrict__ alpha_out, Cells k) {
  extern __shared__ float sm[];  // [5][4 * cap]: x, y, r, g, b of each staged slot
  __shared__ int count[4], first[4];
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int slots = 4 * k.cap;

  if (threadIdx.x < 4) {  // quadrant q = 2 qy + qx: cell (ty - qy, tx - qx)
    const int cy = ty - threadIdx.x / 2, cx = tx - threadIdx.x % 2;
    int c = 0, s0 = 0;
    if (cy >= 0 && cy < k.gh && cx >= 0 && cx < k.gw) {
      const int cell = cy * k.gw + cx;
      s0 = starts[cell];
      c = min(starts[cell + 1] - s0, k.cap);
    }
    count[threadIdx.x] = c;
    first[threadIdx.x] = s0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    const int q = i / k.cap, s = i % k.cap;
    if (s < count[q]) {
      const int p = perm[first[q] + s];
      sm[i] = px[p];
      sm[slots + i] = py[p];
      const float* c = color + static_cast<size_t>(p) * k.ld;
      sm[2 * slots + i] = c[0];
      sm[3 * slots + i] = c[1];
      sm[4 * slots + i] = c[2];
    }
  }
  __syncthreads();

  const int y = ty * kStride - kMargin + threadIdx.x / kStride;
  const int x = tx * kStride - kMargin + threadIdx.x % kStride;
  if (y < 0 || y >= k.H || x < 0 || x >= k.W) return;
  const float fx = static_cast<float>(x) + 0.5f, fy = static_cast<float>(y) + 0.5f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // r, g, b, alpha
  for (int q = 0; q < 4; ++q) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int b0 = q * k.cap;
    for (int i = b0; i < b0 + count[q]; ++i) {
      const float a = sprite_alpha(__fsub_rn(fx, sm[i]), __fsub_rn(fy, sm[slots + i]), k);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        part[ch] = __fadd_rn(part[ch], __fmul_rn(a, sm[(2 + ch) * slots + i]));
      part[3] = __fadd_rn(part[3], a);
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) acc[ch] = __fadd_rn(acc[ch], part[ch]);
  }
  const size_t o = static_cast<size_t>(y) * k.W + x;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) rgb[3 * o + ch] = acc[ch];
  alpha_out[o] = acc[3];
}

}  // namespace

// px, py: [n] pixel-space positions; color: [n, ld] (r, g, b in columns 0-2);
// perm: [n] int32 sorted row -> particle; starts: [gh * gw + 1] int32 run
// starts of the sorted render-cell keys.  rgb: [H, W, 3] and alpha: [H, W],
// every pixel written.  Requires 8 gw >= W, 8 gh >= H and cap >= 1.
static int splat_cells(const float* px, const float* py, const float* color, const int* perm,
                       const int* starts, float* rgb, float* alpha, int ld, int gw, int gh,
                       int cap, int H, int W, float edge0, float width, void* stream) {
  if (cap < 1 || ld < 3 || H < 1 || W < 1 || gw * kStride < W || gh * kStride < H)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(5) * 4 * cap * sizeof(float);
  if (shmem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(splat_cells_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Cells k{ld, gw, gh, cap, H, W, edge0, width};
  // Canvas tiles whose pixels meet the image: ty*8 - 4 < H, tx*8 - 4 < W.
  const dim3 grid((W + kMargin - 1) / kStride + 1, (H + kMargin - 1) / kStride + 1);
  splat_cells_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      px, py, color, perm, starts, rgb, alpha, k);
  return static_cast<int>(cudaGetLastError());
}

// (Its arguments: the record struct below, common.cuh's rps::unpack.)
struct rps_splat_cells_args {
  const float* px;
  const float* py;
  const float* color;
  const int* perm;
  const int* starts;
  float* rgb;
  float* alpha;
  int ld, gw, gh, cap, H, W;
  float edge0, width;
  void* stream;
};

extern "C" int rps_splat_cells(const void* packed, int size) {
  rps_splat_cells_args r;
  if (!rps::unpack(packed, size, &r)) return static_cast<int>(cudaErrorInvalidValue);
  return splat_cells(r.px, r.py, r.color, r.perm, r.starts, r.rgb, r.alpha, r.ld, r.gw, r.gh,
                     r.cap, r.H, r.W, r.edge0, r.width, r.stream);
}
