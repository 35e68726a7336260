// K4: the plane rasterizer.  Soft-disc sprites of the live slots of
// [gh, gw, C] cell planes, each drawn over its own cell's pixel patch, summed
// straight into [NCH, H, W] image accumulators.
//
// Replaces rust_particle_system_tpu/render/splat_planes.py::
// _make_strip_kernel_v2 (K4) and, with the same code, its v1 fallback
// _make_strip_kernel (K10), both driven by splat_from_planes.
//
// Contract (splat_planes.py:156-290, 457-473).  Cell (wr, c) -- world row wr,
// world y up -- owns the patch of ph x pw = (sy+2m) x (sx+2m) pixels whose
// top-left image pixel is (y0, x0) = (H - (wr+1)*sy - m, c*sx - m).  A live
// slot at pixel position (ppx, ppy) sits at q = (ppx - x0, ppy - y0) in its
// patch; with clamp_drift, q is first clamped into [r, pw-r] x [r, ph-r] (live
// slots only: q > 0.1*FAR stays).  Patch pixel (i, j), centre (j+0.5, i+0.5),
// gets col*alpha and alpha, alpha = 1 - smoothstep with
// tt = clip((d - 0.8r) * inv_w, 0, 1) (a multiply by the reciprocal width, as
// the Pallas kernel does), alpha < 0.01 -> 0; each alpha is bit-equal to
// the plain version's, and only the order of the sums differs.  It lands on
// image pixel (y0+i, x0+j) when that is inside the image.  A slot draws only inside its
// own cell's patch: the patch edge clips the sprite.
//
// Design: a pixel gather, no atomics, so the output is deterministic.  One
// block serves TC cells of one cell row and owns the image pixels of their
// sy x TC*sx core.  Its warps stage the live slots of those cells and of the
// 1-cell halo (3 x (TC+2) cells) in shared memory, compacted in slot order by
// warp ballots, already in patch coordinates (and clamped).  Since
// stride >= 2m, a pixel lies in the patches of at most 2 cells per axis (its
// own and one neighbour); each thread walks the staged slots of those <= 4
// cells in a fixed order, so empty cells cost nothing (the TPU kernel's
// occupancy gating) and the sums need no second pass.  NCH = 3 accumulates
// (r, g, alpha) for the sum rule; NCH = 4 accumulates (r, g, b, alpha).
// Neither the TPU's ph <= 32 nor its 128-lane group span limits this kernel,
// so the v1 geometries (K10) run here too.
//
// Bound on the H100: arithmetic and latency, not bytes.  At the main path
// (1M particles, gw=214, gh=121, C=128, r=3 px, m=4, 17x17 patches) it does
// about 1M x 289 (slot, pixel) evaluations, each a sqrt and a smoothstep; it
// reads 5 planes of 3.31M slots (66 MB) and writes <= 33 MB.

#include "common.cuh"

namespace {

constexpr float kFar = rps::kSentinel;  // dead slots are parked at FAR
constexpr int kMaxTC = 8;

struct Raster {
  int gh, gw, C, H, W, sx, sy, m, tc, clamp;
  float radius, edge0, inv_w;
};

// One (slot, pixel) coverage, rounded op by op as the plain version rounds it
// (the _rn intrinsics keep nvcc from contracting into fused multiply-adds).
// alpha feeds a threshold (alpha < 0.01 -> 0): with contraction, a handful of
// the ~3e8 evaluations of a 1M frame land on the other side of it and put
// 0.01-sized differences into the image.
__device__ __forceinline__ float sprite_alpha(float dx, float dy, const Raster& k) {
  const float d = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float tt = fminf(fmaxf(__fmul_rn(__fsub_rn(d, k.edge0), k.inv_w), 0.0f), 1.0f);
  const float a =
      __fsub_rn(1.0f, __fmul_rn(__fmul_rn(tt, tt), __fsub_rn(3.0f, __fmul_rn(2.0f, tt))));
  return a < 0.01f ? 0.0f : a;
}

__device__ __forceinline__ float clamp_center(float q, float r, float hi) {
  const float qc = fminf(fmaxf(q, r), hi - r);
  return q > 0.1f * kFar ? q : qc;
}

template <int NCH>
__global__ void splat_planes_kernel(const float* __restrict__ ppx,
                                    const float* __restrict__ ppy,
                                    const float* __restrict__ r_pl,
                                    const float* __restrict__ g_pl,
                                    const float* __restrict__ b_pl,
                                    float* __restrict__ out, Raster k) {
  constexpr int NS = NCH + 1;  // staged channels: qx, qy and NCH-1 colours
  extern __shared__ float sm[];
  const int ncol = k.tc + 2;
  const int ncell = 3 * ncol;
  const int cap = ncell * k.C;
  float* st[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) st[s] = sm + s * cap;
  int* count = reinterpret_cast<int*>(sm + NS * cap);

  const int wr = blockIdx.y;          // world row of the core cells
  const int c0 = blockIdx.x * k.tc;   // first core cell column
  const int ph = k.sy + 2 * k.m, pw = k.sx + 2 * k.m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* const col_pl[3] = {r_pl, g_pl, b_pl};

  // Stage: staged cell kk = row (wr - 1 + kk / ncol), column (c0 - 1 + kk % ncol).
  for (int kk = warp; kk < ncell; kk += nwarps) {
    const int rr = wr - 1 + kk / ncol, cc = c0 - 1 + kk % ncol;
    int cnt = 0;
    if (rr >= 0 && rr < k.gh && cc >= 0 && cc < k.gw) {  // warp-uniform
      const size_t base = (static_cast<size_t>(rr) * k.gw + cc) * k.C;
      const float x0 = static_cast<float>(cc * k.sx - k.m);
      const float y0 = static_cast<float>(k.H - (rr + 1) * k.sy - k.m);
      for (int s0 = 0; s0 < k.C; s0 += 32) {
        const int s = s0 + lane;
        const float x = s < k.C ? ppx[base + s] : kFar;
        const bool live = x < 0.5f * kFar;
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        if (live) {
          const int at = kk * k.C + cnt + __popc(bal & ((1u << lane) - 1u));
          float qx = x - x0;
          float qy = ppy[base + s] - y0;
          if (k.clamp) {
            qx = clamp_center(qx, k.radius, static_cast<float>(pw));
            qy = clamp_center(qy, k.radius, static_cast<float>(ph));
          }
          st[0][at] = qx;
          st[1][at] = qy;
#pragma unroll
          for (int ch = 0; ch < NCH - 1; ++ch) st[2 + ch][at] = col_pl[ch][base + s];
        }
        cnt += __popc(bal);
      }
    }
    if (lane == 0) count[kk] = cnt;
  }
  __syncthreads();

  // Gather: one pixel of the core at a time per thread.
  const int span = k.tc * k.sx;
  const int ytop = k.H - (wr + 1) * k.sy;  // image row of the core's top
  for (int p = threadIdx.x; p < k.sy * span; p += blockDim.x) {
    const int v = p / span, u0 = p % span;
    const int y = ytop + v, x = c0 * k.sx + u0;
    if (y < 0 || y >= k.H || x >= k.W) continue;
    const int t = u0 / k.sx, u = u0 % k.sx;  // core cell c0 + t, column u in it
    float acc[NCH];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) acc[ch] = 0.0f;
    // World rows wr+1 (above: patch row v+m+sy), wr (v+m), wr-1 (v+m-sy).
    for (int dr = 1; dr >= -1; --dr) {
      const int i = v + k.m + dr * k.sy;
      if (i < 0 || i >= ph) continue;
      const float fy = static_cast<float>(i) + 0.5f;
      for (int dc = -1; dc <= 1; ++dc) {
        const int j = u + k.m - dc * k.sx;
        if (j < 0 || j >= pw) continue;
        const float fx = static_cast<float>(j) + 0.5f;
        const int kk = (1 + dr) * ncol + (t + 1 + dc);
        const int n = count[kk];
        const int b0 = kk * k.C;
        for (int q = b0; q < b0 + n; ++q) {
          const float a = sprite_alpha(fx - st[0][q], fy - st[1][q], k);
#pragma unroll
          for (int ch = 0; ch < NCH - 1; ++ch) acc[ch] += st[2 + ch][q] * a;
          acc[NCH - 1] += a;
        }
      }
    }
    const size_t o = static_cast<size_t>(y) * k.W + x;
    const size_t plane = static_cast<size_t>(k.H) * k.W;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) out[ch * plane + o] = acc[ch];
  }
}

size_t shmem_bytes(int nch, int tc, int C) {
  return static_cast<size_t>(nch + 1) * 3 * (tc + 2) * C * sizeof(float) +
         3 * (tc + 2) * sizeof(int);
}

template <int NCH>
cudaError_t launch(const float* ppx, const float* ppy, const float* r, const float* g,
                   const float* b, float* out, Raster k, cudaStream_t stream) {
  const size_t shmem = shmem_bytes(NCH, k.tc, k.C);
  const void* fn = reinterpret_cast<const void*>(splat_planes_kernel<NCH>);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  const int ncx = (k.W - 1) / k.sx + 1;  // cell columns whose core meets the image
  const int nry = (k.H - 1) / k.sy + 1;  // cell rows whose core meets the image
  const dim3 grid((ncx + k.tc - 1) / k.tc, nry);
  splat_planes_kernel<NCH><<<grid, 256, shmem, stream>>>(ppx, ppy, r, g, b, out, k);
  return cudaGetLastError();
}

}  // namespace

// ppx/ppy: pixel-space positions [gh, gw, C] (dead slots at FAR); r, g and,
// for nch == 4, b: colour planes.  out: [nch, H, W], every pixel written.
// Requires sx, sy >= 2m, m >= 0, gh*sy >= H and 1 <= C.
static int splat_planes(const float* ppx, const float* ppy, const float* r, const float* g,
                        const float* b, float* out, int gh, int gw, int C, int H, int W,
                        int sx, int sy, int m, int nch, int clamp_drift, float radius,
                        float edge0, float inv_w, void* stream) {
  if (C < 1 || m < 0 || sx < 2 * m || sy < 2 * m || sx < 1 || sy < 1 ||
      gh * sy < H || H < 1 || W < 1 || (nch != 3 && nch != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  // The widest core tile whose staging fits a block's shared memory.
  int tc = kMaxTC;
  while (tc > 1 && shmem_bytes(nch, tc, C) > 100 * 1024) tc /= 2;
  if (shmem_bytes(nch, tc, C) > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const Raster k{gh, gw, C, H, W, sx, sy, m, tc, clamp_drift, radius, edge0, inv_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = nch == 3 ? launch<3>(ppx, ppy, r, g, b, out, k, s)
                                   : launch<4>(ppx, ppy, r, g, b, out, k, s);
  return static_cast<int>(err);
}

// (Its arguments: the record struct below, common.cuh's rps::unpack.)
struct rps_splat_planes_args {
  const float* ppx;
  const float* ppy;
  const float* r;
  const float* g;
  const float* b;
  float* out;
  int gh, gw, C, H, W, sx, sy, m, nch, clamp_drift;
  float radius, edge0, inv_w;
  void* stream;
};

extern "C" int rps_splat_planes(const void* packed, int size) {
  rps_splat_planes_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  return splat_planes(a.ppx, a.ppy, a.r, a.g, a.b, a.out, a.gh, a.gw, a.C, a.H, a.W, a.sx,
                      a.sy, a.m, a.nch, a.clamp_drift, a.radius, a.edge0, a.inv_w, a.stream);
}
