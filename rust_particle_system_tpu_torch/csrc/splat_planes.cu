// K4: the plane render.  World planes in, image out: the soft-disc sprites of
// the live slots of [gh, gw, C] cell planes, each drawn over its own cell's
// pixel patch and summed per pixel, then the sum rule and the resolve over the
// background into an [H, W, 4] image.  An epilogue flag writes the
// [nch, H, W] accumulators instead (the sharded frame sums those across its
// bands before it resolves).
//
// Replaces rust_particle_system_tpu/render/splat_planes.py::
// _make_strip_kernel_v2 (K4) and, with the same code, its v1 fallback
// _make_strip_kernel (K10), both driven by splat_from_planes, together with
// the elementwise steps around them there (world -> pixel, the energy ramp,
// the sum rule) and splat_jax.py::splat_resolve.
//
// Contract (splat_planes.py:156-290, 364-375, 457-488).  A slot is live iff
// px < 0.5 * SENTINEL.  Its pixel position is ((px - x_min) * sx_scale,
// (y_max - py) * sy_scale).  Cell (wr, c) -- world row wr, world y up -- owns
// the patch of ph x pw = (sy+2m) x (sx+2m) pixels whose top-left image pixel
// is (y0, x0) = (H - (wr+1)*sy - m, c*sx - m).  A live slot sits at
// q = (ppx - x0, ppy - y0) in its patch; with clamp_drift, q is first clamped
// into [r, pw-r] x [r, ph-r] (q > 0.1*FAR stays).  Patch pixel (i, j), centre
// (j+0.5, i+0.5), gets col*alpha and alpha, alpha = 1 - smoothstep with
// tt = clip((d - 0.8r) * inv_w, 0, 1) (a multiply by the reciprocal width, as
// the Pallas kernel does), alpha < 0.01 -> 0.  It lands on image pixel
// (y0+i, x0+j) when that is inside the image: a slot draws only inside its
// own cell's patch.  Colours: the energy ramp of (vx, vy), white, or given
// planes.  NCH = 3 accumulates (r, g, alpha) under the sum rule (every live
// slot's r+g+b is color_sum, so blue = (color_sum*alpha - r) - g); NCH = 4
// accumulates (r, g, b, alpha).  The resolve: coverage = clip(alpha, 0, 1),
// rgb / max(alpha, 1e-6) * coverage + bg * (1 - coverage), alpha channel
// coverage + bg_a * (1 - coverage).
//
// Rounding.  Every staged value and every alpha is bit-equal to the plain
// composition's (raster_inputs -> raster_planes_plain -> sum rule ->
// splat_resolve): each is rounded op by op as those torch ops round it, with
// the _rn intrinsics (nvcc would otherwise contract into fused multiply-adds),
// a true division by max_energy, and the correctly rounded sqrtf.  alpha feeds
// a threshold (alpha < 0.01 -> 0): with contraction, a handful of the ~1e8
// pairs of a 1M frame land on the other side of it.  Only the order of each
// pixel's sum differs from the plain version's; it is fixed, so two runs give
// the same bits, and the image is bit-equal to the accumulators put through
// the plain sum rule and resolve.
//
// Design.  Its bound is bytes (x in full, y, vx, vy where a slot is live, and
// the image out: about 60 MB, 0.018 ms at the main path, chip_smoke.py's
// k4_work), but what holds it on the H100 is instructions
// and load latency (profile_render.py --parts splits it): at the main path
// (1M particles, gw=214, gh=121, C=128, r=3 px, m=4, 17x17 patches) a pixel
// lies in the patches of ~3.6 cells holding ~138 live slots, but only ~14
// sprites reach it.  So the work is culled twice before the square root:
//   * A block owns 16 x 16 image pixels, a warp one 8 x 4 tile of them, a
//     lane one pixel.  Each round, the block stages S slots of every cell of
//     its window (the cells whose patches meet its pixels) in shared memory,
//     compacted by warp ballots, already in patch coordinates, with their
//     colours; a warp puts the loads of kStageCells cells in flight at once,
//     rounds that stage nothing skip the walk, and a round is skipped when
//     the one before found no live slot in its range.
//   * Each warp culls the staged slots of the cells whose patches meet its
//     tile to those whose disc reaches the box of its pixel centres, and
//     ballot-compacts them into a list of its own, in staging order.
//   * The warp walks its list 64 entries at a time.  First the hit masks:
//     lane e forms entry e's d^2 to all 32 pixel centres of the tile (8 dx^2
//     and 4 dy^2, then 32 sums), rounded as sprite_alpha rounds it, as a bit
//     word over the pixels; at or above r^2 alpha is exactly 0 (no hit).  A
//     warp bit-transpose hands each lane its pixel's word over the entries.
//     Then each lane takes the full alpha of its own hits only, lowest entry
//     first; the lanes' trip counts differ only in that loop.
// No atomics: each pixel is summed by one lane, in a fixed order (round, then
// list order).  Neither the TPU's ph <= 32 nor its 128-lane group span limits
// this kernel, so the v1 geometries (K10) run here too.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kFar = rps::kSentinel;  // dead slots are parked at FAR
constexpr int kTileW = 8;               // a warp's tile: 8 x 4 pixels, one a lane
constexpr int kTileH = 4;
constexpr int kBlockTilesX = 2;         // a block: 2 x 4 tiles, one a warp
constexpr int kBlockTilesY = 4;
constexpr int kWarps = kBlockTilesX * kBlockTilesY;
constexpr int kBlockW = kBlockTilesX * kTileW;  // 16 x 16 pixels a block
constexpr int kBlockH = kBlockTilesY * kTileH;
constexpr int kMaxRoundSlots = 64;      // S: slots of each window cell a round, at most
constexpr int kChunks = kMaxRoundSlots / 32;
constexpr int kStageCells = 2;          // window cells a warp stages at once
constexpr int kShmemBudget = 96 * 1024;  // S halves until a block's shared bytes fit
static_assert(kTileW * kTileH == 32, "one pixel a lane, one bit a pixel");

enum Colour { kRamp = 0, kGiven = 1, kWhite = 2 };

struct Render {
  int gh, gw, C, H, W, sx, sy, m, clamp, image;
  int S;         // slots of each window cell staged a round
  int ncx, ncy;  // window cells of a block, at most (columns, rows)
  int my;        // top-down cell row tr = gh-1-wr has its patch top at tr*sy - my
  int list_cap;  // entries of a warp's list
  float radius, edge0, inv_w;
  float r2;     // r*r: at or above it alpha is exactly 0
  float cull2;  // r2 * (1 + 2^-10): a slot whose squared distance to a tile's pixel
                // centres is at or above it has d^2 >= r2 at each of them, rounding and all
  float x_min, y_max, sx_scale, sy_scale, max_energy, color_sum;
  float bg[4];
};

struct Planes {
  const float* px;
  const float* py;
  const float* vx;
  const float* vy;
  const float* col[3];
};

__host__ __device__ inline int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}
__host__ __device__ inline int ceil_div(int a, int b) { return -floor_div(-a, b); }

// The cell columns whose patches meet image columns [lo, hi]: c*sx - m <= hi
// and c*sx - m + pw - 1 >= lo.  The same for the top-down cell rows tr, whose
// patch top is tr*sy - my.
__device__ inline int first_col(int lo, const Render& k) {
  return ceil_div(lo + k.m - (k.sx + 2 * k.m) + 1, k.sx);
}
__device__ inline int last_col(int hi, const Render& k) { return floor_div(hi + k.m, k.sx); }
__device__ inline int first_row(int lo, const Render& k) {
  return ceil_div(lo + k.my - (k.sy + 2 * k.m) + 1, k.sy);
}
__device__ inline int last_row(int hi, const Render& k) { return floor_div(hi + k.my, k.sy); }

__device__ __forceinline__ float clamp_center(float q, float r, float hi) {
  const float qc = fminf(fmaxf(q, r), hi - r);
  return q > 0.1f * kFar ? q : qc;
}

// torch's clamp(t, 0, 1), which keeps a NaN.
__device__ __forceinline__ float clamp01(float t) {
  return t != t ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}

// core/kernels.py::energy_color: the blue -> green -> red ramp on 0.5*|v|^2.
__device__ __forceinline__ void energy_ramp(float vx, float vy, float max_energy,
                                            float (&rgb)[3]) {
  const float s = __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy));
  const float t = clamp01(__fdiv_rn(__fmul_rn(0.5f, s), max_energy));
  const float lo = __fmul_rn(t, 2.0f);
  const float hi = __fmul_rn(__fsub_rn(t, 0.5f), 2.0f);
  const bool low = t < 0.5f;
  rgb[0] = low ? 0.0f : hi;
  rgb[1] = low ? lo : __fsub_rn(1.0f, hi);
  rgb[2] = low ? __fsub_rn(1.0f, lo) : 0.0f;
}

// d^2 from the centre of the pixel at (xh, yh) = (x + 0.5, y + 0.5) to a
// staged slot g = (qx, qy, x0, y0): xh - x0 is the patch pixel's centre j + 0.5
// exactly, and the rest rounds as the plain version rounds it.
__device__ __forceinline__ float dist2(float xh, float yh, float4 g) {
  const float dx = __fsub_rn(__fsub_rn(xh, g.z), g.x);
  const float dy = __fsub_rn(__fsub_rn(yh, g.w), g.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// One (slot, pixel) coverage from its d^2, rounded op by op as the plain
// version rounds it.
__device__ __forceinline__ float sprite_alpha(float d2, const Render& k) {
  const float d = sqrtf(d2);
  const float tt = fminf(fmaxf(__fmul_rn(__fsub_rn(d, k.edge0), k.inv_w), 0.0f), 1.0f);
  const float a =
      __fsub_rn(1.0f, __fmul_rn(__fmul_rn(tt, tt), __fsub_rn(3.0f, __fmul_rn(2.0f, tt))));
  return a < 0.01f ? 0.0f : a;
}

// The 32 x 32 bit matrix whose row e is lane e's word, transposed: lane p
// gets bit p of every lane's word (bit e from lane e).  Five block swaps
// through the warp's shuffles.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  constexpr unsigned kKeep[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                                 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const unsigned m = kKeep[i];
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
    x = lane & j ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y << j) & ~m);
  }
  return x;
}

// The hits of list entries e0 .. e0+ne-1 (ne <= 32) on this lane's pixel, as
// a bit mask over the entries: d^2 < r^2 (at or above it alpha is exactly 0)
// and, without clamping, the entry's patch holds the pixel.  Lane e takes
// entry e and forms its d^2 to each of the tile's 32 pixel centres (pixel p,
// the p-th lane's, is bit p), rounded as dist2 rounds it (the centre's offset
// in the patch, (tx0 + c + 0.5) - x0, is exact); a transpose hands each lane
// its pixel's bits.
template <bool kPatchTest>
__device__ __forceinline__ unsigned hit_mask(const uint16_t* list, int e0, int ne,
                                             const float4* geo, int tx0, int ty0, int lane,
                                             const Render& k) {
  unsigned hit = 0;
  if (lane < ne) {
    const float4 g = geo[list[e0 + lane]];
    const float fx0 = __fsub_rn(static_cast<float>(tx0) + 0.5f, g.z);
    const float fy0 = __fsub_rn(static_cast<float>(ty0) + 0.5f, g.w);
    float dx2[kTileW], dy2[kTileH];
#pragma unroll
    for (int c = 0; c < kTileW; ++c) {
      const float dx = __fsub_rn(fx0 + static_cast<float>(c), g.x);
      dx2[c] = __fmul_rn(dx, dx);
    }
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
      const float dy = __fsub_rn(fy0 + static_cast<float>(r), g.y);
      dy2[r] = __fmul_rn(dy, dy);
    }
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
#pragma unroll
      for (int c = 0; c < kTileW; ++c)
        hit |= __fadd_rn(dx2[c], dy2[r]) < k.r2 ? 1u << (r * kTileW + c) : 0u;
    }
    if (kPatchTest) {  // pixel centres (j + 0.5, i + 0.5) with 0 <= j < pw, 0 <= i < ph
      const float pwf = static_cast<float>(k.sx + 2 * k.m);
      const float phf = static_cast<float>(k.sy + 2 * k.m);
      unsigned cols = 0, in_patch = 0;
#pragma unroll
      for (int c = 0; c < kTileW; ++c) {
        const float fx = fx0 + static_cast<float>(c);
        cols |= fx > 0.0f && fx < pwf ? 1u << c : 0u;
      }
#pragma unroll
      for (int r = 0; r < kTileH; ++r) {
        const float fy = fy0 + static_cast<float>(r);
        in_patch |= fy > 0.0f && fy < phf ? cols << (r * kTileW) : 0u;
      }
      hit &= in_patch;
    }
  }
  return transpose32(hit, lane);
}

template <int NCH, int COL>
__global__ void __launch_bounds__(kWarps * 32, 4)
    render_kernel(Planes in, float* __restrict__ out, Render k) {
  constexpr int NCOL = COL == kWhite ? 0 : NCH - 1;  // staged colour channels
  constexpr int NACC = COL == kWhite ? 1 : NCH;      // white sums alpha alone
  extern __shared__ float4 smem[];
  const int nwin = k.ncx * k.ncy;
  const int cap = nwin * k.S;
  float4* geo = smem;                                     // (qx, qy, x0, y0) a slot
  float* col = reinterpret_cast<float*>(geo + cap);       // NCOL planes of cap
  int* count = reinterpret_cast<int*>(col + NCOL * cap);  // slots staged a cell
  uint16_t* list = reinterpret_cast<uint16_t*>(count + nwin) + (threadIdx.x >> 5) * k.list_cap;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int ph = k.sy + 2 * k.m, pw = k.sx + 2 * k.m;
  const int bx0 = blockIdx.x * kBlockW, by0 = blockIdx.y * kBlockH;
  const int wc0 = first_col(bx0, k), wr0 = first_row(by0, k);  // window origin (unclipped)
  const int tx0 = bx0 + (warp % kBlockTilesX) * kTileW;
  const int ty0 = by0 + (warp / kBlockTilesX) * kTileH;
  const int x = tx0 + lane % kTileW, y = ty0 + lane / kTileW;
  const float xh = static_cast<float>(x) + 0.5f, yh = static_cast<float>(y) + 0.5f;
  const bool tile_in = tx0 < k.W && ty0 < k.H;  // warp-uniform
  const int c_lo = max(first_col(tx0, k), 0);
  const int c_hi = min(last_col(tx0 + kTileW - 1, k), k.gw - 1);
  const int r_lo = max(first_row(ty0, k), 0);
  const int r_hi = min(last_row(ty0 + kTileH - 1, k), k.gh - 1);

  float acc[NACC];
#pragma unroll
  for (int ch = 0; ch < NACC; ++ch) acc[ch] = 0.0f;

  for (int s0 = 0; s0 < k.C; s0 += k.S) {
    // Stage slots s0 .. s0+S-1 of each window cell: window cell kk is cell
    // row wr0 + kk / ncx (top-down), column wc0 + kk % ncx.  A warp takes
    // kStageCells cells at once and puts all their loads in flight together:
    // x of every slot (and of the next round's, to know whether there is
    // one), then the rest of the live ones, then the ballots.
    bool any = false, more = false;
    for (int kb = warp; kb < nwin; kb += kStageCells * kWarps) {
      size_t base[kStageCells];
      float x0[kStageCells], y0[kStageCells];
      float xv[kStageCells][kChunks], yv[kStageCells][kChunks];
      float vin[kStageCells][kChunks][3];  // vx, vy, or the given colours
#pragma unroll
      for (int i = 0; i < kStageCells; ++i) {
        const int kk = kb + i * kWarps;
        const int tr = wr0 + kk / k.ncx, c = wc0 + kk % k.ncx;
        const bool in_grid = kk < nwin && tr >= 0 && tr < k.gh && c >= 0 && c < k.gw;
        base[i] = (static_cast<size_t>(k.gh - 1 - tr) * k.gw + c) * k.C;
        x0[i] = static_cast<float>(c * k.sx - k.m);
        y0[i] = static_cast<float>(tr * k.sy - k.my);
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const int j = q * 32 + lane, s = s0 + j;
          xv[i][q] = in_grid && j < k.S && s < k.C ? in.px[base[i] + s] : kFar;
          const float next = in_grid && j < k.S && s + k.S < k.C ? in.px[base[i] + s + k.S]
                                                                 : kFar;
          more |= next < rps::kLiveBelow;
        }
      }
#pragma unroll
      for (int i = 0; i < kStageCells; ++i) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const size_t at = base[i] + s0 + q * 32 + lane;
          if (xv[i][q] < rps::kLiveBelow) {
            yv[i][q] = in.py[at];
            if (COL == kRamp) {
              vin[i][q][0] = in.vx[at];
              vin[i][q][1] = in.vy[at];
            } else if (COL == kGiven) {
#pragma unroll
              for (int ch = 0; ch < NCOL; ++ch) vin[i][q][ch] = in.col[ch][at];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kStageCells; ++i) {
        const int kk = kb + i * kWarps;
        int cnt = 0;
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const bool live = xv[i][q] < rps::kLiveBelow;
          const unsigned bal = __ballot_sync(0xffffffffu, live);
          if (live) {
            const int at = kk * k.S + cnt + __popc(bal & below);
            const float ppx = __fmul_rn(__fsub_rn(xv[i][q], k.x_min), k.sx_scale);
            const float ppy = __fmul_rn(__fsub_rn(k.y_max, yv[i][q]), k.sy_scale);
            float qx = __fsub_rn(ppx, x0[i]);
            float qy = __fsub_rn(ppy, y0[i]);
            if (k.clamp) {
              qx = clamp_center(qx, k.radius, static_cast<float>(pw));
              qy = clamp_center(qy, k.radius, static_cast<float>(ph));
            }
            geo[at] = make_float4(qx, qy, x0[i], y0[i]);
            if (COL == kRamp) {
              float rgb[3];
              energy_ramp(vin[i][q][0], vin[i][q][1], k.max_energy, rgb);
#pragma unroll
              for (int ch = 0; ch < NCOL; ++ch) col[ch * cap + at] = rgb[ch];
            } else if (COL == kGiven) {
#pragma unroll
              for (int ch = 0; ch < NCOL; ++ch) col[ch * cap + at] = vin[i][q][ch];
            }
          }
          cnt += __popc(bal);
        }
        if (lane == 0 && kk < nwin) count[kk] = cnt;
        any = any || cnt > 0;
      }
    }
    if (!__syncthreads_or(any)) {  // nothing staged: no walk
      if (!__syncthreads_or(more)) s0 += k.S;  // nor anything live in the next round's range
      continue;
    }

    if (tile_in) {
      // Cull: the staged slots of the cells whose patches meet the tile, kept
      // where the disc reaches the box of the tile's pixel centres (the
      // squared distance to it below cull2, r^2 with room for the per-pixel
      // d^2's rounding), in staging order.
      int n = 0;
      for (int tr = r_lo; tr <= r_hi; ++tr) {
        for (int c = c_lo; c <= c_hi; ++c) {
          const int kk = (tr - wr0) * k.ncx + (c - wc0);
          const int cnt = count[kk];
          const int x0 = c * k.sx - k.m, y0 = tr * k.sy - k.my;
          // The box of the tile's pixel centres in the cell's patch coordinates.
          const float ux0 = static_cast<float>(tx0 - x0) + 0.5f;
          const float ux1 = ux0 + static_cast<float>(kTileW - 1);
          const float uy0 = static_cast<float>(ty0 - y0) + 0.5f;
          const float uy1 = uy0 + static_cast<float>(kTileH - 1);
          for (int j0 = 0; j0 < cnt; j0 += 32) {
            const int j = j0 + lane;
            bool keep = false;
            if (j < cnt) {
              const float4 g = geo[kk * k.S + j];
              const float bx = g.x - fminf(fmaxf(g.x, ux0), ux1);
              const float by = g.y - fminf(fmaxf(g.y, uy0), uy1);
              keep = bx * bx + by * by < k.cull2;
            }
            const unsigned bal = __ballot_sync(0xffffffffu, keep);
            if (keep) list[n + __popc(bal & below)] = static_cast<uint16_t>(kk * k.S + j);
            n += __popc(bal);
          }
        }
      }
      __syncwarp();
      // Walk: 64 entries at a time, the hit masks, then the full alpha of
      // this lane's hits, lowest entry first.
      for (int e0 = 0; e0 < n; e0 += 64) {
        unsigned half[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ne = min(32, n - e0 - 32 * h);
          if (ne <= 0)
            half[h] = 0;
          else if (k.clamp)
            half[h] = hit_mask<false>(list, e0 + 32 * h, ne, geo, tx0, ty0, lane, k);
          else
            half[h] = hit_mask<true>(list, e0 + 32 * h, ne, geo, tx0, ty0, lane, k);
        }
        unsigned long long hits = half[0] | static_cast<unsigned long long>(half[1]) << 32;
        while (hits) {
          const int q = list[e0 + __ffsll(hits) - 1];
          hits &= hits - 1ull;
          const float a = sprite_alpha(dist2(xh, yh, geo[q]), k);
#pragma unroll
          for (int ch = 0; ch < NCOL; ++ch) acc[ch] += col[ch * cap + q] * a;
          acc[NACC - 1] += a;
        }
      }
    }
    // The next round's staging overwrites what was walked.  Where the
    // window has no live slot in the next round's range, that round is
    // skipped.
    if (!__syncthreads_or(more)) s0 += k.S;
  }

  if (!tile_in || x >= k.W || y >= k.H) return;
  float v[NCH];  // the accumulators: (r, g, alpha) or (r, g, b, alpha)
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) v[ch] = acc[COL == kWhite ? 0 : ch];
  const size_t o = static_cast<size_t>(y) * k.W + x;
  if (!k.image) {
    const size_t plane = static_cast<size_t>(k.H) * k.W;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) out[ch * plane + o] = v[ch];
    return;
  }
  const float a = v[NCH - 1];
  const float b = NCH == 4 ? v[2] : __fsub_rn(__fsub_rn(__fmul_rn(k.color_sum, a), v[0]), v[1]);
  const float cov = fminf(fmaxf(a, 0.0f), 1.0f);
  const float den = fmaxf(a, 1e-6f);
  const float rest = __fsub_rn(1.0f, cov);
  const float rgb[3] = {v[0], v[1], b};
  float px[4];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    px[ch] = __fadd_rn(__fmul_rn(__fdiv_rn(rgb[ch], den), cov), __fmul_rn(k.bg[ch], rest));
  px[3] = __fadd_rn(cov, __fmul_rn(k.bg[3], rest));
  reinterpret_cast<float4*>(out)[o] = make_float4(px[0], px[1], px[2], px[3]);
}

// A block's shared bytes: the staged slots (a float4 and ncol colours each),
// the window's counts and the warps' lists.
size_t render_shmem(int ncol, int nwin, int S, int list_cap) {
  return static_cast<size_t>(nwin) * S * (16 + 4 * ncol) + 4 * static_cast<size_t>(nwin) +
         2 * static_cast<size_t>(kWarps) * list_cap;
}

template <int NCH, int COL>
cudaError_t launch(const Planes& in, float* out, const Render& k, size_t shmem,
                   cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(render_kernel<NCH, COL>);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((k.W + kBlockW - 1) / kBlockW, (k.H + kBlockH - 1) / kBlockH);
  render_kernel<NCH, COL><<<grid, kWarps * 32, shmem, stream>>>(in, out, k);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_colour(int colour, const Planes& in, float* out, const Render& k,
                          size_t shmem, cudaStream_t stream) {
  if (colour == kRamp) return launch<NCH, kRamp>(in, out, k, shmem, stream);
  if (colour == kGiven) return launch<NCH, kGiven>(in, out, k, shmem, stream);
  return launch<NCH, kWhite>(in, out, k, shmem, stream);
}

}  // namespace

// The record (see common.cuh's rps::unpack).  px, py: world-space position
// planes [gh, gw, C] (dead slots at FAR); vx, vy: velocity planes (read for
// colour 0, the ramp); c0, c1, c2: colour planes (colour 1; c2 for nch == 4);
// colour 2 is white.  out: [H, W, 4] with image != 0, else [nch, H, W]; every
// pixel written.  Requires sx, sy >= 2m, m >= 0, gh*sy >= H, C >= 1.
struct rps_splat_planes_args {
  const float* px;
  const float* py;
  const float* vx;
  const float* vy;
  const float* c0;
  const float* c1;
  const float* c2;
  float* out;
  int gh, gw, C, H, W, sx, sy, m, nch, colour, clamp_drift, image;
  float radius, edge0, inv_w, x_min, y_max, sx_scale, sy_scale, max_energy, color_sum;
  float bg[4];
  void* stream;
};

extern "C" int rps_splat_planes(const void* packed, int size) {
  rps_splat_planes_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.C < 1 || a.m < 0 || a.sx < 2 * a.m || a.sy < 2 * a.m || a.sx < 1 || a.sy < 1 ||
      a.gh < 1 || a.gw < 1 || a.gh * a.sy < a.H || a.H < 1 || a.W < 1 || a.H > (1 << 20) ||
      a.W > (1 << 20) || (a.nch != 3 && a.nch != 4) || a.colour < kRamp || a.colour > kWhite)
    return static_cast<int>(cudaErrorInvalidValue);
  Render k{};
  k.gh = a.gh, k.gw = a.gw, k.C = a.C, k.H = a.H, k.W = a.W, k.sx = a.sx, k.sy = a.sy;
  k.m = a.m, k.clamp = a.clamp_drift, k.image = a.image;
  const int pw = a.sx + 2 * a.m, ph = a.sy + 2 * a.m;
  k.my = a.gh * a.sy - a.H + a.m;
  k.ncx = (kBlockW + pw - 2) / a.sx + 1;
  k.ncy = (kBlockH + ph - 2) / a.sy + 1;
  const int tile_cells = ((kTileW + pw - 2) / a.sx + 1) * ((kTileH + ph - 2) / a.sy + 1);
  const int ncol = a.colour == kWhite ? 0 : a.nch - 1;
  int S = kMaxRoundSlots;
  while (S > 1 && S / 2 >= a.C) S /= 2;  // the least power of two >= C, up to 64
  while (S > 1 && render_shmem(ncol, k.ncx * k.ncy, S, tile_cells * S) > kShmemBudget) S /= 2;
  k.S = S;
  k.list_cap = tile_cells * S;
  const size_t shmem = render_shmem(ncol, k.ncx * k.ncy, S, k.list_cap);
  if (shmem > 227 * 1024 || k.ncx * k.ncy * S > 65536)  // list entries are 16-bit
    return static_cast<int>(cudaErrorInvalidValue);
  k.radius = a.radius, k.edge0 = a.edge0, k.inv_w = a.inv_w;
  k.r2 = a.radius * a.radius;
  k.cull2 = k.r2 * (1.0f + 1.0f / 1024.0f);
  k.x_min = a.x_min, k.y_max = a.y_max, k.sx_scale = a.sx_scale, k.sy_scale = a.sy_scale;
  k.max_energy = a.max_energy, k.color_sum = a.color_sum;
  for (int i = 0; i < 4; ++i) k.bg[i] = a.bg[i];
  const Planes in{a.px, a.py, a.vx, a.vy, {a.c0, a.c1, a.c2}};
  const cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  const cudaError_t err = a.nch == 3 ? launch_colour<3>(a.colour, in, a.out, k, shmem, s)
                                     : launch_colour<4>(a.colour, in, a.out, k, shmem, s);
  return static_cast<int>(err);
}
