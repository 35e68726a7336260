// K1 and K7: the lossless hole-fill rebin of plane-resident state (variant 6
// semantics), on the whole grid (K1) or on one band's slab of it (K7).
//
// Replaces rust_particle_system_tpu/ops/pallas/rebin.py::_make_kernel_v6,
// driven by _rebin_v6 (K1) and by _rebin_v6_band (K7).  Output planes and
// counts are bit-identical to it: values only move, never change, and every
// decision is an integer rank.
//
// One kernel serves both.  Every row test (the edge guards, the key row
// compares) is in GLOBAL grid rows, so a block of a band sees exactly the
// decisions the same row's block sees on the whole grid.  A launch owns the
// global rows [row0, row0 + rows) of [rows, gw, C] planes and writes its
// outputs there.  K1 is row0 = 0, rows = gh.  K7 passes the band's slab and,
// beside it, the ghost rows a neighbour band owns, each [gw, C], read where
// they lie: row0-2 (x/y only), row0-1 and row0+rows (every channel).  Reads
// of rows outside the grid are guarded by the global-row conditions, so ghost
// rows past the mesh's edges are never read and may hold anything.
//
// What it computes, per destination cell (r, c), with keys taken from (x, y)
// by the IEEE floor expression (rebin.py:489-494):
//   pass Y   stayers (live, key row == r) keep their slot; arrivals from rows
//            r-1 then r+1 (slot order; "keep" is a clamped hop toward the key
//            row, rebin.py:546-547) fill the DEAD own slots in slot order; an
//            arrival of window rank j fills the hole of rank j iff j < #holes.
//   Y-retention  a row-r mover that row r-1 / r+1 did not adopt stays in its
//            slot (rebin.py:621-639).  Row r-1's decision needs row r-2's
//            keep count, so rows r-2..r+1 of x/y are read.
//   pass X   the same within the row, on the pass-Y result ("mid"): arrivals
//            from columns c-1 then c+1 whose key row is r; slots whose key row
//            is not r stay put (rebin.py:641-662).
//   X-retention  needs mid of columns c-2..c+1 (rebin.py:682-689).
//   counts   live slots per cell after both passes.
//   walk     (if asked for) the walks' position planes: each out slot's x/y,
//            or SENTINEL for a DEFERRED slot, live but keyed to another cell
//            than its own (the JAX resident.py:264-273; walk_positions in
//            ops/cuda/rebin.py).
//
// Bound on the H100: memory.  The least traffic reads the k planes once and
// writes them once (132.6 MB at 1M particles, C=128, k=5).  Two facts make
// one launch enough: pass Y's decisions for cell (r, c) read column c of rows
// r-2..r+1 only, and pass X's for (r, c) read mid of row r, columns c-2..c+1
// only.  So a block owns T = tile_cols(C) - 3 adjacent columns of one row:
//   cuts     a thread per cut computes the block's key cuts (below), then a
//            __syncthreads.
//   phase Y  a warp per column of [c0-2, c0+T+1) (the own columns and the
//            halo pass X reads) loads x/y of its four rows (a chunk's eight
//            loads together, the next chunk's in flight), ranks by one
//            ballot per 32-slot chunk and predicate (running chunk prefixes
//            in registers, the chunks' ballots in the warp's shared scratch:
//            no block-wide count), and writes one word per mid slot to shared
//            memory: the SOURCE, the input slot it holds (row delta -1/0/+1,
//            slot), and its class for pass X (key row r and moving left or
//            right, or staying), or -1 for a fill.  No value moves.
//   a __syncthreads.
//   phase X  a warp per own column ranks on the classes of columns c-2..c+1
//            and COMPOSES the source: an out slot <- a mid slot (c-1, c or
//            c+1) <- an input slot.  Pass X moves only live mid slots, so a
//            composed source is an input slot or a fill.  Then each own slot
//            reads its k values once, straight from the input planes, or
//            writes the fills; the counts are a ballot per chunk.
// mid never leaves shared memory (4 bytes a slot), every value crosses device
// memory once each way, and only x/y of the halo rows and columns are read
// again (from L2).  No key is divided out per slot: each test "key >= j" is a
// compare against the least float that reaches cell j, found once a block
// (Cut below).  Measured on the card, the time goes to the ranking's
// instructions and to phase Y's x/y reads from L2, not to device memory
// (PERF.md, section 6).  A hole filled from row r-1 or r+1 (a rare arrival)
// loads that slot's x/y to class it.  The TPU built ranks from triangular
// matmuls and applied them with one-hot matmuls because its lanes cannot
// scatter; here ranks are ballots and popcounts, and the n-th arrival is
// found by walking the chunks' ballots.
//
// The JAX kernel's air-window skip (rebin.py:512-538) is an exact shortcut of
// the same result: here a column with nothing live ranks empty ballots,
// composes fills and gathers nothing.
//
// The walk planes cost two stores a slot: phase X holds each out slot's x/y
// and the block's cuts of row r and of column c, so "key == (r, c)" is four
// compares, and the defer mask needs no pass of its own.  Rows and columns are
// global, so K7 writes a band's rows of K1's walk planes.
//
// The predict at load (rebin_tile<true>): the launch is handed the state's own
// planes (px, py, vx, vy, ids) and applies gravity and the predict to every
// value it loads of an own row (predict() below), so the frame writes no
// predicted planes; a band's ghost rows come predicted, and are taken as
// given.  Every decision and every stored value then sees what the predicted
// planes would hold, so the output is the composition's bit for bit.  Phase
// Y loads a row's vx and vy only where its x shows a live slot (a dead slot
// predicts to SENTINEL whatever its velocity), phase X reads the same five
// channels, and the rare r+-1 arrival four values in place of two.  Loading
// the velocities beside x/y for every slot, and so ahead of time, took 153
// registers a thread and ran 2.2x slower (PERF.md, section 6).
// rebin_tile<false> reads its input as given.

#include <cstdint>

#include "common.cuh"

namespace {

using rps::for_channels;
using rps::kLiveBelow;
using rps::OutPlanes;

constexpr int kTileWarps = 8;                 // warps a block
constexpr int kTileThreads = 32 * kTileWarps;  // threads a block
constexpr int kTileBlocks = 4;                 // blocks an SM the registers allow
constexpr int kMaxC = 1024;                   // the largest C the rebin takes
constexpr int kBallots = 5;  // ballots a chunk keeps for a column's second pass

__host__ __device__ constexpr int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Columns of a block's phase Y at C slots a cell: its T = tile_cols(C) - 3
// own columns, two to their left and one to their right.
__host__ __device__ constexpr int tile_cols(int C) { return clamp_int(4096 / C, 8, 32); }

// Shared bytes of a block: one word per slot of its tile_cols(C) columns
// (pass Y's result, as pass X reads it), each warp's ballots of one column's
// chunks, and the block's cuts (tile_cols(C) + 1 for kx, 3 for ky).
__host__ __device__ constexpr size_t tile_shmem(int C) {
  return static_cast<size_t>(4) * tile_cols(C) * C + 4 * kTileWarps * kBallots * ((C + 31) / 32) +
         4 * (tile_cols(C) + 4);
}
static_assert(tile_shmem(kMaxC) <= 232448, "a tile fits one H100 block's shared memory");

struct Geom {
  int k, gh, gw, C;
  int row0, rows;  // own global rows [row0, row0 + rows)
  float x_min, y_min, cell_w, cell_h;
  float dt, gdt;  // the predict's step and gravity * dt (rebin_tile<true>)
  __device__ __forceinline__ bool own(int rr) const { return rr >= row0 && rr < row0 + rows; }
};

// The input planes: the own rows, and the ghost rows of a band (null for K1,
// whose ghost rows lie outside the grid and are never read).
struct Src {
  const float* own[rps::kMaxChannels];  // [rows, gw, C]
  const float* lo1[rps::kMaxChannels];  // global row row0 - 1, [gw, C]
  const float* hi1[rps::kMaxChannels];  // global row row0 + rows
  const float* lo2[2];                  // global row row0 - 2: x, y
};

// Row rr (global, row0 - 1 <= rr <= row0 + rows) of channel ch.
__device__ __forceinline__ const float* row_of(const Src& s, const Geom& g, int ch, int rr) {
  if (rr == g.row0 - 1) return s.lo1[ch];
  if (rr == g.row0 + g.rows) return s.hi1[ch];
  return s.own[ch] + static_cast<size_t>(rr - g.row0) * g.gw * g.C;
}

// x (ch 0) or y (ch 1) of row rr, row0 - 2 <= rr <= row0 + rows.
__device__ __forceinline__ const float* xy_row(const Src& s, const Geom& g, int ch, int rr) {
  return rr == g.row0 - 2 ? s.lo2[ch] : row_of(s, g, ch, rr);
}

constexpr float kDead = rps::kSentinel;  // x of a slot that is not read

// Gravity and the predict (compute_shader.wgsl:397-405) of one raw slot, as
// the frame's plain predict_planes rounds them, op by op and never fused: a
// live slot (px < 0.5 * SENTINEL) takes vy - g dt and moves to (px + vx dt,
// py + (vy - g dt) dt); a dead one parks at SENTINEL.  The rebin then tests
// the predicted x for liveness, as it tests a predicted plane.
__device__ __forceinline__ void predict(const Geom& g, float& x, float& y, float vx, float vy) {
  const bool live = x < rps::kLiveBelow;
  const float vyp = __fsub_rn(vy, g.gdt);
  x = live ? __fadd_rn(x, __fmul_rn(vx, g.dt)) : rps::kSentinel;
  y = live ? __fadd_rn(y, __fmul_rn(vyp, g.dt)) : rps::kSentinel;
}

// x/y of slot `at` of row rr (global, row0 - 1 <= rr <= row0 + rows) as the
// rebin sees them: predicted from the row's four channels where kPredict and
// rr is an own row, else as they lie.
template <bool kPredict>
__device__ __forceinline__ void load_xy(const Src& s, const Geom& g, int rr, size_t at, float& x,
                                        float& y) {
  x = __ldg(row_of(s, g, 0, rr) + at);
  y = __ldg(row_of(s, g, 1, rr) + at);
  if (kPredict && g.own(rr))
    predict(g, x, y, __ldg(row_of(s, g, 2, rr) + at), __ldg(row_of(s, g, 3, rr) + at));
}

// A read-only load that stays where it is written: the compiler would sink a
// load into the branch of the live test that uses it, so that a chunk's rows
// were read one latency after another.
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// "key >= j" for key = cell_of(v, lo, w, n), as one compare of a = v - lo.
// cell_of is clip(floor(RN(a / w)), 0, n - 1), and a correctly rounded
// division by w > 0 is monotone in a, so the a with key >= j (1 <= j < n) are
// those >= the least float t_j that reaches j; a NaN keys to 0.  Per slot a
// subtraction and a compare then stand for an IEEE division.
struct Cut {
  float t;
  bool always, never;  // j <= 0; j >= n
  __device__ __forceinline__ bool at(float a) const { return always || (!never && a >= t); }
};

__device__ __forceinline__ bool reaches(float a, float w, int j) {
  return floorf(a / w) >= static_cast<float>(j);
}

// t_j for 1 <= j < n: positive, so the floats next to it are its bit
// pattern -+ 1.
__device__ float least_reaching(int j, float w) {
  float t = static_cast<float>(j) * w;  // within a few ulps of t_j
  const auto step = [](float v, int d) { return __int_as_float(__float_as_int(v) + d); };
  while (reaches(step(t, -1), w, j)) t = step(t, -1);
  while (!reaches(t, w, j)) t = step(t, 1);
  return t;
}

// The cut for j, its t_j (if any) from a block's table.
__device__ __forceinline__ Cut cut_of(int j, int n, const float* t_j) {
  return Cut{j >= 1 && j < n ? *t_j : 0.0f, j <= 0, j >= n};
}

// What pass X reads of a mid slot: -1 dead (a fill), else (source << 2) |
// its class in column c': 1 if its key row is r and kx < c' (it moves left),
// 2 if its key row is r and kx > c' (right), 0 if it stays.
constexpr int kLeft = 1, kRight = 2;

struct Cuts {
  Cut row, below;       // ky >= r, ky >= r + 1
  Cut col, right;       // kx >= c', kx >= c' + 1
  float y_min, x_min;
  __device__ __forceinline__ int cls(float x, float y) const {
    const float ay = y - y_min, ax = x - x_min;
    if (!row.at(ay) || below.at(ay)) return 0;  // key row is not r
    return !col.at(ax) ? kLeft : (right.at(ax) ? kRight : 0);
  }
  // Whether (x, y) keys to cell (r, c') itself.
  __device__ __forceinline__ bool home(float x, float y) const {
    const float ay = y - y_min, ax = x - x_min;
    return row.at(ay) && !below.at(ay) && col.at(ax) && !right.at(ax);
  }
};

// The walks' position planes, [rows, gw, C] each; null when not asked for.
struct WalkPlanes {
  float* x;
  float* y;
};

// Phase Y's rows of a column, by index: r, r-1, r+1, r-2.
constexpr int kRows = 4;
__host__ __device__ constexpr int row_delta(int i) {
  return i == 0 ? 0 : i == 1 ? -1 : i == 2 ? 1 : -2;
}

// x/y of one slot in the four rows phase Y reads, as loaded.
struct Fetched {
  float x[kRows], y[kRows];
};

// Source codes: input slot `slot` of row r + dr, column c + dc, for an own
// cell (r, c).  Pass Y's codes have dc = 0.
__device__ __forceinline__ int source(int dr, int dc, int slot) {
  return slot + 1024 * ((dr + 1) + 3 * (dc + 1));
}
constexpr int kColumnStep = 3 * 1024;  // source(dr, dc + 1, s) - source(dr, dc, s)

// Slot of the n-th set bit (0-based) of the ballots bal[0], bal[kBallots], ...
// (one word per 32-slot chunk); the caller knows it exists.
__device__ __forceinline__ int nth_set(const unsigned* bal, int n) {
  int q = 0;
  unsigned b = bal[0];
  for (int pc = __popc(b); n >= pc; pc = __popc(b)) {
    n -= pc;
    b = bal[++q * kBallots];
  }
  for (; n > 0; --n) b &= b - 1;
  return q * 32 + __ffs(b) - 1;
}

// Phase Y for column c of row r, by one warp: mid[s], the pass-X word of
// each mid slot.  ky_up: ky >= r - 1; k: the row's and this column's cuts.
// bal: the warp's scratch, kBallots words per chunk.
template <bool kPredict>
__device__ __forceinline__ void column_y(const Src& src, const Geom& g, int r, int c,
                                         const Cut& ky_up, Cuts k, const float* xcut, int* mid,
                                         unsigned* bal) {
  const int lane = threadIdx.x & 31, C = g.C, nchunk = (C + 31) / 32;
  const unsigned below = (1u << lane) - 1u;
  const bool has_up = r >= 1, has_dn = r <= g.gh - 2, has_up2 = r >= 2;
  k.col = cut_of(c, g.gw, xcut);
  k.right = cut_of(c + 1, g.gw, xcut + 1);
  const size_t col = static_cast<size_t>(c) * C;
  // Each row's x/y at this column (null where the row is not read), and
  // whether it is predicted at load: an own row, when kPredict.  An own row's
  // vx and vy lie at fixed byte distances from its x (the planes' own), so
  // they need no pointers of their own.
  const bool has[kRows] = {true, has_up, has_dn, has_up2};
  const float* xs[kRows];
  const float* ys[kRows];
  bool pred[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rr = r + row_delta(i);
    xs[i] = has[i] ? xy_row(src, g, 0, rr) + col : nullptr;
    ys[i] = has[i] ? xy_row(src, g, 1, rr) + col : nullptr;
    pred[i] = kPredict && has[i] && g.own(rr);
  }
  const uintptr_t x_at = reinterpret_cast<uintptr_t>(src.own[0]);
  const uintptr_t to_vx = reinterpret_cast<uintptr_t>(src.own[2]) - x_at;
  const uintptr_t to_vy = reinterpret_cast<uintptr_t>(src.own[3]) - x_at;
  const auto at = [](const float* p, uintptr_t d) {
    return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) + d);
  };

  // Pass 1: predicates, their ballots and totals; each own slot's word.
  // 0 keep_m1 (row r-1's slot moves here), 1 keep_p1 (row r+1's), 2 dead,
  // 3 into_m1 (moves to row r-1), 4 into_p1, 5 row r-2's slot moves to row
  // r-1, 6 dead in row r-1, 7 dead in row r+1.
  int tot[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  // x/y of the four rows at slot s, as they lie (a dead x where not read).
  const auto fetch = [&](int s) {
    Fetched v;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      v.x[i] = kDead;
      v.y[i] = 0.0f;
      if (s < C && xs[i]) {
        v.x[i] = load_now(xs[i] + s);
        v.y[i] = load_now(ys[i] + s);
      }
    }
    return v;
  };
  // The next chunk's eight loads are in flight while this one is ranked.
  Fetched next = fetch(lane);
  for (int q = 0; q < nchunk; ++q) {
    const int s = q * 32 + lane;
    const bool act = s < C;
    Fetched v = next;
    if (q + 1 < nchunk) next = fetch(s + 32);
    if (kPredict) {  // the velocities of the live slots of predicted rows, then the predict
      float vx[kRows], vy[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        vx[i] = vy[i] = 0.0f;
        if (pred[i] && v.x[i] < kLiveBelow) {
          vx[i] = load_now(at(xs[i] + s, to_vx));
          vy[i] = load_now(at(xs[i] + s, to_vy));
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (pred[i]) predict(g, v.x[i], v.y[i], vx[i], vy[i]);
    }
    const float x = v.x[0], y = v.y[0], xm = v.x[1], ym = v.y[1], xp = v.x[2], yp = v.y[2],
                xm2 = v.x[3], ym2 = v.y[3];
    const bool live0 = x < kLiveBelow;
    const float a0 = y - g.y_min;
    const bool p[8] = {
        xm < kLiveBelow && k.row.at(ym - g.y_min),      // ky >= r
        xp < kLiveBelow && !k.below.at(yp - g.y_min),   // ky <= r
        act && !live0,
        live0 && has_up && !k.row.at(a0),               // ky <= r - 1
        live0 && has_dn && k.below.at(a0),              // ky >= r + 1
        xm2 < kLiveBelow && ky_up.at(ym2 - g.y_min),    // ky >= r - 1
        has_up && act && !(xm < kLiveBelow),
        has_dn && act && !(xp < kLiveBelow)};
    if (act) mid[s] = live0 ? source(0, 0, s) << 2 | k.cls(x, y) : -1;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const unsigned b = __ballot_sync(0xffffffffu, p[f]);
      tot[f] += __popc(b);
      if (f < kBallots && lane == f) bal[q * kBallots + f] = b;
    }
  }
  __syncwarp();

  // Pass 2: hole h takes arrival h (row r-1's keeps, then row r+1's) while
  // h < #arrivals; a mover that its neighbour row adopted leaves a fill.
  const int n_up = tot[0], n_arr = tot[0] + tot[1];
  int pre_d = 0, pre_u = 0, pre_n = 0;
  for (int q = 0; q < nchunk; ++q) {
    const int s = q * 32 + lane;
    const unsigned bd = bal[q * kBallots + 2], bu = bal[q * kBallots + 3],
                   bn = bal[q * kBallots + 4];
    const bool dead = (bd >> lane) & 1u;
    const int hrank = pre_d + __popc(bd & below);
    const bool adopted =
        (((bu >> lane) & 1u) && tot[5] + pre_u + __popc(bu & below) < tot[6]) ||
        (((bn >> lane) & 1u) && pre_n + __popc(bn & below) < tot[7]);
    pre_d += __popc(bd);
    pre_u += __popc(bu);
    pre_n += __popc(bn);
    if (s >= C) continue;
    if (dead && hrank < n_arr) {
      const bool from_up = hrank < n_up;
      const int w = from_up ? nth_set(bal, hrank) : nth_set(bal + 1, hrank - n_up);
      float x, y;
      load_xy<kPredict>(src, g, from_up ? r - 1 : r + 1, col + w, x, y);
      mid[s] = source(from_up ? -1 : 1, 0, w) << 2 | k.cls(x, y);
    } else if (adopted) {
      mid[s] = -1;
    }
  }
  __syncwarp();  // the scratch is rewritten by the warp's next column
}

// Phase X for own column c of row r, by one warp, on the shared words of
// columns c-2..c+1 (mid + d * C is column c + d): the composed sources, the
// gather (predicted at load where kPredict and the source row is an own
// row), the walk planes and the cell's count.  k: the row's cuts; xcut: this
// column's.
template <bool kPredict>
__device__ __forceinline__ void column_x(const Src& src, const OutPlanes& out,
                                         const WalkPlanes& walk, int* __restrict__ counts,
                                         const rps::Fills& fills, const Geom& g, int r, int c,
                                         Cuts k, const float* xcut, const int* mid,
                                         unsigned* bal) {
  const int lane = threadIdx.x & 31, C = g.C, nchunk = (C + 31) / 32;
  const unsigned below = (1u << lane) - 1u;
  const bool has_l = c >= 1, has_r = c <= g.gw - 2, has_l2 = c >= 2;
  k.col = cut_of(c, g.gw, xcut);
  k.right = cut_of(c + 1, g.gw, xcut + 1);
  const auto moves = [](int m, int way) { return (m & 3) == way; };  // false for -1

  // Pass 1.  0 kg0 (column c-1's slot moves here), 1 kg1 (column c+1's),
  // 2 dead, 3 into_l (moves to column c-1), 4 into_r, 5 column c-2's slot
  // moves to column c-1, 6 dead in column c-1, 7 dead in column c+1.
  int tot[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int q = 0; q < nchunk; ++q) {
    const int s = q * 32 + lane;
    const bool act = s < C;
    const int m = act ? mid[s] : 0;
    const int ml = act && has_l ? mid[s - C] : 0;
    const int mr = act && has_r ? mid[s + C] : 0;
    const int ml2 = act && has_l2 ? mid[s - 2 * C] : 0;
    const bool p[8] = {moves(ml, kRight), moves(mr, kLeft), act && m < 0,
                       has_l && moves(m, kLeft), has_r && moves(m, kRight),
                       moves(ml2, kRight), ml < 0, mr < 0};
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const unsigned b = __ballot_sync(0xffffffffu, p[f]);
      tot[f] += __popc(b);
      if (f < kBallots && lane == f) bal[q * kBallots + f] = b;
    }
  }
  __syncwarp();

  // Pass 2: the composed sources and the gather.
  const int n_left = tot[0], n_arr = tot[0] + tot[1];
  const size_t o0 = (static_cast<size_t>(r - g.row0) * g.gw + c) * C;
  int pre_d = 0, pre_l = 0, pre_r = 0, live = 0;
  for (int q = 0; q < nchunk; ++q) {
    const int s = q * 32 + lane;
    const unsigned bd = bal[q * kBallots + 2], bl = bal[q * kBallots + 3],
                   br = bal[q * kBallots + 4];
    const bool dead = (bd >> lane) & 1u;
    const int hrank = pre_d + __popc(bd & below);
    const bool adopted =
        (((bl >> lane) & 1u) && tot[5] + pre_l + __popc(bl & below) < tot[6]) ||
        (((br >> lane) & 1u) && pre_r + __popc(br & below) < tot[7]);
    pre_d += __popc(bd);
    pre_l += __popc(bl);
    pre_r += __popc(br);
    const bool act = s < C;
    int cd = -1;
    if (act && !dead && !adopted) {
      cd = mid[s] >> 2;
    } else if (dead && hrank < n_arr) {
      const bool from_l = hrank < n_left;
      const int w = from_l ? nth_set(bal, hrank) : nth_set(bal + 1, hrank - n_left);
      cd = from_l ? (mid[w - C] >> 2) - kColumnStep : (mid[w + C] >> 2) + kColumnStep;
    }
    live += __popc(__ballot_sync(0xffffffffu, cd >= 0));
    if (!act) continue;
    const size_t o = o0 + s;
    if (cd < 0) {
      for_channels(g.k, [&](int ch) { out.p[ch][o] = fills.v[ch]; });
      if (walk.x) {
        walk.x[o] = fills.v[0];
        walk.y[o] = fills.v[1];
      }
      continue;
    }
    const int t = cd >> 10, dr = t % 3 - 1, dc = t / 3 - 1;
    const size_t from = static_cast<size_t>(c + dc) * C + (cd & 1023);
    float v[rps::kMaxChannels];
    for_channels(g.k, [&](int ch) { v[ch] = __ldg(row_of(src, g, ch, r + dr) + from); });
    // A composed source is live after the predict (phase Y classed it so),
    // so live before it: the live branch of predict(), the velocity kept.
    if (kPredict && g.own(r + dr)) {
      v[3] = __fsub_rn(v[3], g.gdt);
      v[0] = __fadd_rn(v[0], __fmul_rn(v[2], g.dt));
      v[1] = __fadd_rn(v[1], __fmul_rn(v[3], g.dt));
    }
    for_channels(g.k, [&](int ch) { out.p[ch][o] = v[ch]; });
    if (walk.x) {
      const bool defer = v[0] < kLiveBelow && !k.home(v[0], v[1]);
      walk.x[o] = defer ? rps::kSentinel : v[0];
      walk.y[o] = defer ? rps::kSentinel : v[1];
    }
  }
  if (lane == 0) counts[(r - g.row0) * g.gw + c] = live;
  __syncwarp();  // the scratch is rewritten by the warp's next column
}

// Block (x, y): own columns [x T, x T + T) (those inside the grid) of own
// row row0 + y, T = tile_cols(C) - 3.  kPredict: the own rows are the raw
// state, predicted at load.  Four blocks an SM: the predict at load would
// take 80 registers a thread and three blocks; held to 64 it spills a few
// words and runs faster (PERF.md, section 6).
template <bool kPredict>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    rebin_tile(Src src, OutPlanes out, WalkPlanes walk, int* __restrict__ counts,
               rps::Fills fills, Geom g) {
  extern __shared__ int smem[];
  const int C = g.C, ncols = tile_cols(C), T = ncols - 3;
  int* mid = smem;  // [ncols][C]: tile column j is grid column c0 - 2 + j
  const int warp = threadIdx.x >> 5;
  unsigned* bal_base = reinterpret_cast<unsigned*>(mid + ncols * C);
  unsigned* bal = bal_base + warp * kBallots * ((C + 31) / 32);
  const int r = g.row0 + blockIdx.y, c0 = blockIdx.x * T;
  // The cuts this block uses, one thread each: t_j of kx for the tile's
  // columns c0-2 .. c0+T+1 (each column's own and the next) and of ky for rows
  // r-1, r, r+1.
  float* cuts = reinterpret_cast<float*>(bal_base + kTileWarps * kBallots * ((C + 31) / 32));
  if (threadIdx.x <= ncols) {
    const int j = c0 - 2 + static_cast<int>(threadIdx.x);
    if (j >= 1 && j < g.gw) cuts[threadIdx.x] = least_reaching(j, g.cell_w);
  } else if (threadIdx.x <= ncols + 3) {
    const int j = r - 2 + static_cast<int>(threadIdx.x) - ncols;
    if (j >= 1 && j < g.gh) cuts[threadIdx.x] = least_reaching(j, g.cell_h);
  }
  __syncthreads();
  const float* ycut = cuts + ncols + 1;  // rows r-1, r, r+1
  const Cut ky_up = cut_of(r - 1, g.gh, ycut);
  const Cuts k{cut_of(r, g.gh, ycut + 1), cut_of(r + 1, g.gh, ycut + 2), {}, {}, g.y_min, g.x_min};

  for (int j = warp; j < ncols; j += kTileWarps) {
    const int c = c0 - 2 + j;
    if (c >= 0 && c < g.gw) column_y<kPredict>(src, g, r, c, ky_up, k, cuts + j, mid + j * C,
                                                bal);
  }
  __syncthreads();
  for (int j = 2 + warp; j < 2 + T; j += kTileWarps) {
    const int c = c0 - 2 + j;
    if (c < g.gw) column_x<kPredict>(src, out, walk, counts, fills, g, r, c, k, cuts + j,
                                     mid + j * C, bal);
  }
}

}  // namespace

// (Its arguments: the record struct below, common.cuh's rps::unpack.)
// own: k device pointers, each a [rows, gw, C] f32 plane (channels 0/1 are
// x/y); lo2: x/y of global row row0-2, lo1/hi1: every channel of rows row0-1
// and row0+rows, each [gw, C] (K7; null for K1, rows = gh); out: k [rows, gw,
// C] planes; walk: the walks' x/y planes, [rows, gw, C] each, or both null;
// counts: [rows*gw] i32.  gh is the whole grid's height; the
// launch owns global rows [row0, row0 + rows).  fills[0] must be >= 0.5 *
// SENTINEL (a filled slot is dead); the wrapper checks it.  predict: 1 if own
// holds the raw (px, py, vx, vy, ...) channels, to be predicted at load with
// dt and gdt = gravity * dt (k >= 4; the ghost rows come predicted), else 0.
struct rps_rebin_args {
  const float* own[8];
  const float* lo2[2];
  const float* lo1[8];
  const float* hi1[8];
  float* out[8];
  float* walk[2];
  int* counts;
  float fills[8];
  int k, gh, gw, C, row0, rows, predict;
  float x_min, y_min, cell_w, cell_h, dt, gdt;
  void* stream;
};

extern "C" int rps_rebin(const void* packed, int size) {
  rps_rebin_args a;
  if (!rps::unpack(packed, size, &a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.k < 2 || a.k > rps::kMaxChannels || a.C < 1 || a.C > kMaxC || a.rows < 1 ||
      a.row0 < 0 || a.row0 + a.rows > a.gh || a.gw < 1 || !a.walk[0] != !a.walk[1] ||
      (a.predict != 0 && (a.predict != 1 || a.k < 4)) ||
      static_cast<long long>(a.gh) * a.gw >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Src src{};
  OutPlanes out{};
  rps::Fills fills{};
  for (int i = 0; i < a.k; ++i) {
    src.own[i] = a.own[i];
    src.lo1[i] = a.lo1[i];
    src.hi1[i] = a.hi1[i];
    out.p[i] = a.out[i];
    fills.v[i] = a.fills[i];
  }
  src.lo2[0] = a.lo2[0];
  src.lo2[1] = a.lo2[1];
  const Geom g{a.k,      a.gh,     a.gw,     a.C,      a.row0, a.rows,
               a.x_min,  a.y_min,  a.cell_w, a.cell_h, a.dt,   a.gdt};
  const int T = tile_cols(a.C) - 3;
  const size_t shmem = tile_shmem(a.C);
  const auto kernel = a.predict ? rebin_tile<true> : rebin_tile<false>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.gw + T - 1) / T, a.rows);
  const WalkPlanes walk{a.walk[0], a.walk[1]};
  kernel<<<grid, kTileThreads, shmem, static_cast<cudaStream_t>(a.stream)>>>(src, out, walk,
                                                                           a.counts, fills, g);
  return static_cast<int>(cudaGetLastError());
}
