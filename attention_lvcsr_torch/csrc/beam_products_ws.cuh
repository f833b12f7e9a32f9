// The products of the whole-loop decode kernel's workspace instances
// (beam_loop_ws.cu), whose K-row inputs and outputs live in an utterance's
// rows of a global workspace: out[r, c] (+)= sum_k in[r * ldi + k] *
// W[k * N + c] (+ bias[c]) for the rows r < nrows (row r read at
// rows[r] * ldi when `rows` is given: the feedback embedding's rows).
//
// Every element is computed as beam_products.cuh computes it: acc = 0;
// acc = fmaf(x[r, k], W[k, c], acc) for k = 0 .. Kd-1 in order; then
// v = acc + bias[c]; out = accumulate ? out + v : v.  So the workspace
// instances give the resident instances' bits, and the design only decides
// which thread computes an element and where its operands come from.
//
// What bounds it: at beams of hundreds a step's products are about 230 M
// fmaf per utterance (K=200 at the flagship widths), so the block's FMA
// issue; with beam_products.cuh's split (8-row groups interleaved along
// the threads) the lanes of a warp read 25 rows at once from the
// workspace, one cache line each, and each table crossed L2 once per row
// group (81 % of a beam-200 step, PERF.md section 5).
//
// What the design does about it: the block computes a tile of BM rows x
// BN columns at a time (BM x BN = 16384: a thread keeps an 8-row x
// 4-column register tile, the warps laid out 4 x 8 threads so that a
// warp's weight and input reads are each one shared-memory wavefront), and
// streams its operands through a ring of kRingStages stages of kRingK k
// rows in shared memory, filled with cp.async: the tile's input rows'
// k-chunk transposed (k-major, a thread's 8 rows one float4 pair) beside
// the weights' (kRingK x BN) chunk.  Each table crosses L2 once per row
// tile and each input once per column tile (ring_plan picks the tile
// shape with the fewest tiles, then the fewest staged floats); three
// stages need one barrier a chunk, and the chunks run on across the tiles
// of a product without draining.  f32 fmaf only: a tensor core's TF32
// would change the bits.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "beam_products.cuh"
#include "sm90_async.cuh"

namespace {

constexpr int kRingK = 16;        // k rows a stage
constexpr int kRingStages = 3;    // one barrier a chunk
constexpr int kRingPad = 4;       // floats after each staged row
// a stage's floats: kRingK rows of (BM + pad) inputs and (BN + pad)
// weights, the widest over the tile shapes (BM + BN at most 32 + 512)
constexpr int kRingSpan = 32 + 512 + 2 * kRingPad;
constexpr int kRingStageFloats = kRingK * kRingSpan;
constexpr int kRingFloats = kRingStages * kRingStageFloats;

// A product's tiles: rg x cg threads, each 8 rows x 4 columns.
struct RingPlan {
  int rg, cg;   // row and column threads (rg * cg = 512)
  int bm, bn;   // a tile's rows (8 rg) and columns (4 cg)
  int rt, ct;   // row and column tiles
};

__host__ __device__ inline RingPlan ring_plan(int nrows, int N) {
  RingPlan best{};
  long best_tiles = 0, best_staged = 0;
  for (int rg = 4; rg <= 64; rg *= 2) {
    RingPlan p;
    p.rg = rg;
    p.cg = kProdThreads / rg;
    p.bm = 8 * rg;
    p.bn = 4 * p.cg;
    p.rt = (nrows + p.bm - 1) / p.bm;
    p.ct = (N + p.bn - 1) / p.bn;
    const long tiles = (long)p.rt * p.ct;
    // floats staged per k: each table row once a row tile, each input
    // column once a column tile
    const long staged = (long)p.rt * N + (long)p.ct * nrows;
    if (rg == 4 || tiles < best_tiles
        || (tiles == best_tiles && staged < best_staged)) {
      best = p;
      best_tiles = tiles;
      best_staged = staged;
    }
  }
  return best;
}

// Issue the cp.async copies of chunk g (tile g / nch, k-chunk g % nch)
// into stage `buf`: the inputs transposed, x[r, k0 + kk] at
// xs[kk * (bm + pad) + r], and the weights, W[k0 + kk, c0 + c] at
// ws[kk * (bn + pad) + c]; rows, k and columns past the edges zero-filled.
// A thread copies the same kk of rows tid / 16 + 32 i, and the same
// column (or 4 columns, 16 bytes at once, where the table's rows are
// 16-byte aligned) of every (512 / bn)-th k row.
__device__ __forceinline__ void ring_stage(const Product& p, const int* rows,
                                           int nrows, const RingPlan& pl,
                                           int bn_shift, bool w16, int nch,
                                           float* ring, int buf, int g) {
  const int tid = threadIdx.x;
  const int t = g / nch, k0 = (g - t * nch) * kRingK;
  const int tr = t / pl.ct;
  const int r0 = tr * pl.bm, c0 = (t - tr * pl.ct) * pl.bn;
  const int kc = min(kRingK, p.kd - k0);
  float* xs = ring + buf * kRingStageFloats;
  float* ws = xs + kRingK * (pl.bm + kRingPad);
  const int kk = tid & (kRingK - 1);
  for (int r = tid >> 4; r < pl.bm; r += kProdThreads / kRingK) {
    const int row = r0 + r;
    const bool ok = row < nrows && kk < kc;
    const float* src = p.in;
    if (ok)
      src = p.in + (size_t)(rows != nullptr ? rows[row] : row) * p.ldi + k0
            + kk;
    cp_async<4>(xs + kk * (pl.bm + kRingPad) + r, src, ok ? 4 : 0);
  }
  const int wp = pl.bn + kRingPad;
  if (w16) {
    // 4 columns a copy: bn / 4 copies a k row
    const int c = (tid << 2) & (pl.bn - 1), col = c0 + c;
    for (int q = tid >> (bn_shift - 2); q < kRingK;
         q += kProdThreads >> (bn_shift - 2)) {
      const bool ok = q < kc && col < p.n;
      cp_async<16>(ws + q * wp + c,
                   ok ? p.w + (size_t)(k0 + q) * p.n + col : p.w,
                   ok ? 16 : 0);
    }
  } else {
    const int c = tid & (pl.bn - 1), col = c0 + c;
    for (int q = tid >> bn_shift; q < kRingK; q += kProdThreads >> bn_shift) {
      const bool ok = q < kc && col < p.n;
      cp_async<4>(ws + q * wp + c,
                  ok ? p.w + (size_t)(k0 + q) * p.n + col : p.w, ok ? 4 : 0);
    }
  }
}

// acc[i][j] = fmaf(x[row i, k], w[k, col j], acc[i][j]) for the chunk's
// first kc k, in order.
template <int kChunk>
__device__ __forceinline__ void ring_fma(float (&acc)[8][4], const float* xs,
                                         int xpitch, const float* ws,
                                         int wpitch, int kc) {
#pragma unroll
  for (int kk = 0; kk < kChunk; ++kk) {
    if (kChunk != kRingK && kk >= kc) break;
    const float4 xa = *reinterpret_cast<const float4*>(xs + kk * xpitch);
    const float4 xb = *reinterpret_cast<const float4*>(xs + kk * xpitch + 4);
    const float4 wv = *reinterpret_cast<const float4*>(ws + kk * wpitch);
    const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
  }
}

// Beams up to kSmallRows keep beam_products.cuh's split over the
// workspace rows (beam_loop_body.cuh::ring_phases): a tile of 32 rows
// would leave most of its rows idle there.
constexpr int kSmallRows = 16;

// Every thread of the block calls it; it begins with a barrier (the ring's
// readers of the product before are done) and the caller separates
// products that read what another wrote with __syncthreads(), as for
// run_product.  `ring`: kRingFloats floats of the block's dynamic shared
// memory, 16-byte aligned.
__device__ __noinline__ void run_product_ws(Product p, const int* rows,
                                            int nrows, float* ring) {
  extern __shared__ float sm[];
  // the ring addressed from the shared array: shared-memory loads
  float* rs = sm + (ring - sm);
  __syncthreads();
  const RingPlan pl = ring_plan(nrows, p.n);
  const int bn_shift = __ffs(pl.bn) - 1;
  const bool w16 = p.n % 4 == 0
                   && (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  const int nch = max(1, (p.kd + kRingK - 1) / kRingK);
  const int total = pl.rt * pl.ct * nch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx = pl.cg / 8;   // warps across the columns
  const int ty = (warp / wx) * 4 + lane / 8, tx = (warp % wx) * 8 + lane % 8;
  const int xpitch = pl.bm + kRingPad, wpitch = pl.bn + kRingPad;
  ring_stage(p, rows, nrows, pl, bn_shift, w16, nch, rs, 0, 0);
  cp_async_commit();
  if (total > 1)
    ring_stage(p, rows, nrows, pl, bn_shift, w16, nch, rs, 1, 1);
  cp_async_commit();
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int t = 0, ch = 0, buf = 0;   // chunk g's tile, k-chunk and stage
  for (int g = 0; g < total; ++g) {
    cp_async_wait<1>();
    __syncthreads();   // chunk g landed; stage (g + 2) % 3 was read at g - 1
    if (g + 2 < total)
      ring_stage(p, rows, nrows, pl, bn_shift, w16, nch, rs,
                 buf == 0 ? 2 : buf - 1, g + 2);
    cp_async_commit();
    const int tr = t / pl.ct;
    const int r0 = tr * pl.bm + ty * 8, c0 = (t - tr * pl.ct) * pl.bn + tx * 4;
    if (r0 < nrows && c0 < p.n) {
      const float* xs = rs + buf * kRingStageFloats + ty * 8;
      const float* ws = rs + buf * kRingStageFloats + kRingK * xpitch
                        + tx * 4;
      const int kc = min(kRingK, p.kd - ch * kRingK);
      if (kc == kRingK)
        ring_fma<kRingK>(acc, xs, xpitch, ws, wpitch, kc);
      else
        ring_fma<kRingK - 1>(acc, xs, xpitch, ws, wpitch, kc);
    }
    if (ch == nch - 1) {
      // the tile's last chunk: its elements out, the sums anew
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (r0 + i < nrows && c0 + j < p.n) {
            float v = acc[i][j];
            if (p.bias != nullptr) v = v + p.bias[c0 + j];
            float* o = p.out + (size_t)(r0 + i) * p.ldo + c0 + j;
            *o = p.accumulate ? *o + v : v;
          }
          acc[i][j] = 0.f;
        }
      ch = 0;
      ++t;
    } else {
      ++ch;
    }
    buf = buf == 2 ? 0 : buf + 1;
  }
}

}  // namespace
