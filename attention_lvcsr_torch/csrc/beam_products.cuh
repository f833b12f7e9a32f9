// The products of the whole-loop decode kernel (beam_loop.cu):
// out[r, c] (+)= sum_k in[r * ldi + k] * W[k * N + c]  (+ bias[c])
// for the K hypothesis rows r and the N columns c of one table W.
//
// Every element is computed exactly as a plain dot product in k order:
// acc = 0; acc = fmaf(x[r, k], W[k, c], acc) for k = 0 .. Kd-1; then
// v = acc + bias[c]; out = accumulate ? out + v : v.  The design only
// decides which thread computes an element and where its operands come
// from; it never splits or reorders k.
//
// Work split: a thread owns a pair of adjacent columns and one row group
// of at most kMaxGroupRows rows, and keeps the 2 x rows sums in registers.
// The rows split into as many groups as the 512 threads allow
// (product_plan), so that all threads have work at every width: at K=10,
// N=500 two groups of 5 rows, at N=250 four of 3, 3, 2 and 2.  The groups
// interleave along the thread index, so a warp's lanes share the weights
// of 32 / groups column pairs.  Per k, a thread reads its two weights as one
// float2 and each of its rows' inputs as a float2 covering two k (a
// broadcast within each group): one shared-memory load for every 4 FMAs
// of a row pair, against one a FMA before.  Ragged edges take scalar
// loads: an odd N or an odd table address (weights), an odd row pitch
// (inputs), a first k on an odd address (one scalar step first), an odd
// number of k left (one scalar step last).
//
// The weights come from L2 (each block reads each table once a step),
// kBatch rows of a thread's column pair loaded before their FMAs.  Two
// ways to hide more of that latency measured slower on the H100 (PERF.md,
// section 6): a ring of cp.async stages in shared memory issued ahead
// across the phases, and L1 prefetches of the rows a few dozen ahead.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kProdThreads = 512;   // the decode kernel's block size
constexpr int kMaxGroupRows = 8;    // register rows a thread

// How one product over nrows x N outputs is split over the block.
struct ProductPlan {
  int units;    // column pairs, ceil(N / 2)
  int groups;   // row groups
  int rows;     // rows of the largest group
  int passes;   // sweeps over the block's threads, ceil(units * groups / 512)
};

__host__ __device__ inline ProductPlan product_plan(int nrows, int N) {
  ProductPlan p;
  p.units = (N + 1) / 2;
  int g = kProdThreads / p.units;
  g = g < nrows ? g : nrows;
  const int need = (nrows + kMaxGroupRows - 1) / kMaxGroupRows;
  g = g > need ? g : need;
  p.groups = g > 1 ? g : 1;
  p.rows = (nrows + p.groups - 1) / p.groups;
  p.passes = (p.units * p.groups + kProdThreads - 1) / kProdThreads;
  return p;
}

// One product: K rows of `in` (shared memory, row pitch ldi) times the
// (kd, n) row-major table w (global memory).
struct Product {
  const float* in;
  int ldi;
  const float* w;
  int kd, n;
  const float* bias;   // (n,) or null
  float* out;
  int ldo;
  bool accumulate;
};

__device__ __forceinline__ float2 load_w2(const float* p, bool pair,
                                          bool second) {
  if (pair) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), second ? __ldg(p + 1) : 0.f);
}

// acc[j][0..1] += x[j, k] * w[k, c..c+1] for k in [ka, kb), rows j < nr.
// x points at the group's first row; w at the table's row ka, column 0.
// XP: the row pitch is even, so a float2 of x is aligned where
// (k + xodd) is even; WP: float2 weight loads are aligned.
template <int G, bool XP, bool WP>
__device__ __forceinline__ void fma_span(float (&acc)[G][2], const float* x,
                                         int ldi, int nr, int xodd,
                                         const float* w, int N, int c,
                                         int ka, int kb) {
  const bool second = c + 1 < N;
  auto wrow = [&](int k) {
    return load_w2(w + (size_t)(k - ka) * N + c, WP, second);
  };
  auto step1 = [&](int k, float2 wv) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < nr) {
        const float xs = x[j * ldi + k];
        acc[j][0] = fmaf(xs, wv.x, acc[j][0]);
        acc[j][1] = fmaf(xs, wv.y, acc[j][1]);
      }
  };
  auto step2 = [&](int k, float2 wa, float2 wb) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < nr) {
        const float* xr = x + j * ldi + k;
        const float2 xv = XP ? *reinterpret_cast<const float2*>(xr)
                             : make_float2(xr[0], xr[1]);
        acc[j][0] = fmaf(xv.x, wa.x, acc[j][0]);
        acc[j][1] = fmaf(xv.x, wa.y, acc[j][1]);
        acc[j][0] = fmaf(xv.y, wb.x, acc[j][0]);
        acc[j][1] = fmaf(xv.y, wb.y, acc[j][1]);
      }
  };
  constexpr int kBatch = 8;   // weight rows loaded before their FMAs
  int k = ka;
  if (XP && k < kb && ((k + xodd) & 1)) {
    step1(k, wrow(k));
    ++k;
  }
  for (; k + kBatch <= kb; k += kBatch) {
    float2 wv[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) wv[q] = wrow(k + q);
#pragma unroll
    for (int q = 0; q < kBatch; q += 2) step2(k + q, wv[q], wv[q + 1]);
  }
  for (; k + 2 <= kb; k += 2) step2(k, wrow(k), wrow(k + 1));
  if (k < kb) step1(k, wrow(k));
}

template <int G>
__device__ __noinline__ void product_rows(Product p, int nrows,
                                          ProductPlan pl) {
  const int items = pl.units * pl.groups;
  const int base = nrows / pl.groups, extra = nrows % pl.groups;
  const bool xp = p.ldi % 2 == 0;
  const int xodd = (int)((reinterpret_cast<uintptr_t>(p.in) >> 2) & 1);
  const bool wp = p.n % 2 == 0 &&
                  (reinterpret_cast<uintptr_t>(p.w) & 7) == 0;
  for (int pass = 0; pass < pl.passes; ++pass) {
    const int item = pass * kProdThreads + (int)threadIdx.x;
    if (item >= items) continue;
    const int q = item % pl.groups, c = 2 * (item / pl.groups);
    const int r0 = q * base + min(q, extra), nr = base + (q < extra ? 1 : 0);
    const float* x = p.in + r0 * p.ldi;
    float acc[G][2];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j][0] = acc[j][1] = 0.f;
    if (xp && wp)
      fma_span<G, true, true>(acc, x, p.ldi, nr, xodd, p.w, p.n, c, 0, p.kd);
    else if (xp)
      fma_span<G, true, false>(acc, x, p.ldi, nr, xodd, p.w, p.n, c, 0, p.kd);
    else if (wp)
      fma_span<G, false, true>(acc, x, p.ldi, nr, xodd, p.w, p.n, c, 0, p.kd);
    else
      fma_span<G, false, false>(acc, x, p.ldi, nr, xodd, p.w, p.n, c, 0,
                                p.kd);
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < nr)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          if (c + cc < p.n) {
            float v = acc[j][cc];
            if (p.bias != nullptr) v = v + p.bias[c + cc];
            float* o = p.out + (r0 + j) * p.ldo + c + cc;
            *o = p.accumulate ? *o + v : v;
          }
  }
}

// A product whose row r reads its input at p.in + rows[r] * p.ldi (the
// feedback embedding's row of each hypothesis's symbol, read from global
// memory): each element the same k-ordered fmaf sum as product_rows', the
// inputs loaded as scalars, kBatch weight rows before their FMAs.
template <int G>
__device__ __noinline__ void product_rows_gathered(Product p, const int* rows,
                                                   int nrows, ProductPlan pl) {
  const int items = pl.units * pl.groups;
  const int base = nrows / pl.groups, extra = nrows % pl.groups;
  const bool wp = p.n % 2 == 0 &&
                  (reinterpret_cast<uintptr_t>(p.w) & 7) == 0;
  for (int pass = 0; pass < pl.passes; ++pass) {
    const int item = pass * kProdThreads + (int)threadIdx.x;
    if (item >= items) continue;
    const int q = item % pl.groups, c = 2 * (item / pl.groups);
    const int r0 = q * base + min(q, extra), nr = base + (q < extra ? 1 : 0);
    const bool second = c + 1 < p.n;
    const float* x[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      x[j] = p.in + (size_t)rows[r0 + min(j, nr - 1)] * p.ldi;
    float acc[G][2];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j][0] = acc[j][1] = 0.f;
    constexpr int kBatch = 8;
    int k = 0;
    for (; k < p.kd; k += kBatch) {
      const int nk = min(kBatch, p.kd - k);
      float2 wv[kBatch];
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
        if (s < nk)
          wv[s] = load_w2(p.w + (size_t)(k + s) * p.n + c, wp, second);
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
        if (s < nk)
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (j < nr) {
              const float xs = __ldg(x[j] + k + s);
              acc[j][0] = fmaf(xs, wv[s].x, acc[j][0]);
              acc[j][1] = fmaf(xs, wv[s].y, acc[j][1]);
            }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < nr)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          if (c + cc < p.n) {
            float v = acc[j][cc];
            if (p.bias != nullptr) v = v + p.bias[c + cc];
            float* o = p.out + (r0 + j) * p.ldo + c + cc;
            *o = p.accumulate ? *o + v : v;
          }
  }
}

__device__ void run_product_gathered(const Product& p, const int* rows,
                                     int nrows) {
  const ProductPlan pl = product_plan(nrows, p.n);
  switch (pl.rows) {
    case 1: product_rows_gathered<1>(p, rows, nrows, pl); break;
    case 2: product_rows_gathered<2>(p, rows, nrows, pl); break;
    case 3: product_rows_gathered<3>(p, rows, nrows, pl); break;
    case 4: product_rows_gathered<4>(p, rows, nrows, pl); break;
    case 5: product_rows_gathered<5>(p, rows, nrows, pl); break;
    case 6: product_rows_gathered<6>(p, rows, nrows, pl); break;
    default: product_rows_gathered<8>(p, rows, nrows, pl); break;
  }
}

// Every thread of the block calls it; the caller separates products that
// read what another wrote with __syncthreads().
__device__ void run_product(const Product& p, int nrows) {
  const ProductPlan pl = product_plan(nrows, p.n);
  switch (pl.rows) {
    case 1: product_rows<1>(p, nrows, pl); break;
    case 2: product_rows<2>(p, nrows, pl); break;
    case 3: product_rows<3>(p, nrows, pl); break;
    case 4: product_rows<4>(p, nrows, pl); break;
    case 5: product_rows<5>(p, nrows, pl); break;
    case 6: product_rows<6>(p, nrows, pl); break;
    default: product_rows<8>(p, nrows, pl); break;
  }
}

}  // namespace
