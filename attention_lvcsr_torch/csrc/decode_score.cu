// One decode score step of every hypothesis, on a thread-block cluster of
// 1-8 blocks per utterance.
//
// Replaces attention_lvcsr_tpu/ops/pallas/decode_score.py::
// fused_decode_score for conv attention with one filter, the softmax
// normalizer, no states in the readout and a tanh post-merge layer (what
// SequenceGenerator.fused_score_supported admits).  Per utterance and its
// K rows it runs the phases of the Pallas body in its order: the prior's
// window (window_around_median with the TPU kernel's median rule
// max(0, #(cumsum < 0.5) - 1), window_around_mean around sum_l w[l] * l
// (:76-77), or expanding at the row's step), the
// alignment convolution, the state projection, the energies, the masked
// softmax, the weighted average and the readout with log-softmax costs.
// Outputs: costs (U*K, V), the new weights and the windowed energies
// (U*K, L), the weighted averages (U*K, D).
//
// The Toeplitz band of the TPU kernel is built on the fly from the filter
// taps, and its triangular matrix becomes a warp prefix sum.
//
// What bounds it on the card: the energies' accurate tanhf, K * window *
// M of them (500k at the flagship shape; ~22 SASS instructions each, see
// attention_energy.cu), then the chain of small products that stream
// about 0.8 MB of weight tables and the utterance's encoder outputs from
// L2, and whose broadcast shared loads of their K rows hold the
// load/store unit.  So an utterance takes a cluster of C blocks
// (ops/decode_score.py::plan: the size whose clusters the card holds in
// the fewest waves, by cudaOccupancyMaxActiveClusters, the larger on a
// tie, among those whose layout fits), and the block of rank c works on
// its share:
//
//   * the state projection and the energies over its M columns (a partial
//     energy of every row and window frame), the convolution over the
//     whole window (every block needs it);
//   * cluster exchange 1: each block adds the C partial energies in rank
//     order from the peers' shared memory (DSMEM), then runs the masked
//     softmax of every row itself;
//   * the weighted average over its D columns, and the merge layer's
//     partial sum over those D (a K x R partial);
//   * cluster exchange 2: rank 0 adds the C partials in rank order, takes
//     the tanh, the post-merge layer and the log-softmax costs.
//
// Every product keeps the threads busy: a thread owns one output column
// of every row (RB rows in registers) over one of up to 16 slices of k,
// reads its weights straight from global memory 12 rows ahead in a loop
// without branches, and the slices' partial sums meet in shared memory in
// slice order.  No atomics: a second call repeats the bits.  The window phases (median_bounds,
// union_window, expanding_window, window_softmax, log_softmax_costs) are
// decode_step.cuh's, unchanged, which the whole-loop kernel shares; the
// energies' register tile is energy_tile.cuh's, which attention_energy.cu
// shares; the products and the convolution here are this kernel's own.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decode_step.cuh"
#include "energy_tile.cuh"
#include "sm90_async.cuh"

namespace cg = cooperative_groups;

// Must match the ctypes.Structure in ops/decode_score.py field for field.
struct DecodeScoreArgs {
  const float* pre;          // (U, L, M) preprocessed attended
  const float* attended;     // (U, L, D)
  const float* att_mask;     // (U, L)
  const float* weights;      // (U*K, L) previous alignment weights
  const int* step;           // (U*K,) decode step of each row
  const float* states;       // (U*K, S) decoder states
  const float* conv_taps;    // (n_taps,) the conv filter, true conv
  const float* state_trans;  // (S, M)
  const float* handler;      // (M,)
  const float* v;            // (M,) energy vector
  const float* merge_k;      // (D, R)
  const float* merge_b;      // (R,)
  const float* post_k;       // (R, V)
  const float* post_b;       // (V,)
  float* costs;              // (U*K, V)
  float* wnew;               // (U*K, L)
  float* energies;           // (U*K, L)
  float* wa;                 // (U*K, D)
  int U, L, M, D, S, R, V, K, n_taps, prior_median;
  float before, after, initial_begin, initial_end, min_speed, max_speed;
  int prior_mean;            // 1: window_around_mean
  int cluster;               // blocks an utterance: 1, 2, 4 or 8
};

namespace {

constexpr int kThreads = 512;
constexpr int kZone = 10240;         // floats: partial sums of slices, at most
constexpr int kMaxSmemFloats = 232448 / 4;   // a block's opt-in on sm_90
constexpr int kMaxSlices = 16;       // k slices of a product
constexpr int kAhead = 3;            // groups of 4 weight rows in flight

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// rows a product keeps in registers: all of them up to 16, blocks of 8
// above (so that the X buffers stay small at large beams)
__host__ __device__ inline int rows_block(int K) {
  return K <= 4 ? 4 : K <= 8 ? 8 : K <= 10 ? 10 : K <= 16 ? 16 : 8;
}

// The block's shared memory, offsets in floats, every buffer on a 16-byte
// boundary (mirrored by ops/decode_score.py::smem_layout).  Whole kernel:
//   mask (L), taps (n_taps), hand (M), v (M), begins (K), ends (K)
//   pe    (K, L)       the block's partial energies (read by the peers; on
//                      one block, e itself)
//   mp    (K, R)       the merge layer's partial sum (read by rank 0)
//   e     (K, L)       the energies, then the new weights
//   zone  (nzone)      partial sums of a product's slices: kZone floats,
//                      or what is left of a block's shared memory
// Until the energies, an early region:
//   wx    (kp, lde)    the windowed previous weights (zero outside the
//                      window): the convolution's X
//   h     (kp, ldh)    the decoder states
//   conv  (K, L)       the previous weights (w) until wx is made, then
//                      the convolution over the window
//   sp    (K, ldsp)    the state projection of the block's M columns
// after them, a late region in the same memory:
//   wt    (kp, lde)    the new weights: the weighted average's X
//   wa    (kp, ldwa)   the weighted averages of the block's D columns
//   act   (kp, ldact)  the activations; costs (K, V)
// The products' X buffers (wx, h, wt, wa, act) have kp rows, K rounded
// up to the products' row block, the rows past K zero.
struct ScoreLayout {
  int mask, taps, hand, v, begins, ends, pe, mp, e, zone;
  int w, wx, h, conv, sp;             // early
  int wt, wa, act, costs;             // late
  int total, nzone, mc, dc, lde, ldh, ldsp, ldwa, ldact, kp;
};

// The share of n columns rank c of C starts at: on a multiple of 4.
__host__ __device__ inline int share4(int n, int c, int C) {
  return min(n, 4 * (((n + 3) / 4) * c / C));
}

// The layout with a zone of nzone floats.
__host__ __device__ inline ScoreLayout score_layout(const DecodeScoreArgs& a,
                                                    int nzone) {
  ScoreLayout o;
  const int K = a.K, C = a.cluster;
  o.mc = 4 * (((a.M + 3) / 4 + C - 1) / C);   // the widest share
  o.dc = 4 * (((a.D + 3) / 4 + C - 1) / C);
  o.lde = round4(a.L);
  o.ldh = round4(a.S);
  o.ldsp = o.mc | 1;
  o.ldwa = o.dc;
  o.ldact = round4(a.R);
  o.kp = rows_block(K) * ((K + rows_block(K) - 1) / rows_block(K));
  int p = 0;
  auto take = [&p](int n) {
    const int at = p;
    p += round4(n);
    return at;
  };
  o.mask = take(a.L);
  o.taps = take(a.n_taps);
  o.hand = take(a.M);
  o.v = take(a.M);
  o.begins = take(K);
  o.ends = take(K);
  o.pe = C > 1 ? take(K * a.L) : -1;
  o.mp = take(K * a.R);
  o.e = take(K * a.L);
  if (C == 1) o.pe = o.e;
  o.nzone = nzone;
  o.zone = take(nzone);
  const int region = p;
  o.wx = take(o.kp * o.lde);
  o.h = take(o.kp * o.ldh);
  o.conv = take(K * a.L);
  o.w = o.conv;
  o.sp = take(K * o.ldsp);
  const int early = p;
  p = region;
  o.wt = take(o.kp * o.lde);
  o.wa = take(o.kp * o.ldwa);
  o.act = take(o.kp * o.ldact);
  o.costs = take(K * a.V);
  o.total = early > p ? early : p;
  return o;
}

// The layout: a zone of kZone floats, less where the block's shared
// memory cannot hold it (then the products take fewer k slices).
__host__ __device__ inline ScoreLayout score_layout(const DecodeScoreArgs& a) {
  const int rest = score_layout(a, 0).total;
  return score_layout(a, max(0, min(kZone, (kMaxSmemFloats - rest) & ~3)));
}

// out[r * ldo + c] = sum_{k < kd} X[r * ldx + k] * W[k * ldw + c]
// (+ bias[c]) for r < nrows, c < N.  X in shared memory: rows on 16-byte
// boundaries, nrows rounded up to a multiple of RB, zero past nrows and
// past kd up to round4(kd); W in global memory.  A thread owns a column of
// RB rows over one of KS slices of k (groups of 4 k).  Its loop has no
// branch: it keeps the next kAhead groups' weights in flight (rows past
// kd read the last row, which meets zeros of X) while it sums the current
// group into RB registers.  The slices' partial sums meet in ZONE in
// slice order.  Ends with __syncthreads.
template <int RB>
__device__ void product(const float* X, int ldx, int nrows, int kd,
                        const float* __restrict__ W, int ldw, int N,
                        const float* __restrict__ bias, float* out, int ldo,
                        float* ZONE, int nzone) {
  if (N <= 0) return;
  const int T = blockDim.x;
  if (kd <= 0) {                      // an empty sum: a block's empty share
    for (int r = 0; r < nrows; ++r)
      for (int c = threadIdx.x; c < N; c += T)
        out[r * ldo + c] = bias != nullptr ? bias[c] : 0.f;
    __syncthreads();
    return;
  }
  const int KS = max(1, min(min(kMaxSlices, T / N), nzone / (RB * N)));
  const int groups = (kd + 3) / 4;
  for (int r0 = 0; r0 < nrows; r0 += RB) {
    const int nr = min(RB, nrows - r0);
    const float* x = X + r0 * ldx;
    for (int item = threadIdx.x; item < N * KS; item += T) {
      const int c = item % N, q = item / N;
      const int g0 = (int)((long long)groups * q / KS);
      const int g1 = (int)((long long)groups * (q + 1) / KS);
      float acc[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[j] = 0.f;
      float w[kAhead + 1][4];
      auto load = [&](float (&v)[4], int g) {
        g = min(g, g1 - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = __ldg(W + (size_t)min(4 * g + i, kd - 1) * ldw + c);
      };
#pragma unroll
      for (int s = 0; s < kAhead; ++s) load(w[s], g0 + s);
      for (int g = g0; g < g1; ++g) {
        load(w[kAhead], g + kAhead);
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(x + j * ldx + 4 * g);
          acc[j] = fmaf(xv.x, w[0][0], acc[j]);
          acc[j] = fmaf(xv.y, w[0][1], acc[j]);
          acc[j] = fmaf(xv.z, w[0][2], acc[j]);
          acc[j] = fmaf(xv.w, w[0][3], acc[j]);
        }
#pragma unroll
        for (int s = 0; s < kAhead; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) w[s][i] = w[s + 1][i];
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (j >= nr) continue;
        if (KS == 1)
          out[(r0 + j) * ldo + c] = bias != nullptr ? acc[j] + bias[c]
                                                    : acc[j];
        else
          ZONE[(q * RB + j) * N + c] = acc[j];
      }
    }
    if (KS > 1) {
      __syncthreads();
      for (int j = 0; j < nr; ++j)
        for (int c = threadIdx.x; c < N; c += T) {
          float v = ZONE[j * N + c];
          for (int q = 1; q < KS; ++q) v += ZONE[(q * RB + j) * N + c];
          out[(r0 + j) * ldo + c] = bias != nullptr ? v + bias[c] : v;
        }
    }
    __syncthreads();
  }
}

// The alignment convolution over the window as a product with the band
// the filter makes: CONV[r, l] = sum_j WX[r, j] * taps[n + l - j] over
// j in [lb & ~3, round4(le)), l in [lb, le), the taps zero outside
// [0, 2n] and WX zero outside the window (the windowed weights).  A
// thread owns 4 adjacent frames of RB rows over a slice of j, so that
// each shared load of WX feeds 4 frames.  Ends with __syncthreads.
template <int RB>
__device__ void window_conv_band(const float* WX, int lde, const float* TAPS,
                                 int n_taps, int K, int L, int lb, int le,
                                 float* CONV, float* RED, int nred) {
  const int T = blockDim.x, n = (n_taps - 1) / 2;
  const int N = le - lb, j0 = lb & ~3;
  if (N <= 0) return;
  const int NQ = (N + 3) / 4;
  const int KS = max(1, min(min(kMaxSlices, T / NQ), nred / (RB * N)));
  const int groups = (round4(le) - j0) / 4;
  for (int r0 = 0; r0 < K; r0 += RB) {
    const int nr = min(RB, K - r0);
    const float* x = WX + r0 * lde;
    for (int item = threadIdx.x; item < NQ * KS; item += T) {
      const int cq = item % NQ, q = item / NQ, l0 = lb + 4 * cq;
      const int g0 = (int)((long long)groups * q / KS);
      const int g1 = (int)((long long)groups * (q + 1) / KS);
      float acc[RB][4];
#pragma unroll
      for (int j = 0; j < RB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int g = g0; g < g1; ++g) {
        const int jb = j0 + 4 * g;
        // taps[n + l0 + e - (jb + i)] for e - i in [-3, 3]
        float t[7];
#pragma unroll
        for (int d = 0; d < 7; ++d) {
          const int at = n + l0 - jb + d - 3;
          t[d] = (at >= 0 && at < n_taps) ? TAPS[at] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(x + j * lde + jb);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j][e] = fmaf(xs[i], t[e - i + 3], acc[j][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (j >= nr) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = l0 + e;
          if (l >= le) continue;
          if (KS == 1)
            CONV[(r0 + j) * L + l] = acc[j][e];
          else
            RED[(q * RB + j) * N + (l - lb)] = acc[j][e];
        }
      }
    }
    if (KS > 1) {
      __syncthreads();
      for (int j = 0; j < nr; ++j)
        for (int c = threadIdx.x; c < N; c += T) {
          float v = RED[j * N + c];
          for (int q = 1; q < KS; ++q) v += RED[(q * RB + j) * N + c];
          CONV[(r0 + j) * L + lb + c] = v;
        }
    }
    __syncthreads();
  }
}

// The block's partial energies: PE[r, l] = sum over its columns m in
// [m0, m1) of v[m] tanh((pre[l, m] + sp[r, m]) + conv[r, l] * handler[m]),
// for the window's frames.  A thread owns 2 rows x 2 frames over a slice
// of the columns (energy_tile.cuh, the tile of attention_energy.cu),
// reading the keys from global memory; the slices meet in RED (nred
// floats) in slice order.  Ends with __syncthreads.
__device__ void window_energies_partial(
    const float* __restrict__ pre, int M, const float* CONV, const float* SP,
    int ldsp, const float* HAND, const float* VV, int m0, int m1, int K,
    int L, int lb, int le, float* PE, float* RED, int nred) {
  const int T = blockDim.x, win = le - lb, cols = m1 - m0;
  if (win <= 0) return;
  const int RG = (K + 1) / 2, FG = (win + 1) / 2, tiles = RG * FG;
  const int S = tiles >= T ? 1 : max(1, min(min(min(kMaxSlices, T / tiles),
                                                cols), nred / (K * win)));
  for (int item = threadIdx.x; item < tiles * S; item += T) {
    const int tile = item % tiles, s = item / tiles;
    const int rg = tile % RG, fg = tile / RG;
    const int r[2] = {2 * rg, min(2 * rg + 1, K - 1)};
    const int f[2] = {2 * fg, min(2 * fg + 1, win - 1)};
    float c[2][2], acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        c[i][j] = CONV[r[i] * L + lb + f[j]];
        acc[i][j] = 0.f;
      }
    const int ms0 = m0 + (int)((long long)cols * s / S);
    const int ms1 = m0 + (int)((long long)cols * (s + 1) / S);
    const float* p[2] = {pre + (size_t)(lb + f[0]) * M,
                         pre + (size_t)(lb + f[1]) * M};
    const float* sr[2] = {SP + r[0] * ldsp - m0, SP + r[1] * ldsp - m0};
    energy_tile<2, 2, true>(p, sr, c, HAND, VV, ms0, ms1, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (2 * rg + i >= K || 2 * fg + j >= win) continue;
        if (S == 1)
          PE[r[i] * L + lb + f[j]] = acc[i][j];
        else
          RED[(s * K + r[i]) * win + f[j]] = acc[i][j];
      }
  }
  if (S > 1) {
    __syncthreads();
    for (int o = threadIdx.x; o < K * win; o += T) {
      const int rr = o / win, ff = o % win;
      float e = RED[rr * win + ff];
      for (int s = 1; s < S; ++s) e += RED[(s * K + rr) * win + ff];
      PE[rr * L + lb + ff] = e;
    }
  }
  __syncthreads();
}

template <int RB>
__global__ void __launch_bounds__(kThreads, 1)
decode_score_kernel(DecodeScoreArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const ScoreLayout o = score_layout(a);
  const int C = a.cluster, rank = (int)cluster.block_rank();
  const int u = blockIdx.x / C;
  const int K = a.K, L = a.L, M = a.M, D = a.D, S = a.S, R = a.R, V = a.V;
  const int tid = threadIdx.x, T = blockDim.x;
  float* W = sm + o.w;
  float* WX = sm + o.wx;
  float* WT = sm + o.wt;
  float* H = sm + o.h;
  float* MASK = sm + o.mask;
  float* TAPS = sm + o.taps;
  float* HAND = sm + o.hand;
  float* VV = sm + o.v;
  float* BEGINS = sm + o.begins;
  float* ENDS = sm + o.ends;
  float* CONV = sm + o.conv;
  float* SP = sm + o.sp;
  float* E = sm + o.e;
  float* PE = sm + o.pe;
  float* WA = sm + o.wa;
  float* MP = sm + o.mp;
  float* ACT = sm + o.act;
  float* COSTS = sm + o.costs;
  float* ZONE = sm + o.zone;
  const size_t row0 = (size_t)u * K;   // first hypothesis row
  const float* pre = a.pre + (size_t)u * L * M;
  const float* att = a.attended + (size_t)u * L * D;
  // the block's columns of M and D
  const int mc0 = share4(M, rank, C), mc1 = share4(M, rank + 1, C);
  const int dc0 = share4(D, rank, C), dc1 = share4(D, rank + 1, C);
  const int dcn = dc1 - dc0;

  // ---- load the rows and the small tables ----------------------------
  for (int i = tid; i < K * L; i += T)
    cp_async<4>(W + i, a.weights + row0 * L + i, 4);
  for (int r = 0; r < o.kp; ++r)
    for (int s = tid; s < o.ldh; s += T) {
      if (r < K && s < S)
        cp_async<4>(H + r * o.ldh + s, a.states + (row0 + r) * S + s, 4);
      else
        H[r * o.ldh + s] = 0.f;
    }
  for (int l = tid; l < L; l += T)
    cp_async<4>(MASK + l, a.att_mask + (size_t)u * L + l, 4);
  for (int j = tid; j < a.n_taps; j += T)
    cp_async<4>(TAPS + j, a.conv_taps + j, 4);
  for (int m = tid; m < M; m += T) {
    cp_async<4>(HAND + m, a.handler + m, 4);
    cp_async<4>(VV + m, a.v + m, 4);
  }
  cp_async_commit();
  // the convolution reads whole row blocks of WX: zero the rows past K
  for (int r = K; r < o.kp; ++r)
    for (int l = tid; l < o.lde; l += T) WX[r * o.lde + l] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // ---- window prior ---------------------------------------------------
  int lb, le;
  if (a.prior_median || a.prior_mean) {
    if (a.prior_mean)
      mean_bounds(W, K, L, a.before, a.after, BEGINS, ENDS);
    else
      median_bounds(W, K, L, a.before, a.after, false, BEGINS, ENDS);
    union_window(BEGINS, ENDS, K, L, lb, le);
  } else {
    expanding_window(a.step[row0], L, a.initial_begin, a.initial_end,
                     a.min_speed, a.max_speed, lb, le);
  }
  for (int r = 0; r < K; ++r)
    for (int l = tid; l < o.lde; l += T)
      WX[r * o.lde + l] = (l >= lb && l < le) ? W[r * L + l] : 0.f;
  __syncthreads();

  // ---- convolution over the window -----------------------------------
  window_conv_band<RB>(WX, o.lde, TAPS, a.n_taps, K, L, lb, le, CONV, ZONE,
                       o.nzone);

  // ---- state projection of the block's M columns ---------------------
  product<RB>(H, o.ldh, K, S, a.state_trans + mc0, M, mc1 - mc0, nullptr,
              SP, o.ldsp, ZONE, o.nzone);

  // ---- partial energies of the block's columns ------------------------
  window_energies_partial(pre, M, CONV, SP, o.ldsp, HAND, VV, mc0, mc1, K,
                          L, lb, le, PE, ZONE, o.nzone);

  // ---- exchange 1: the cluster's partial energies, in rank order ------
  // (on one block PE is E)
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
    for (int r = 0; r < K; ++r)
      for (int l = lb + tid; l < le; l += T) {
        float e = cluster.map_shared_rank(PE, 0)[r * L + l];
        for (int q = 1; q < C; ++q)
          e += cluster.map_shared_rank(PE, q)[r * L + l];
        E[r * L + l] = e;
      }
    __syncthreads();
  }
  {
    const int i0 = (int)((long long)K * L * rank / C);
    const int i1 = (int)((long long)K * L * (rank + 1) / C);
    for (int i = i0 + tid; i < i1; i += T) {
      const int l = i % L;
      a.energies[row0 * L + i] = (l >= lb && l < le) ? E[i] : 0.f;
    }
  }
  __syncthreads();

  // ---- masked softmax ------------------------------------------------
  window_softmax(E, MASK, BEGINS, ENDS, a.prior_median || a.prior_mean, K,
                 L, lb, le);
  __syncthreads();
  {
    const int i0 = (int)((long long)K * L * rank / C);
    const int i1 = (int)((long long)K * L * (rank + 1) / C);
    for (int i = i0 + tid; i < i1; i += T) a.wnew[row0 * L + i] = E[i];
  }
  // the late region (the early one is dead): the new weights as X, and
  // the zero padding of the products' X buffers
  for (int r = 0; r < o.kp; ++r) {
    for (int l = tid; l < o.lde; l += T)
      WT[r * o.lde + l] = r < K && l < L ? E[r * L + l] : 0.f;
    for (int c = (r < K ? dcn : 0) + tid; c < o.ldwa; c += T)
      WA[r * o.ldwa + c] = 0.f;
    for (int c = (r < K ? R : 0) + tid; c < o.ldact; c += T)
      ACT[r * o.ldact + c] = 0.f;
  }
  __syncthreads();

  // ---- weighted average of the block's columns -------------------------
  const int j0 = lb & ~3;
  product<RB>(WT + j0, o.lde, K, le - j0, att + (size_t)j0 * D + dc0, D,
              dcn, nullptr, WA, o.ldwa, ZONE, o.nzone);
  for (int r = 0; r < K; ++r)
    for (int c = tid; c < dcn; c += T)
      a.wa[(row0 + r) * D + dc0 + c] = WA[r * o.ldwa + c];

  // ---- readout: the merge layer's partial sum over the block's D -------
  product<RB>(WA, o.ldwa, K, dcn, a.merge_k + (size_t)dc0 * R, R, R,
              nullptr, MP, R, ZONE, o.nzone);

  // ---- exchange 2: rank 0 adds the partials ---------------------------
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
  if (rank == 0) {
    for (int r = 0; r < K; ++r)
      for (int c = tid; c < R; c += T) {
        float s = MP[r * R + c];
        for (int q = 1; q < C; ++q)
          s += cluster.map_shared_rank(MP, q)[r * R + c];
        ACT[r * o.ldact + c] = tanhf(s + a.merge_b[c]);
      }
  }
  // the peers may leave once rank 0 has read their partials
  if (C > 1) cluster_arrive();

  // ---- the post-merge layer and the costs (rank 0) --------------------
  if (rank == 0) {
    __syncthreads();
    product<RB>(ACT, o.ldact, K, R, a.post_k, V, V, a.post_b, COSTS, V,
                ZONE, o.nzone);
    log_softmax_costs(COSTS, K, V, nullptr);
    __syncthreads();
    for (int i = tid; i < K * V; i += T) a.costs[row0 * V + i] = COSTS[i];
  }
  if (C > 1) cluster_wait();
}

SmemAllowance g_allowed[4];          // each instance's, by rows_block

// A launch over U utterances on clusters of a.cluster blocks
// (cudaLaunchKernelEx, cudaOccupancyMaxActiveClusters); *attr holds the
// cluster's shape and must outlive the configuration.
inline cudaLaunchConfig_t score_config(const DecodeScoreArgs& a, int U,
                                       int smem, cudaStream_t stream,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(U * a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The launch (U utterances; `count` null), or how many clusters the
// current device holds at once into *count.
template <int RB>
int run(const DecodeScoreArgs& a, int slot, cudaStream_t stream,
        int* count) {
  const int smem = score_layout(a).total * (int)sizeof(float);
  const cudaError_t err =
      allow_dynamic_smem(decode_score_kernel<RB>, g_allowed[slot], smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      score_config(a, count ? 1 : a.U, smem, stream, &attr);
  if (count)
    return (int)cudaOccupancyMaxActiveClusters(count, decode_score_kernel<RB>,
                                               &cfg);
  return (int)cudaLaunchKernelEx(&cfg, decode_score_kernel<RB>, a);
}

int dispatch(const DecodeScoreArgs& a, cudaStream_t stream, int* count) {
  if (a.cluster != 1 && a.cluster != 2 && a.cluster != 4 && a.cluster != 8)
    return (int)cudaErrorInvalidValue;
  switch (rows_block(a.K)) {
    case 4: return run<4>(a, 0, stream, count);
    case 8: return run<8>(a, 1, stream, count);
    case 10: return run<10>(a, 2, stream, count);
    default: return run<16>(a, 3, stream, count);
  }
}

}  // namespace

extern "C" int decode_score_smem_bytes(const DecodeScoreArgs* args) {
  return score_layout(*args).total * (int)sizeof(float);
}

// How many clusters of args->cluster blocks at the shape of *args the
// current device holds at once, into *count; a CUDA error code
// (cudaErrorInvalidValue for a cluster size other than 1, 2, 4 or 8).
extern "C" int decode_score_max_clusters(const DecodeScoreArgs* args,
                                         int* count) {
  return dispatch(*args, nullptr, count);
}

// The launch; a CUDA error code (cudaErrorInvalidValue for a cluster size
// other than 1, 2, 4 or 8).
extern "C" int decode_score_f32(const DecodeScoreArgs* args, void* stream) {
  return dispatch(*args, (cudaStream_t)stream, nullptr);
}
