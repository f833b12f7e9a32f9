// Teacher-forced attention-decoder scan of the training path: the whole
// label-time loop in one forward launch and one reverse-time backward launch.
//
// Replaces attention_lvcsr_tpu/ops/pallas/decoder_train.py::
// decoder_scan_train (:839; forward _fwd_kernel :225, backward _bwd_kernel
// :339, custom VJP :601-836) for the flagship variant: one conv filter, the
// softmax normalizer, the expanding or window_around_median prior, one GRU
// layer.  Per step t and batch row b (forward):
//
//   window  [gb, ge) from the prior (median: each row's running-sum median
//           of w, bounds taken over the whole batch); combined =
//           gmask * (begin_b < l < end_b) * att_mask
//   conv    = (w * gmask) @ toep;  sp = h @ st
//   e[l]    = sum_m v[m] tanh(pre[b,l,m] + sp[m] + conv[l] * hand[m])
//   wnew    = softmax of e over the window, times combined, normalised
//   wa_new  = wnew @ att[b]
//   GRU     [u, r] = sigmoid(h @ wsg + fg[t] + wa_new @ dgm)
//           c = tanh((h * r) @ wss + fx[t] + wa_new @ dxm)
//           h_new = u * c + (1 - u) * h
//   h, w, wa, e*gmask are replaced where mask[t, b] > 0.5 (by selection)
//
// The backward walks the steps in reverse with dh, dw, dwa on chip, exactly
// the TPU kernel's algebra (decoder_train.py:423-585): GRU backward,
// weighted-average backward, then the attention step recomputed from
// (h_prev, w_prev) -- the (B, L, M) match tensor is never stored -- and the
// softmax, energy and convolution backward.  It accumulates dpre and datt
// of its own row in device memory and its row's dhand, dv across its steps,
// and writes per-step rows (dfx, dfg, dsp, the windowed weights and dconv)
// from which ops/decoder_train.py forms the weight gradients (dtoep, dst,
// dwss, dwsg, ddx, ddg) with outer_sum.cu, which also sums the rows' dhand
// and dv in a fixed order.  Its products with the transposed weights
// read transposed copies that the wrapper makes once per call, so that
// they are column-sliced and coalesced like the forward's.
//
// What bounds it on the card: the per-step dependent chain.  A step is a
// handful of dependent vector-matrix products (about 0.7 M multiply-adds a
// row forward, 1.1 M backward, the weights read from L2), 50 K tanh and a
// few block-wide reductions.  Design: one block per batch row, the row's
// vectors in shared memory, weights streamed from L2 with coalesced loads;
// products split their reduction over the block's threads.  The window of
// the median prior spans the batch, so every forward step needs every
// row's bounds: blocks publish them and meet at a grid-wide barrier, which
// is why the forward is a cooperative launch (all B blocks co-resident;
// B <= 132 rows at the flagship widths).  The forward records each step's
// [gb, ge) and the backward reads it, so the backward needs no barrier and
// is the exact gradient of the forward.
#include <cuda_runtime.h>

// Must match the ctypes.Structure in ops/decoder_train.py field for field.
struct DecoderArgs {
  const float* fx;     // (T, B, S) fork projections: inputs
  const float* fg;     // (T, B, 2S) fork projections: gates
  const float* mask;   // (T, B)
  const int* step0;    // (T,) expanding prior's step counter
  const float* pre;    // (B, L, M) preprocessed keys
  const float* att;    // (B, L, D) attended
  const float* amask;  // (B, L)
  const float* h0;     // (B, S)
  const float* w0;     // (B, L)
  const float* wa0;    // (B, D)
  const float* toep;   // (L, L) Toeplitz band of the conv taps
  const float* st;     // (S, M)
  const float* hand;   // (M)
  const float* v;      // (M)
  const float* wss;    // (S, S)
  const float* wsg;    // (S, 2S)
  const float* dxm;    // (D, S)
  const float* dgm;    // (D, 2S)
  float* h_out;        // (T, B, S) mask-mixed states
  float* w_out;        // (T, B, L) mask-mixed weights
  float* wa_out;       // (T, B, D) mask-mixed weighted averages
  float* e_out;        // (T, B, L) mask-mixed windowed energies
  float* u_out;        // (T, B, S) residuals: update, reset, candidate
  float* r_out;
  float* c_out;
  float* bounds;       // (T, 2) window [gb, ge) of each step
  float* exch;         // (2, 2B) each row's window bounds, by step parity
  unsigned* barrier;   // (2,) arrivals, generation; zeroed
  const float* dh;     // (T, B, S) cotangents of h, w, wa
  const float* dw;     // (T, B, L)
  const float* dwa;    // (T, B, D)
  float* dfx;          // (T, B, S)
  float* dfg;          // (T, B, 2S)
  float* dh0;          // (B, S)
  float* dwa0;         // (B, D)
  float* dpre;         // (B, L, M) zeroed, accumulated
  float* datt;         // (B, L, D) zeroed, accumulated
  float* dsp;          // (T, B, M) gradient of each step's h @ st
  float* wg;           // (T, B, L) windowed previous weights
  float* dconv;        // (T, B, L) gradient of each step's convolution
  float* dhand;        // (B, M) each row's sum over its steps
  float* dv;           // (B, M)
  const float* wss_t;  // transposes of wss, wsg, dxm, dgm, st and toep,
  const float* wsg_t;  //   which the backward's products read column by
  const float* dxm_t;  //   column, as the forward reads the matrices
  const float* dgm_t;
  const float* st_t;
  const float* toep_t;
  int T, B, L, M, D, S, prior_median;
  float before, after, initial_begin, initial_end, min_speed, max_speed;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

enum Reduce { kSum, kMax, kMin };

__device__ __forceinline__ float combine(float x, float y, Reduce op) {
  return op == kSum ? x + y : op == kMax ? fmaxf(x, y) : fminf(x, y);
}

// Block-wide reduction of one value per thread; every thread gets the
// result.  red: kWarps floats of shared memory.
__device__ float block_reduce(float x, float* red, Reduce op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = combine(x, __shfl_xor_sync(0xffffffffu, x, o), op);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = combine(r, red[w], op);
  return r;
}

// out[n] (+)= sum_k x[k] * W[k * ldw + n] for n < N, x in shared memory,
// W row-major in device memory (coalesced over n).  The k range is split
// over the threads the N columns leave free; scratch holds the partials.
__device__ void vecmat(const float* x, const float* __restrict__ W, int ldw,
                       int K, int N, float* out, float* scratch,
                       bool accumulate) {
  const int slices = max(1, min(K, kThreads / N));
  for (int item = threadIdx.x; item < slices * N; item += kThreads) {
    const int q = item / N, n = item % N;
    const int k1 = (q + 1) * K / slices;
    float acc = 0.f;
#pragma unroll 8
    for (int k = q * K / slices; k < k1; ++k)
      acc = fmaf(x[k], __ldg(W + (size_t)k * ldw + n), acc);
    scratch[item] = acc;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = scratch[n];
    for (int q = 1; q < slices; ++q) s += scratch[q * N + n];
    out[n] = accumulate ? out[n] + s : s;
  }
  __syncthreads();
}

// All blocks of the cooperative grid meet here.  bar[0] counts arrivals,
// bar[1] is the generation the waiting blocks watch.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

// Shared-memory layout of one block (offsets in floats, 16-byte aligned).
struct Layout {
  int h, w, wa, ek, sp, conv, e, wnew, wan, gm, comb, wgv, gates, xin, rh,
      cand, hp, dhn, dwn, dwan, dca, dga, dhp, dsp, dcv, tmp, red, scratch,
      part, total;
};

__host__ __device__ inline int take(int& at, int n) {
  const int p = at;
  at += (n + 3) / 4 * 4;
  return p;
}

__host__ __device__ inline Layout layout(int L, int M, int D, int S) {
  Layout o;
  int at = 0;
  const int wide = max(max(2 * S, D), max(L, M));
  // per-row vectors of the forward ...
  o.h = take(at, S);       o.w = take(at, L);      o.wa = take(at, D);
  o.ek = take(at, L);      o.sp = take(at, M);     o.conv = take(at, L);
  o.e = take(at, L);       o.wnew = take(at, L);   o.wan = take(at, D);
  o.gm = take(at, L);      o.comb = take(at, L);   o.wgv = take(at, L);
  o.gates = take(at, 2 * S);  o.xin = take(at, S);  o.rh = take(at, S);
  o.cand = take(at, S);
  // ... and of the backward
  o.hp = take(at, S);      o.dhn = take(at, S);    o.dwn = take(at, L);
  o.dwan = take(at, D);    o.dca = take(at, S);    o.dga = take(at, 2 * S);
  o.dhp = take(at, S);     o.dsp = take(at, M);    o.dcv = take(at, L);
  o.tmp = take(at, wide);  o.red = take(at, kWarps);
  o.scratch = take(at, max(kThreads, wide));
  o.part = take(at, 3 * kWarps * M);   // per-warp dsp, dv, dhand partials
  o.total = at;
  return o;
}

// The window of forward step t: fills gm and comb of this row and returns
// [gb, ge).  Every block calls it (the median prior meets at the barrier).
__device__ float2 window(const DecoderArgs& a, int t, int b, const float* w,
                         float* gm, float* comb, float* red) {
  const int L = a.L;
  float begin_b = 0.f, end_b = 0.f, gb, ge;
  if (!a.prior_median) {
    const float s = (float)a.step0[t];
    gb = floorf(fmaxf(0.f, fminf((float)(L - 1),
                                 a.initial_begin + s * a.min_speed)));
    ge = ceilf(fmaxf(0.f, fminf((float)L, a.initial_end + s * a.max_speed)));
  } else {
    // warp 0: running sum of w over contiguous chunks per lane, and the
    // number of frames whose running sum stays under 0.5
    __shared__ float below;
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x, per = (L + 31) / 32;
      const int l0 = min(L, lane * per), l1 = min(L, l0 + per);
      float s = 0.f;
      for (int l = l0; l < l1; ++l) s += w[l];
      float incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      float run = incl - s, count = 0.f;
      for (int l = l0; l < l1; ++l) {
        run += w[l];
        count += run < 0.5f ? 1.f : 0.f;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        count += __shfl_xor_sync(0xffffffffu, count, o);
      if (lane == 0) below = count;
    }
    __syncthreads();
    const float expected = fmaxf(0.f, below - 1.f);
    begin_b = floorf(expected - a.before);
    end_b = ceilf(expected + a.after);
    float* slot = a.exch + (t & 1) * 2 * a.B;
    if (threadIdx.x == 0) {
      slot[2 * b] = begin_b;
      slot[2 * b + 1] = end_b;
    }
    grid_barrier(a.barrier);
    float lo = 3.4e38f, hi = -3.4e38f;
    for (int i = threadIdx.x; i < a.B; i += kThreads) {
      lo = fminf(lo, __ldcg(slot + 2 * i));
      hi = fmaxf(hi, __ldcg(slot + 2 * i + 1));
    }
    lo = block_reduce(lo, red, kMin);
    hi = block_reduce(hi, red, kMax);
    gb = floorf(fmaxf(0.f, lo));
    ge = ceilf(fminf((float)L, hi));
  }
  const float* amask = a.amask + (size_t)b * L;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    const float pos = (float)l;
    const float g = pos >= gb && pos < ge ? 1.f : 0.f;
    const float add =
        !a.prior_median || (pos > begin_b && pos < end_b) ? 1.f : 0.f;
    gm[l] = g;
    comb[l] = g * add * amask[l];
  }
  __syncthreads();
  return make_float2(gb, ge);
}

__global__ void __launch_bounds__(kThreads) decoder_fwd_kernel(DecoderArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int B = a.B, L = a.L, M = a.M, D = a.D, S = a.S, S2 = 2 * a.S;
  const Layout o = layout(L, M, D, S);
  float *h = sm + o.h, *w = sm + o.w, *wa = sm + o.wa, *ek = sm + o.ek;
  float *sp = sm + o.sp, *conv = sm + o.conv, *e = sm + o.e;
  float *wnew = sm + o.wnew, *wan = sm + o.wan, *gm = sm + o.gm;
  float *comb = sm + o.comb, *wgv = sm + o.wgv, *gates = sm + o.gates;
  float *xin = sm + o.xin, *rh = sm + o.rh, *cand = sm + o.cand;
  float *tmp = sm + o.tmp, *red = sm + o.red, *scratch = sm + o.scratch;
  const float* pre = a.pre + (size_t)b * L * M;
  const float* att = a.att + (size_t)b * L * D;
  for (int i = tid; i < S; i += kThreads) h[i] = a.h0[(size_t)b * S + i];
  for (int l = tid; l < L; l += kThreads) {
    w[l] = a.w0[(size_t)b * L + l];
    ek[l] = 0.f;
  }
  for (int d = tid; d < D; d += kThreads) wa[d] = a.wa0[(size_t)b * D + d];
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t row = (size_t)t * B + b;
    // ---- window of the prior
    const float2 win = window(a, t, b, w, gm, comb, red);
    if (b == 0 && tid == 0) {
      a.bounds[2 * t] = win.x;
      a.bounds[2 * t + 1] = win.y;
    }
    for (int l = tid; l < L; l += kThreads) wgv[l] = w[l] * gm[l];
    __syncthreads();
    // ---- convolution of the windowed weights; the state's keys
    vecmat(wgv, a.toep, L, L, L, conv, scratch, false);
    vecmat(h, a.st, M, S, M, sp, scratch, false);
    // ---- energies: one warp per frame, lanes over the match dimension
    for (int l = warp; l < L; l += kWarps) {
      const float* pl = pre + (size_t)l * M;
      const float cl = conv[l];
      float acc = 0.f;
      for (int m = lane; m < M; m += 32)
        acc = fmaf(__ldg(a.v + m),
                   tanhf(__ldg(pl + m) + sp[m] + cl * __ldg(a.hand + m)), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) e[l] = acc;
    }
    __syncthreads();
    // ---- softmax over the window
    float mx = kNeg;
    for (int l = tid; l < L; l += kThreads)
      if (gm[l] > 0.f) mx = fmaxf(mx, e[l]);
    mx = block_reduce(mx, red, kMax);
    mx = mx > kNeg / 2 ? mx : 0.f;
    float sum = 0.f, csum = 0.f;
    for (int l = tid; l < L; l += kThreads) {
      const float un = expf(e[l] - mx) * comb[l];
      wnew[l] = un;
      sum += un;
      csum += comb[l];
    }
    sum = block_reduce(sum, red, kSum);
    csum = block_reduce(csum, red, kSum);
    const float denom = sum + (csum == 0.f ? 1.f : 0.f);
    for (int l = tid; l < L; l += kThreads) wnew[l] = wnew[l] / denom;
    __syncthreads();
    // ---- weighted average
    vecmat(wnew, att, D, L, D, wan, scratch, false);
    // ---- GRU: gates, then candidate
    vecmat(wan, a.dgm, S2, D, S2, gates, scratch, false);
    for (int i = tid; i < S2; i += kThreads)
      gates[i] = a.fg[row * S2 + i] + gates[i];
    __syncthreads();
    vecmat(h, a.wsg, S2, S, S2, tmp, scratch, false);
    for (int i = tid; i < S2; i += kThreads)
      gates[i] = sigmoidf(tmp[i] + gates[i]);
    __syncthreads();
    vecmat(wan, a.dxm, S, D, S, xin, scratch, false);
    for (int i = tid; i < S; i += kThreads) {
      xin[i] = a.fx[row * S + i] + xin[i];
      rh[i] = h[i] * gates[S + i];
    }
    __syncthreads();
    vecmat(rh, a.wss, S, S, S, tmp, scratch, false);
    for (int i = tid; i < S; i += kThreads) cand[i] = tanhf(tmp[i] + xin[i]);
    __syncthreads();
    // ---- outputs, mask-mixed by selection
    const bool live = a.mask[row] > 0.5f;
    for (int i = tid; i < S; i += kThreads) {
      const float u = gates[i];
      const float hn = u * cand[i] + (1.f - u) * h[i];
      if (live) h[i] = hn;
      a.h_out[row * S + i] = h[i];
      a.u_out[row * S + i] = u;
      a.r_out[row * S + i] = gates[S + i];
      a.c_out[row * S + i] = cand[i];
    }
    for (int l = tid; l < L; l += kThreads) {
      if (live) {
        w[l] = wnew[l];
        ek[l] = e[l] * gm[l];
      }
      a.w_out[row * L + l] = w[l];
      a.e_out[row * L + l] = ek[l];
    }
    for (int d = tid; d < D; d += kThreads) {
      if (live) wa[d] = wan[d];
      a.wa_out[row * D + d] = wa[d];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) decoder_bwd_kernel(DecoderArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int B = a.B, L = a.L, M = a.M, D = a.D, S = a.S, S2 = 2 * a.S;
  const Layout o = layout(L, M, D, S);
  // carried gradients (dh, dw, dwa) live in h, w, wa
  float *dh = sm + o.h, *dw = sm + o.w, *dwa = sm + o.wa;
  float *sp = sm + o.sp, *conv = sm + o.conv, *dE = sm + o.e;
  float *wnew = sm + o.wnew, *wan = sm + o.wan, *gm = sm + o.gm;
  float *wgv = sm + o.wgv, *hp = sm + o.hp, *dhn = sm + o.dhn;
  float *dwn = sm + o.dwn, *dwan = sm + o.dwan, *dca = sm + o.dca;
  float *dga = sm + o.dga, *dhp = sm + o.dhp, *dsp = sm + o.dsp;
  float *dcv = sm + o.dcv, *tmp = sm + o.tmp, *red = sm + o.red;
  float *scratch = sm + o.scratch, *wsp = sm + o.part;
  float *wdv = wsp + kWarps * M, *whd = wdv + kWarps * M;
  const float* pre = a.pre + (size_t)b * L * M;
  const float* att = a.att + (size_t)b * L * D;
  float* dpre = a.dpre + (size_t)b * L * M;
  float* datt = a.datt + (size_t)b * L * D;
  for (int i = tid; i < S; i += kThreads) dh[i] = 0.f;
  for (int l = tid; l < L; l += kThreads) dw[l] = 0.f;
  for (int d = tid; d < D; d += kThreads) dwa[d] = 0.f;
  for (int i = tid; i < 2 * kWarps * M; i += kThreads) wdv[i] = 0.f;
  __syncthreads();

  for (int t = a.T - 1; t >= 0; --t) {
    const size_t row = (size_t)t * B + b, prev = row - B;
    const float m = a.mask[row];
    // ---- step inputs: previous state and weights, cotangents split by mask
    for (int i = tid; i < S; i += kThreads) {
      hp[i] = t > 0 ? a.h_out[prev * S + i] : a.h0[(size_t)b * S + i];
      const float g = dh[i] + a.dh[row * S + i];
      dhn[i] = g * m;
      dh[i] = g * (1.f - m);
    }
    for (int l = tid; l < L; l += kThreads) {
      const float wp = t > 0 ? a.w_out[prev * L + l] : a.w0[(size_t)b * L + l];
      wgv[l] = wp;
      wnew[l] = a.w_out[row * L + l];
      const float g = dw[l] + a.dw[row * L + l];
      dwn[l] = g * m;
      dw[l] = g * (1.f - m);
    }
    for (int d = tid; d < D; d += kThreads) {
      wan[d] = a.wa_out[row * D + d];
      const float g = dwa[d] + a.dwa[row * D + d];
      dwan[d] = g * m;
      dwa[d] = g * (1.f - m);
    }
    __syncthreads();
    // ---- GRU backward
    for (int i = tid; i < S; i += kThreads) {
      const float u = a.u_out[row * S + i], c = a.c_out[row * S + i];
      const float du = dhn[i] * (c - hp[i]);
      const float dcand = dhn[i] * u;
      dhp[i] = dhn[i] * (1.f - u);
      dca[i] = dcand * (1.f - c * c);
      a.dfx[row * S + i] = dca[i];
      dga[i] = du * u * (1.f - u);
    }
    __syncthreads();
    vecmat(dca, a.wss_t, S, S, S, tmp, scratch, false);   // dca @ wss^T
    for (int i = tid; i < S; i += kThreads) {
      const float r = a.r_out[row * S + i];
      dhp[i] = dhp[i] + tmp[i] * r;
      dga[S + i] = tmp[i] * hp[i] * r * (1.f - r);
    }
    __syncthreads();
    for (int i = tid; i < S2; i += kThreads) a.dfg[row * S2 + i] = dga[i];
    vecmat(dga, a.wsg_t, S, S2, S, dhp, scratch, true);   // += dga @ wsg^T
    vecmat(dca, a.dxm_t, D, S, D, tmp, scratch, false);
    vecmat(dga, a.dgm_t, D, S2, D, tmp, scratch, true);
    for (int d = tid; d < D; d += kThreads) dwan[d] = dwan[d] + tmp[d];
    __syncthreads();
    // ---- weighted-average backward: one warp per frame, lanes over D
    for (int l = warp; l < L; l += kWarps) {
      const float* al = att + (size_t)l * D;
      float* dal = datt + (size_t)l * D;
      const float wl = wnew[l];
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float g = dwan[d];
        acc = fmaf(__ldg(al + d), g, acc);
        dal[d] += wl * g;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dwn[l] = dwn[l] + acc;
    }
    __syncthreads();
    // ---- the attention step recomputed from (h_prev, w_prev)
    const float gb = a.bounds[2 * t], ge = a.bounds[2 * t + 1];
    for (int l = tid; l < L; l += kThreads) {
      const float pos = (float)l;
      gm[l] = pos >= gb && pos < ge ? 1.f : 0.f;
      wgv[l] = wgv[l] * gm[l];
      a.wg[row * L + l] = wgv[l];
    }
    __syncthreads();
    vecmat(hp, a.st, M, S, M, sp, scratch, false);
    vecmat(wgv, a.toep, L, L, L, conv, scratch, false);
    // ---- softmax backward (the max shift cancels)
    float srow = 0.f;
    for (int l = tid; l < L; l += kThreads) srow += dwn[l] * wnew[l];
    srow = block_reduce(srow, red, kSum);
    for (int l = tid; l < L; l += kThreads) dE[l] = wnew[l] * (dwn[l] - srow);
    for (int i = tid; i < kWarps * M; i += kThreads) wsp[i] = 0.f;
    __syncthreads();
    // ---- energies backward over the recomputed match tensor
    for (int l = warp; l < L; l += kWarps) {
      const float* pl = pre + (size_t)l * M;
      float* dpl = dpre + (size_t)l * M;
      const float el = dE[l], cl = conv[l];
      float dc = 0.f;
      for (int mm = lane; mm < M; mm += 32) {
        const float hand = __ldg(a.hand + mm);
        const float mt = tanhf(__ldg(pl + mm) + sp[mm] + cl * hand);
        const float dmt = el * __ldg(a.v + mm) * (1.f - mt * mt);
        dpl[mm] += dmt;
        wsp[warp * M + mm] += dmt;
        wdv[warp * M + mm] += mt * el;
        whd[warp * M + mm] += dmt * cl;
        dc += dmt * hand;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dc += __shfl_xor_sync(0xffffffffu, dc, off);
      if (lane == 0) dcv[l] = dc;
    }
    __syncthreads();
    for (int mm = tid; mm < M; mm += kThreads) {
      float s = wsp[mm];
      for (int q = 1; q < kWarps; ++q) s += wsp[q * M + mm];
      dsp[mm] = s;
      a.dsp[row * M + mm] = s;
    }
    for (int l = tid; l < L; l += kThreads) a.dconv[row * L + l] = dcv[l];
    __syncthreads();
    // ---- state and convolution backward; carry to the step before
    vecmat(dsp, a.st_t, S, M, S, dhp, scratch, true);     // += dsp @ st^T
    vecmat(dcv, a.toep_t, L, L, L, tmp, scratch, false);  // dconv @ toep^T
    for (int l = tid; l < L; l += kThreads) dw[l] = tmp[l] * gm[l] + dw[l];
    for (int i = tid; i < S; i += kThreads) dh[i] = dhp[i] + dh[i];
    __syncthreads();
  }
  for (int i = tid; i < S; i += kThreads) a.dh0[(size_t)b * S + i] = dh[i];
  for (int d = tid; d < D; d += kThreads) a.dwa0[(size_t)b * D + d] = dwa[d];
  for (int mm = tid; mm < M; mm += kThreads) {
    float sv = 0.f, sh = 0.f;
    for (int q = 0; q < kWarps; ++q) {
      sv += wdv[q * M + mm];
      sh += whd[q * M + mm];
    }
    a.dv[(size_t)b * M + mm] = sv;
    a.dhand[(size_t)b * M + mm] = sh;
  }
}

// -1 when the launch is not covered (shared memory or co-residency), else
// a CUDA error code (0: launched).
int prepare(const void* kernel, const DecoderArgs* args, size_t* smem,
            bool cooperative) {
  const Layout o = layout(args->L, args->M, args->D, args->S);
  *smem = (size_t)o.total * sizeof(float);
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (*smem > (size_t)max_smem) return -1;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  if (err != cudaSuccess) return (int)err;
  if (cooperative) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, *smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms < args->B) return -1;
  }
  return 0;
}

}  // namespace

extern "C" int decoder_train_fwd_f32(const DecoderArgs* args, void* stream) {
  size_t smem = 0;
  const int ready = prepare((const void*)decoder_fwd_kernel, args, &smem,
                            true);
  if (ready != 0) return ready;
  DecoderArgs copy = *args;
  void* params[] = {&copy};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)decoder_fwd_kernel, dim3(args->B), dim3(kThreads), params,
      smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int decoder_train_bwd_f32(const DecoderArgs* args, void* stream) {
  size_t smem = 0;
  const int ready = prepare((const void*)decoder_bwd_kernel, args, &smem,
                            false);
  if (ready != 0) return ready;
  decoder_bwd_kernel<<<args->B, kThreads, smem, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
