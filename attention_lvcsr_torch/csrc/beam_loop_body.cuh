// The whole beam-search decode loop as one persistent launch: the kernel
// body, its argument struct and its layout, shared by the resident
// instances (beam_loop.cu) and the workspace instances (beam_loop_ws.cu).
//
// Replaces attention_lvcsr_tpu/ops/pallas/beam_loop.py::beam_search_loop
// for conv attention with 1-16 filters (n_filters; each filter's
// convolution, and the handler term summed over the filters in their
// order, :303-321), or content-only attention (content_attention=True
// there, content here: no convolution and no handler term, the caller's
// expanding window over every frame), the expanding, window_around_median
// or window_around_mean prior, the softmax, logistic or relu normalizer
// (the last two with the energy bias; under relu a row whose weights are
// all zero over a live window gets zero weights and its candidates lose
// the selection), one to four GRU decoder layers (dec_stack; :481-511:
// layer l > 0 adds below @ inter_* of layer l-1's new state), one
// post-merge layer after the
// tanh, relu, sigmoid, identity or maxout activation (post_act, maxout;
// :386-408), the log-likelihood criterion or the task loss's (mse_cost:
// costs = -logits; one filter), optional states-for-readout, patience or
// optimistic_future_cost stopping, char_discount, round_to_inf and
// ignore_first_eol.  Per step and utterance it runs what the Pallas body
// runs: window prior, alignment convolution, state projection, energies,
// masked normalization, weighted average, merge + activation + post-merge,
// costs,
// K rounds of candidate selection (lowest flat index wins ties), gathers
// by source row, GRU advance, EOS retirement, the done-set merge (old
// entries win ties) and the stopping bookkeeping.  Every product is
// computed here with fmaf dot products; none goes to a library.  The
// attention and readout phases are the device functions of
// decode_step.cuh, which the one-step score kernel (decode_score.cu) runs
// too.  The normalizer, the cost mode and the WSJ recipes' variants
// (filters, the mean prior, activations besides tanh) are template
// parameters: each combination a config uses is its own instance, so the
// routes of earlier slices compile none of the variants' code.  Inside the
// variant instance the prior and the activation, run once a step over
// K x L and K x R values, switch at run time.  A stacked decoder takes its
// own instance (kStack) of the variant's: the layers advance one after
// another through the per-layer scratch, the states of all layers (K x N*S)
// the only buffer that grows, and the fork products read the feedback
// rows from global memory instead of staging them, which keeps two
// 512-wide layers in a block's shared memory.
//
// What bounds it on the card: latency.  A step is a chain of about a
// dozen dependent phases separated by block barriers, each a small
// product over K = 10 rows; per step a block also streams about 4 MB of
// weight tables (merge, fork, distribute, GRU matrices; L2-resident) and
// its utterance's pre-projected keys and encoder outputs (0.6 MB at the
// flagship shape).  The grid is one block per utterance, so B = 64 fills
// 64 of 132 SMs.
//
// What the design does about it: the whole decode is one launch, so no
// per-step launch or host round trip exists (the plain PyTorch version
// pays dozens of launches per step).  In the resident instances
// (beam_loop.cu) all per-utterance state — states h (K x S), alignment
// weights (K x L), hypothesis buffers (K x Lout), the done set — lives in
// shared memory for the whole decode.  Where that passes a block's 227 KB
// (beams above 17 at the flagship widths, long inputs, D-wide glimpses),
// the workspace instances (beam_loop_ws.cu, kWorkspace) keep the K-row
// buffers in the utterance's rows of a global workspace, from L1 and L2,
// and the per-row scalars, the mask, taps, handler and energy vector in
// shared memory; the done-set merge then ranks its 2K entries in parallel
// (rank_merge) instead of K warp rounds.  One body serves both: only the
// base of the K-row buffers' pointers differs.  The eleven
// products of a step run through beam_products.cuh: a thread keeps a
// column pair of one row group in registers, so all 512 threads have work
// at every width, each element the same k-ordered fmaf sum as a plain dot
// product; weights are read from L2 once per step per block.  Energies
// are computed only inside the prior's window (outside it the softmax
// weight is exactly zero), a warp per frame with the frame's keys in
// registers.  An utterance that stops leaves the loop at once.
#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "beam_products.cuh"
#include "decode_step.cuh"

// Must match the ctypes.Structure in ops/beam_loop.py field for field.
struct BeamLoopArgs {
  const float* pre;             // (U, L, M) preprocessed attended
  const float* attended;        // (U, L, D)
  const float* att_mask;        // (U, L)
  const float* conv_taps;       // (n_filters, n_taps) the filters, true conv
  const float* state_trans;     // (N*S, M), row-stacked over the layers
  const float* handler;         // (n_filters, M)
  const float* v;               // (M,) energy vector
  const float* merge_k;         // (D, R)
  const float* merge_b;         // (R,)
  const float* merge_states_k;  // (N*S, R) or null
  const float* post_k;          // (R, V); maxout (R / maxout, V)
  const float* post_b;          // (V,)
  const float* embed;           // (Vf, F)
  // a stack's per-layer tables layer-major (N, rows, width), each layer's
  // contiguous; its biases and initial states (N * width,)
  const float* fork_in_w;       // (F, S)
  const float* fork_in_b;       // (S,)
  const float* fork_gate_w;     // (F, 2S)
  const float* fork_gate_b;     // (2S,)
  const float* dist_in_w;       // (D, S)
  const float* dist_gate_w;     // (D, 2S)
  const float* wsg;             // (S, 2S)
  const float* wss;             // (S, S)
  const float* h0;              // (S,)
  int* done_out;                // (U, K, Lout)
  float* done_meta;             // (U, K, 3) [cost, adjusted, length]
  int* steps;                   // (U,)
  int U, L, M, D, S, R, V, F, K, Lout, n_taps;
  int eol, stop_patience, ignore_first_eol, prior_median;
  int content;                  // 1: content-only attention (no conv term)
  int normalizer;               // 0 softmax, 1 logistic, 2 relu
  int mse_cost;                 // 1: costs = -logits (task loss)
  float energy_b;               // energy bias (logistic, relu)
  float char_discount, round_to_inf, before, after;
  float initial_begin, initial_end, min_speed, max_speed;
  int n_filters;                // conv filters (0 read as 1)
  int post_act;                 // 0 tanh, 1 relu, 2 sigmoid, 3 identity,
                                //   4 maxout
  int maxout;                   // maxout's pieces
  int prior_mean;               // 1: window_around_mean
  const float* inter_in_w;      // (N-1, S, S) interlayer tables, or null
  const float* inter_gate_w;    // (N-1, S, 2S)
  int dec_stack;                // GRU decoder layers N (0 read as 1)
  // last, so that the resident instances read every other field at the
  // offset they had before the workspace instances (earlier, the shifted
  // offsets cost them registers: ptxas spilled more)
  float* ws;                    // (U, ws_stride) the workspace instance's
                                //   K-row buffers, or null
  int ws_stride;                // floats an utterance (Layout::stride)
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPatience = 30;
constexpr int kMaxBeam = 512;   // JAX's MAX_LOOP_BEAM: a thread a row
static_assert(kThreads == kProdThreads, "the products split the whole block");
static_assert(kMaxBeam <= kThreads,
              "the merge's commit keeps a row's scalars in one thread");

// Offsets (in 4-byte words) of the buffers.  Each starts on a 16-byte
// boundary, so a product's float2 loads along a row of even pitch are
// aligned.  The resident instances keep all of them in shared memory; the
// workspace instances keep the K-row buffers (h, w, aout, dout, wn, wa and
// the phases' scratch) in the utterance's rows of a global workspace and
// the rest in shared memory.
struct Layout {
  // persistent across steps
  int h, w, aout, dout, acost, dadj, dcost, dlen, newadj, chosen, src, sym,
      pick, mask, taps, handler, v, begins, ends, bad, red_v, red_i;
  // wn: attention -> gather; wa: readout -> gather
  int wn, wa;
  // attention temporaries
  int conv, sp;
  // readout temporaries
  int act, costs;
  // gather / GRU temporaries (a stack's layers reuse hs, gi, it)
  int hs, was, aout2, dout2, fb, gi, it;
  int total;    // shared-memory floats
  int stride;   // workspace floats an utterance (0: resident)
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Whether a launch takes a stacked decoder's instance (kStack, a variant).
__host__ __device__ inline bool is_stack(const BeamLoopArgs& a) {
  return a.dec_stack > 1;
}

// Whether a launch takes a variant instance (kVariant): more than one
// conv filter, the mean prior, an activation besides tanh or a stack.
__host__ __device__ inline bool is_variant(const BeamLoopArgs& a) {
  return (!a.content && a.n_filters > 1) || a.post_act != 0 || a.prior_mean
         || is_stack(a);
}

// The layout of an instance; the variant's sizes the taps, handler rows and
// convolutions by the filters and keeps a maxout readout's grouped units
// after the merged ones, and equals the other instances' where it runs
// what they run; a stack's keeps every layer's states and no feedback rows.
// kWorkspace: the K-row buffers advance their own cursor, from 0 in the
// workspace, in the same order and with the same phases sharing scratch.
template <bool kVariant, bool kStack = false, bool kWorkspace = false>
__host__ __device__ inline Layout make_layout(const BeamLoopArgs& a) {
  Layout o;
  const int K = a.K;
  const int nf = a.content ? 0 : max(a.n_filters, 1);   // kVariant's
  int p = 0, q = 0;
  int& r = kWorkspace ? q : p;   // the K-row buffers' cursor
  auto take = [](int& c, int n) {
    const int at = c;
    c = align4(c + n);
    return at;
  };
  o.h = take(r, K * a.S * (kStack ? a.dec_stack : 1));
  o.w = take(r, K * a.L);
  o.aout = take(r, K * a.Lout);
  o.dout = take(r, K * a.Lout);
  o.acost = take(p, K);
  o.dadj = take(p, K);
  o.dcost = take(p, K);
  o.dlen = take(p, K);
  o.newadj = take(p, K);
  o.chosen = take(p, K);
  o.src = take(p, K);
  o.sym = take(p, K);
  o.pick = take(p, K);
  o.mask = take(p, a.L);
  o.taps = take(p, kVariant ? nf * a.n_taps : a.n_taps);
  o.handler = take(p, kVariant ? nf * a.M : (a.content ? 0 : a.M));
  o.v = take(p, a.M);
  o.begins = take(p, K);
  o.ends = take(p, K);
  o.bad = take(p, a.normalizer == 2 ? K : 0);
  o.red_v = take(p, kWarps + 1);
  o.red_i = take(p, kWarps + 1);
  o.wn = take(r, K * a.L);
  o.wa = take(r, K * a.D);
  const int scratch = r;
  // attention phase
  o.conv = take(r, kVariant ? nf * K * a.L : (a.content ? 0 : K * a.L));
  o.sp = take(r, K * a.M);
  const int end_att = r;
  // readout phase
  r = scratch;
  // a maxout readout's grouped units after the merged ones
  o.act = take(r, kVariant && a.post_act == 4 ? K * a.R + K * a.R / a.maxout
                                              : K * a.R);
  o.costs = take(r, K * a.V);
  const int end_read = r;
  // gather + GRU phase
  r = scratch;
  o.hs = take(r, K * a.S);
  o.was = take(r, K * a.D);
  o.aout2 = take(r, K * a.Lout);
  o.dout2 = take(r, K * a.Lout);
  o.fb = take(r, kStack ? 0 : K * a.F);
  o.gi = take(r, 2 * K * a.S);
  o.it = take(r, K * a.S);
  const int end_gru = r;
  int end = end_att > end_read ? end_att : end_read;
  end = end > end_gru ? end : end_gru;
  o.total = kWorkspace ? p : end;
  o.stride = kWorkspace ? end : 0;
  return o;
}

// The layout a launch takes: the stack's, a variant's or the plain one.
template <bool kWorkspace>
__host__ __device__ inline Layout layout_of(const BeamLoopArgs& a) {
  return is_stack(a)     ? make_layout<true, true, kWorkspace>(a)
         : is_variant(a) ? make_layout<true, false, kWorkspace>(a)
                         : make_layout<false, false, kWorkspace>(a);
}

// Lowest (value, index) among vals[0..n); every thread gets the winner.
__device__ void block_argmin(const float* vals, int n, float* red_v,
                             int* red_i, float& out_v, int& out_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float bv = __int_as_float(0x7f800000);  // +inf
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += blockDim.x) lex_min(bv, bi, vals[j], j);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lex_min(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
            __shfl_xor_sync(0xffffffffu, bi, off));
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? red_v[lane] : __int_as_float(0x7f800000);
    bi = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lex_min(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
              __shfl_xor_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      red_v[kWarps] = bv;
      red_i[kWarps] = bi;
    }
  }
  __syncthreads();
  out_v = red_v[kWarps];
  out_i = red_i[kWarps];
}

// The costs of the task loss's readout, in place: costs[r, c] = alive[r] +
// (-logit) (the reward-regression emitter's costs).
__device__ void negated_costs(float* COSTS, int K, int V, const float* alive) {
  for (int idx = threadIdx.x; idx < K * V; idx += blockDim.x)
    COSTS[idx] = alive[idx / V] + (-COSTS[idx]);
}

// Rows flagged by the relu normalizer lose every candidate.
__device__ void drop_bad_rows(float* COSTS, int K, int V, const float* BAD) {
  for (int idx = threadIdx.x; idx < K * V; idx += blockDim.x)
    if (BAD[idx / V] != 0.f) COSTS[idx] = kBig;
}

// The done-set merge of the workspace instances: entry j of [existing K,
// new K] takes slot rank(j), the number of entries before it in (value,
// index) order, when that is below K.  The K lowest entries in that order,
// in order: the picks of the resident instances' K warp rounds (old entries
// win ties), in O(K^2 / threads) a thread instead of O(K^3 / 32) a lane.
__device__ void rank_merge(const float* DADJ, const float* NEWADJ, int K,
                           int* PICK) {
  for (int j = threadIdx.x; j < 2 * K; j += blockDim.x) {
    const float x = j < K ? DADJ[j] : NEWADJ[j - K];
    int rank = 0;
    for (int i = 0; i < 2 * K; ++i) {
      const float y = i < K ? DADJ[i] : NEWADJ[i - K];
      rank += (y < x || (y == x && i < j)) ? 1 : 0;
    }
    if (rank < K) PICK[rank] = j;
  }
}

// The GRU advance of a stack of N layers, one after another (JAX
// beam_loop.py:481-511): layer l gathers its states of the source rows,
// adds to the fork products of the symbols' feedback rows (read from global
// memory) and the distribute products the interlayer products of layer
// l-1's new, unmasked state (H's lanes of layer l-1 after its advance),
// and writes its new state to H's lanes of layer l.  Each sum is the one
// of the single-layer advance, k-ordered per product, the products added in
// the order fork, distribute, interlayer, state.  Out of line: its
// registers stay out of the rest of the step's.
__device__ __noinline__ void stack_advance(const BeamLoopArgs& a, float* H,
                                           float* HS, const float* WAS,
                                           const int* SYM, const int* SRC,
                                           float* GI, float* IT, int N,
                                           int K, int S, int D, int F) {
  const int tid = threadIdx.x, NS = N * S;
  for (int ly = 0; ly < N; ++ly) {
    for (int idx = tid; idx < K * S; idx += blockDim.x)
      HS[idx] = H[SRC[idx / S] * NS + ly * S + idx % S];
    __syncthreads();
    run_product_gathered({a.embed, F, a.fork_gate_w + (size_t)ly * F * 2 * S,
                          F, 2 * S, a.fork_gate_b + ly * 2 * S, GI, 2 * S,
                          false}, SYM, K);
    run_product_gathered({a.embed, F, a.fork_in_w + (size_t)ly * F * S, F, S,
                          a.fork_in_b + ly * S, IT, S, false}, SYM, K);
    __syncthreads();
    run_product({WAS, D, a.dist_gate_w + (size_t)ly * D * 2 * S, D, 2 * S,
                 nullptr, GI, 2 * S, true}, K);
    run_product({WAS, D, a.dist_in_w + (size_t)ly * D * S, D, S, nullptr,
                 IT, S, true}, K);
    if (ly > 0) {
      __syncthreads();
      const float* below = H + (ly - 1) * S;
      run_product({below, NS, a.inter_gate_w + (size_t)(ly - 1) * S * 2 * S,
                   S, 2 * S, nullptr, GI, 2 * S, true}, K);
      run_product({below, NS, a.inter_in_w + (size_t)(ly - 1) * S * S, S, S,
                   nullptr, IT, S, true}, K);
    }
    __syncthreads();
    run_product({HS, S, a.wsg + (size_t)ly * S * 2 * S, S, 2 * S, nullptr, GI,
                 2 * S, true}, K);
    __syncthreads();
    // gates = sigmoid(.): update in GI[:, :S], reset * h into GI[:, S:]
    for (int idx = tid; idx < K * 2 * S; idx += blockDim.x) {
      const int k = idx / (2 * S), c = idx % (2 * S);
      const float g = 1.f / (1.f + expf(-GI[idx]));
      GI[idx] = c < S ? g : HS[k * S + c - S] * g;
    }
    __syncthreads();
    run_product({GI + S, 2 * S, a.wss + (size_t)ly * S * S, S, S, nullptr, IT,
                 S, true}, K);
    __syncthreads();
    for (int idx = tid; idx < K * S; idx += blockDim.x) {
      const int k = idx / S, c = idx % S;
      const float up = GI[k * 2 * S + c];
      const float cand = tanhf(IT[idx]);
      H[k * NS + ly * S + c] = up * cand + (1.f - up) * HS[idx];
    }
    // the next layer reads this one's states and gathers its own
    if (ly + 1 < N) __syncthreads();
  }
}

// kNorm: 0 softmax, 1 logistic, 2 relu; kMse: the task loss's costs;
// kVariant: the WSJ recipes' variants, 1-16 conv filters, the mean prior
// and the post-merge activations besides tanh (instantiated for the
// log-likelihood): the other instances compile none of it; kStack (with
// kVariant): 2-4 decoder layers (instantiated for softmax); kWorkspace:
// the K-row buffers in the utterance's rows of a.ws (beam_loop_ws.cu),
// the resident instances' code otherwise (beam_loop.cu).
template <int kNorm, bool kMse, bool kVariant, bool kStack = false,
          bool kWorkspace = false>
__global__ void __launch_bounds__(kThreads, 1)
beam_loop_kernel(BeamLoopArgs a) {
  extern __shared__ float sm[];
  const Layout o = make_layout<kVariant, kStack, kWorkspace>(a);
  const int u = blockIdx.x;
  // where the K-row buffers live
  float* rows = kWorkspace ? a.ws + (size_t)u * a.ws_stride : sm;
  const int K = a.K, L = a.L, M = a.M, D = a.D, S = a.S, R = a.R, V = a.V,
            F = a.F, Lout = a.Lout, n_taps = a.n_taps;
  const int nf = kVariant ? max(a.n_filters, 1) : 1;
  const int N = kStack ? a.dec_stack : 1, NS = N * S;   // the stack's lanes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* H = rows + o.h;
  float* Wt = rows + o.w;
  int* AOUT = reinterpret_cast<int*>(rows + o.aout);
  int* DOUT = reinterpret_cast<int*>(rows + o.dout);
  float* ACOST = sm + o.acost;
  float* DADJ = sm + o.dadj;
  float* DCOST = sm + o.dcost;
  float* DLEN = sm + o.dlen;
  float* NEWADJ = sm + o.newadj;
  float* CHOSEN = sm + o.chosen;
  int* SRC = reinterpret_cast<int*>(sm + o.src);
  int* SYM = reinterpret_cast<int*>(sm + o.sym);
  int* PICK = reinterpret_cast<int*>(sm + o.pick);
  float* MASK = sm + o.mask;
  float* TAPS = sm + o.taps;
  float* HAND = sm + o.handler;
  float* VV = sm + o.v;
  float* BEGINS = sm + o.begins;
  float* ENDS = sm + o.ends;
  float* BAD = sm + o.bad;
  float* RED_V = sm + o.red_v;
  int* RED_I = reinterpret_cast<int*>(sm + o.red_i);
  float* WN = rows + o.wn;
  float* WA = rows + o.wa;
  float* CONV = rows + o.conv;
  float* SP = rows + o.sp;
  float* ACT = rows + o.act;
  float* COSTS = rows + o.costs;
  float* HS = rows + o.hs;
  float* WAS = rows + o.was;
  int* AOUT2 = reinterpret_cast<int*>(rows + o.aout2);
  int* DOUT2 = reinterpret_cast<int*>(rows + o.dout2);
  float* FB = rows + o.fb;
  float* GI = rows + o.gi;
  float* IT = rows + o.it;

  const float* pre = a.pre + (size_t)u * L * M;
  const float* att = a.attended + (size_t)u * L * D;

  // ---- init ---------------------------------------------------------
  float msum = 0.f;
  for (int l = tid; l < L; l += blockDim.x) {
    const float m = a.att_mask[(size_t)u * L + l];
    MASK[l] = m;
    msum += m;
  }
  for (int j = tid; j < nf * n_taps; j += blockDim.x)
    TAPS[j] = a.conv_taps[j];
  for (int m = tid; m < M; m += blockDim.x) {
    if (!a.content) HAND[m] = a.handler[m];
    VV[m] = a.v[m];
  }
  for (int m = M + tid; kVariant && m < nf * M; m += blockDim.x)
    HAND[m] = a.handler[m];
  for (int i = tid; i < K * NS; i += blockDim.x) H[i] = a.h0[i % NS];
  for (int i = tid; i < K * L; i += blockDim.x) Wt[i] = (i % L) == 0 ? 1.f : 0.f;
  for (int i = tid; i < K * Lout; i += blockDim.x) {
    AOUT[i] = 0;
    DOUT[i] = 0;
  }
  msum = warp_sum(msum);
  if (lane == 0) RED_V[warp] = msum;
  __syncthreads();
  float total_mask = 0.f;
  for (int w = 0; w < kWarps; ++w) total_mask += RED_V[w];
  const bool dead = total_mask == 0.f;
  for (int k = tid; k < K; k += blockDim.x) {
    ACOST[k] = (k == 0 && !dead) ? 0.f : kInf;
    DCOST[k] = kInf;
    DADJ[k] = kInf;
    DLEN[k] = 0.f;
  }
  __syncthreads();

  int patience = kPatience;
  float min_cost = 1000.f;
  bool stopped = dead;
  int steps = 0;
  const int max_len = Lout;

  for (int i = 0; i < max_len; ++i) {
    // ---- stopping bookkeeping (every thread, identical values) ------
    bool has_done = false, all_valid = true;
    float best_adj = kBig, kth_adj = -kInf, alive_min = kBig;
    for (int k = 0; k < K; ++k) {
      const float d = DADJ[k];
      const bool valid = d < kInf / 2;
      has_done = has_done || valid;
      all_valid = all_valid && valid;
      best_adj = fminf(best_adj, d);
      kth_adj = fmaxf(kth_adj, valid ? d : -kInf);
      alive_min = fminf(alive_min, ACOST[k]);
    }
    const bool empty = alive_min >= kInf;
    bool newly;
    if (a.stop_patience) {
      const bool improved = best_adj < min_cost;
      if (has_done && improved) min_cost = best_adj;
      if (has_done) patience = improved ? kPatience : patience - 1;
      newly = patience <= 0;
    } else {
      const float optimistic =
          alive_min - a.char_discount * (float)max_len;
      newly = all_valid && kth_adj < optimistic;
    }
    stopped = stopped || newly || empty;
    if (stopped) break;
    steps = i + 1;

    // ---- window prior -------------------------------------------------
    int lb, le;
    if (a.prior_median) {
      median_bounds(Wt, K, L, a.before, a.after, true, BEGINS, ENDS);
      union_window(BEGINS, ENDS, K, L, lb, le);
    } else if (kVariant && a.prior_mean) {
      mean_bounds(Wt, K, L, a.before, a.after, BEGINS, ENDS);
      union_window(BEGINS, ENDS, K, L, lb, le);
    } else {
      expanding_window(i, L, a.initial_begin, a.initial_end, a.min_speed,
                       a.max_speed, lb, le);
    }

    // ---- convolution (true convolution, trimmed 'full' mode) ----------
    if (kVariant && !a.content)
      window_conv_filters(Wt, TAPS, n_taps, nf, K, L, lb, le, CONV);
    else if (!a.content)
      window_conv(Wt, TAPS, n_taps, K, L, lb, le, CONV);
    // ---- state projection ---------------------------------------------
    run_product({H, NS, a.state_trans, NS, M, nullptr, SP, M, false}, K);
    __syncthreads();

    // ---- energies inside the window (warp per frame) -------------------
    if (a.content)
      window_energies<false>(pre, M, nullptr, SP, nullptr, VV, K, L, lb, le,
                             WN);
    else if (kVariant)
      window_energies_filters(pre, M, CONV, SP, HAND, VV, nf, K, L, lb, le,
                              WN);
    else
      window_energies<true>(pre, M, CONV, SP, HAND, VV, K, L, lb, le, WN);
    __syncthreads();

    // ---- masked normalization over the window (warp per row) ----------
    window_softmax<kNorm>(WN, MASK, BEGINS, ENDS,
                          a.prior_median || (kVariant && a.prior_mean), K, L,
                          lb, le, a.energy_b, BAD);
    __syncthreads();

    // ---- weighted average of the encoder outputs ----------------------
    run_product({WN + lb, L, att + (size_t)lb * D, le - lb, D, nullptr, WA, D,
                 false}, K);
    __syncthreads();

    // ---- readout: merge, activation, post-merge, log-softmax ----------
    run_product({WA, D, a.merge_k, D, R, a.merge_b, ACT, R, false}, K);
    if (a.merge_states_k != nullptr) {
      __syncthreads();
      run_product({H, NS, a.merge_states_k, NS, R, nullptr, ACT, R, true},
                  K);
    }
    __syncthreads();
    if (kVariant) {
      const float* X =
          post_merge_act(ACT, K, R, a.post_act, a.maxout, ACT + K * R);
      const int Rx = a.post_act == 4 ? R / a.maxout : R;
      __syncthreads();
      run_product({X, Rx, a.post_k, Rx, V, a.post_b, COSTS, V, false}, K);
    } else {
      tanh_in_place(ACT, K * R);
      __syncthreads();
      run_product({ACT, R, a.post_k, R, V, a.post_b, COSTS, V, false}, K);
    }
    __syncthreads();
    if (kMse)
      negated_costs(COSTS, K, V, ACOST);
    else
      log_softmax_costs(COSTS, K, V, ACOST);
    if (kNorm == 2) {
      __syncthreads();
      drop_bad_rows(COSTS, K, V, BAD);
    }
    __syncthreads();

    // ---- K selection rounds over the K*V candidates --------------------
    for (int slot = 0; slot < K; ++slot) {
      float mv;
      int mi;
      block_argmin(COSTS, K * V, RED_V, RED_I, mv, mi);
      if (tid == 0) {
        SRC[slot] = mi / V;
        SYM[slot] = mi % V;
        CHOSEN[slot] = mv;
        COSTS[mi] = kBig;
      }
      __syncthreads();
    }

    // ---- gather by source row, record the symbol ------------------------
    for (int idx = tid; !kStack && idx < K * S; idx += blockDim.x)
      HS[idx] = H[SRC[idx / S] * S + idx % S];
    for (int idx = tid; idx < K * L; idx += blockDim.x)
      Wt[idx] = WN[SRC[idx / L] * L + idx % L];
    for (int idx = tid; idx < K * D; idx += blockDim.x)
      WAS[idx] = WA[SRC[idx / D] * D + idx % D];
    for (int idx = tid; idx < K * Lout; idx += blockDim.x) {
      const int k = idx / Lout, j = idx % Lout;
      AOUT2[idx] = j == i ? SYM[k] : AOUT[SRC[k] * Lout + j];
    }
    for (int idx = tid; !kStack && idx < K * F; idx += blockDim.x)
      FB[idx] = a.embed[(size_t)SYM[idx / F] * F + idx % F];
    __syncthreads();

    // ---- GRU advance ------------------------------------------------------
    if (kStack) {
      stack_advance(a, H, HS, WAS, SYM, SRC, GI, IT, N, K, S, D, F);
    } else {
      run_product({FB, F, a.fork_gate_w, F, 2 * S, a.fork_gate_b, GI, 2 * S,
                   false}, K);
      run_product({FB, F, a.fork_in_w, F, S, a.fork_in_b, IT, S, false}, K);
      __syncthreads();
      run_product({WAS, D, a.dist_gate_w, D, 2 * S, nullptr, GI, 2 * S, true},
                  K);
      run_product({WAS, D, a.dist_in_w, D, S, nullptr, IT, S, true}, K);
      __syncthreads();
      run_product({HS, S, a.wsg, S, 2 * S, nullptr, GI, 2 * S, true}, K);
      __syncthreads();
      // gates = sigmoid(.): update in GI[:, :S], reset * h into GI[:, S:]
      for (int idx = tid; idx < K * 2 * S; idx += blockDim.x) {
        const int k = idx / (2 * S), c = idx % (2 * S);
        const float g = 1.f / (1.f + expf(-GI[idx]));
        GI[idx] = c < S ? g : HS[k * S + c - S] * g;
      }
      __syncthreads();
      run_product({GI + S, 2 * S, a.wss, S, S, nullptr, IT, S, true}, K);
      __syncthreads();
      for (int idx = tid; idx < K * S; idx += blockDim.x) {
        const int k = idx / S, c = idx % S;
        const float up = GI[k * 2 * S + c];
        const float cand = tanhf(IT[idx]);
        H[idx] = up * cand + (1.f - up) * HS[idx];
      }
    }

    // ---- EOS retirement ---------------------------------------------------
    const float alive_len = (float)(i + 1);
    for (int k = tid; k < K; k += blockDim.x) {
      const bool is_eos =
          SYM[k] == a.eol && !(a.ignore_first_eol && i == 0);
      const float prev = ACOST[SRC[k]];
      const float step_cost = CHOSEN[k] - prev;
      const bool finishing =
          is_eos && step_cost < a.round_to_inf && prev < kInf / 2;
      const float adjusted = CHOSEN[k] - a.char_discount * (alive_len + 1.f);
      NEWADJ[k] = finishing ? adjusted : kInf;
    }
    __syncthreads();

    // ---- done-set merge: [existing K, new K] -> K, old entries win ties --
    if (kWorkspace) {
      rank_merge(DADJ, NEWADJ, K, PICK);
    } else if (warp == 0) {
      for (int slot = 0; slot < K; ++slot) {
        float bv = __int_as_float(0x7f800000);
        int bi = INT_MAX;
        for (int j = lane; j < 2 * K; j += 32) {
          const float x = j < K ? DADJ[j] : NEWADJ[j - K];
          bool taken = false;
          for (int s = 0; s < slot; ++s) taken = taken || PICK[s] == j;
          lex_min(bv, bi, taken ? kBig : x, j);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          lex_min(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
                  __shfl_xor_sync(0xffffffffu, bi, off));
        if (lane == 0) PICK[slot] = bi;
        __syncwarp();
      }
    }
    __syncthreads();
    for (int idx = tid; idx < K * Lout; idx += blockDim.x) {
      const int k = idx / Lout, j = idx % Lout, p = PICK[k];
      DOUT2[idx] = p < K ? DOUT[p * Lout + j] : AOUT2[(p - K) * Lout + j];
    }
    // new done scalars, held in the registers of threads 0..K-1 until
    // every thread has read the old ones
    float nadj = 0.f, ncost = 0.f, nlen = 0.f;
    if (tid < K) {
      const int p = PICK[tid];
      nadj = p < K ? DADJ[p] : NEWADJ[p - K];
      ncost = p < K ? DCOST[p] : CHOSEN[p - K];
      nlen = p < K ? DLEN[p] : alive_len;
    }
    __syncthreads();

    // ---- commit -------------------------------------------------------
    if (tid < K) {
      DADJ[tid] = nadj;
      DCOST[tid] = ncost;
      DLEN[tid] = nlen;
      ACOST[tid] = (SYM[tid] == a.eol && !(a.ignore_first_eol && i == 0))
                       ? kInf : CHOSEN[tid];
    }
    for (int idx = tid; idx < K * Lout; idx += blockDim.x) {
      AOUT[idx] = AOUT2[idx];
      DOUT[idx] = DOUT2[idx];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < K * Lout; idx += blockDim.x)
    a.done_out[(size_t)u * K * Lout + idx] = DOUT[idx];
  for (int k = tid; k < K; k += blockDim.x) {
    float* meta = a.done_meta + ((size_t)u * K + k) * 3;
    meta[0] = DCOST[k];
    meta[1] = DADJ[k];
    meta[2] = DLEN[k];
  }
  if (tid == 0) a.steps[u] = steps;
}

}  // namespace

namespace {

template <int kNorm, bool kMse, bool kVariant, bool kStack, bool kWorkspace>
int launch_loop(const BeamLoopArgs* args, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      beam_loop_kernel<kNorm, kMse, kVariant, kStack, kWorkspace>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  beam_loop_kernel<kNorm, kMse, kVariant, kStack, kWorkspace>
      <<<args->U, kThreads, smem, stream>>>(*args);
  return (int)cudaGetLastError();
}

// the instances configs use: the variants under the log-likelihood alone,
// a stack under the log-likelihood and softmax
// (ops/beam_loop.py::unported_loop)
template <int kNorm, bool kWorkspace>
int launch_cost(const BeamLoopArgs* args, int smem, cudaStream_t stream) {
  if (is_stack(*args))
    return kNorm != 0 || args->mse_cost || args->dec_stack > 4
               ? (int)cudaErrorInvalidValue
               : launch_loop<0, false, true, true, kWorkspace>(args, smem,
                                                               stream);
  if (is_variant(*args))
    return args->mse_cost
               ? (int)cudaErrorInvalidValue
               : launch_loop<kNorm, false, true, false, kWorkspace>(
                     args, smem, stream);
  return args->mse_cost
             ? launch_loop<kNorm, true, false, false, kWorkspace>(args, smem,
                                                                  stream)
             : launch_loop<kNorm, false, false, false, kWorkspace>(
                   args, smem, stream);
}

// One launch of the instance the normalizer, the costs and the variant
// pieces pick, with `smem` bytes of shared memory a block.
template <bool kWorkspace>
int launch_instance(const BeamLoopArgs* args, int smem, cudaStream_t s) {
  switch (args->normalizer) {
    case 0:
      return launch_cost<0, kWorkspace>(args, smem, s);
    case 1:
      return launch_cost<1, kWorkspace>(args, smem, s);
    case 2:
      return launch_cost<2, kWorkspace>(args, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
