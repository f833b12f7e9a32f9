// Teacher-forced attention-decoder scan of the training path: the whole
// label-time loop in one forward launch and one reverse-time backward launch.
//
// Replaces attention_lvcsr_tpu/ops/pallas/decoder_train.py::
// decoder_scan_train (:839; forward _fwd_kernel :225, backward _bwd_kernel
// :339, custom VJP :601-836) for conv attention with 1-16 filters
// (n_filters), the softmax, logistic or relu normalizer (normalizer 0, 1, 2;
// the last two with the energy bias), the expanding, window_around_median or
// window_around_mean prior, one GRU layer (with more than one filter and
// softmax also two to four layers, dec_stack: :278-300 forward, :445-520
// backward); and for content-only attention
// (n_filters = 0 there, content = 1 here): no convolution and no conv[l] *
// hand[m] term, so the weights do not feed the energies
// (decoder_train.py:580-582) and the backward forms no band or handler
// gradient.  Per step t and batch row b (forward):
//
//   window  [gb, ge) from the prior (median: each row's running-sum median
//           of w; mean: sum_l w[l] * l; bounds taken over the whole batch);
//           combined = gmask * (begin_b < l < end_b) * att_mask
//   conv    = (w * gmask) @ toep, filter by filter (toep (L, F * L));
//           sp = h @ st
//   e[l]    = sum_m v[m] tanh(pre[b,l,m] + sp[m] + sum_f conv_f[l] *
//             hand[f,m]) (+ e_bias under logistic and relu)
//   wnew    = g(e) * combined / (its sum, or 1 where combined is all zero),
//             g = exp(e - max over the window) (softmax), sigmoid(e)
//             (logistic) or max(e / 1000, 0) (relu)
//   wa_new  = wnew @ att[b]
//   GRU     [u, r] = sigmoid(h @ wsg + fg[t] + wa_new @ dgm)
//           c = tanh((h * r) @ wss + fx[t] + wa_new @ dxm)
//           h_new = u * c + (1 - u) * h
//   h, w, wa, e*gmask are replaced where mask[t, b] > 0.5 (by selection)
//
// The backward walks the steps in reverse with dh, dw, dwa on chip, the TPU
// kernel's algebra (decoder_train.py:423-585): GRU backward, the distribute
// products' backward, the weighted-average backward, then the attention step
// recomputed from (h_prev, w_prev) -- the (B, L, M) match tensor is never
// stored -- and the normalizer, energy and convolution backward (under
// logistic and relu from each frame's g'(e) * combined / denominator, which
// the forward stores in gsc; the bias's gradient, the sum of the energies'
// gradients, goes to an extra column of dv).  It writes
// dpre once at the end, and per-step rows (dfx, dfg, dsp, dwan, the windowed
// weights and dconv) from which ops/decoder_train.py forms the weight
// gradients and datt with outer_sum.cu, which also sums the (row, block)
// partials of dhand and dv in a fixed order.
//
// What bounds it on the card: each step is a chain of dependent
// vector-matrix products over 2.7 MB (forward) and 3.1 MB (backward) of
// weights, 50 K tanh a row and a few reductions; the weights do not fit in
// shared memory, so they stream from L2 every step, and the products wait
// on L2.  Design (the plan is mirrored in ops/decoder_train.py::plan):
//
// * the whole card: a persistent grid of thread-block clusters of C = 4, 8
//   or 16 blocks; the B rows are spread over as many clusters as the card
//   holds at once (cudaOccupancyMaxActiveClusters), so a cluster serves R or
//   R - 1 rows.  The median prior's window spans the batch, so the forward
//   meets at one grid barrier a step and is a cooperative launch (every
//   block co-resident or no launch);
// * block j of a cluster owns frame tile [j*Lt, (j+1)*Lt) of its rows for
//   the attention (energies, softmax, weighted average and their backward)
//   and column slice j of every product (sp, the convolution, the GRU's
//   gates and candidate, the distribute products, their transposes), the
//   columns the wrapper packs k-major per block (ops/decoder_train.py::
//   pack), zero-padded to multiples of four floats;
// * each weight element is read from L2 once per cluster a step, for all
//   its rows at once: a product thread keeps up to eight rows x four
//   columns in registers (16-byte loads, eight in flight) over one of up to
//   32 k slices; the slices' partial sums are added in a fixed order;
// * the rows' dpre (backward), att and pre tiles stay in shared memory for
//   the whole scan where they fit, in that order (res_dpre, res_att and
//   res_pre of the R rows, chosen by the plan); the other rows read theirs
//   from L2 every step, with their loads batched;
// * blocks exchange their slices of the vectors a product reads (h, r * h,
//   sp, w, the gate gradients, dwan, dcv) and the partials of the softmax,
//   weighted average, dsp and the softmax backward through distributed
//   shared memory, behind split cluster barriers (five a step each way);
// * no atomics in any sum: every cross-thread, cross-warp and cross-block
//   sum is taken in an order fixed by the plan, so a second call repeats
//   bit for bit;
// * the normalizer and the attention branch (content, one filter, more
//   filters) are template parameters, one instance each, so the
//   one-filter softmax route keeps no run-time test of them in its loops.
//   With F > 1 filters the backward takes a block's rows one after
//   another through the energies' backward, so the per-filter partials of
//   dconv need room for one row, and sums the handler's gradient over its
//   rows as well as its steps (one (cluster, block) partial, dhand (C *
//   clusters, F, M)).
//
// The forward records each step's [gb, ge) and the backward reads it, so
// the backward needs no grid barrier and is the exact gradient of its
// forward.
//
// A stack of N layers (kStack, an instance of its own) keeps every layer's
// states in shared memory (forward hst, backward hp) and runs each step's
// GRU layer by layer through the single layer's scratch: forward, layer
// l > 0 reads [below | wan | h] in its gate product and [below | wan] in
// its candidate's, below the new, unmasked state of layer l-1, exchanged
// like h; backward, the layers in reverse, each with the single layer's
// two exchanges, the gradient reaching layer l-1's new state (dbelow =
// [dca | dgu | dgr] @ [inter_in^T; inter_gate^T]) carried on chip, and one
// distribute product over every layer's gate gradients.  The interlayer
// tables' weight gradients are outer_sum jobs over the layer below's new
// state, which the wrapper recomputes from the residuals (u c + (1 - u)
// h_prev), never stored.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sm90_async.cuh"

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
  const float* hand;   // (F, M) handler rows
  const float* v;      // (M)
  // each block's column slice of the weights, k-major, (C, K, width) each
  // (ops/decoder_train.py::pack_forward, pack_backward)
  const float* p_toep;   // toep by frame tile, filter by filter
                         //                               (C, L, F * Lq)
  const float* p_st;     // st by M slice                 (C, S, Mc)
  const float* p_gate;   // [dgm; wsg], [u | r] by S slice (C, Dp + Sp, 2Sc)
  const float* p_dx;     // dxm by S slice                (C, D, Sc)
  const float* p_ss;     // wss by S slice                (C, S, Sc)
  const float* p_ssT;    // wss^T by S slice              (C, S, Sc)
  const float* p_sgT;    // wsg^T, rows [u; r]            (C, 2Sp, Sc)
  const float* p_dxgT;   // [dxm^T; dgm^T u; dgm^T r]     (C, 3Sp, Dc)
  const float* p_stT;    // st^T by S slice               (C, M, Sc)
  const float* p_toepT;  // toep^T by frame tile, the F bands' rows
                         //   each padded to L4           (C, F * L4, Lq)
  // a stack of N layers: fx, fg, h0, h_out, the residuals, dh, dfx, dfg
  // and dh0 lane-stacked (N * S, N * 2S); p_st's rows each layer's S
  // padded to Sp (C, N Sp, Mc); p_gate layer 0's (C, Dp + Sp, 2Sc) then
  // each later layer's [inter_gate; dgm; wsg] (C, Sp + Dp + Sp, 2Sc);
  // p_dx layer 0's (C, D, Sc) then [inter_in; dxm] (C, Sp + D, Sc); p_ss,
  // p_ssT and p_sgT layer after layer; p_dxgT every layer's [dca | dgu |
  // dgr] rows (C, N 3Sp, Dc); p_stT each layer's column slice side by side
  // (C, M, N Sc)
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
  float* dpre;         // (B, L, M)
  float* dsp;          // (T, B, M) gradient of each step's h @ st
  float* wg;           // (T, B, L) windowed previous weights
  float* dconv;        // (T, B, F, L) gradient of each step's convolutions
  float* dwan;         // (T, B, D) gradient of each step's weighted average
  float* dhand;        // (B, C, M) each (row, block)'s sum over its steps;
                       //   F > 1: (clusters, C, F, M) each (cluster,
                       //   block)'s sum over its rows and steps
  float* dv;           // (B, C, M), (B, C, M + 1) with the bias's gradient
  const float* e_bias; // (1,) energy bias (logistic, relu)
  float* gsc;          // (T, B, L) g'(e) * combined / denominator (logistic,
                       //   relu): written forward, read backward
  int T, B, L, M, D, S, prior_median;
  int content;         // 1: content-only attention (no conv term)
  int normalizer;      // 0 softmax, 1 logistic, 2 relu
  int cluster;         // blocks a cluster (4, 8 or 16)
  int clusters;        // clusters of the grid
  int res_pre;         // rows of a cluster whose pre, att and (backward)
  int res_att;         //   dpre tiles stay in shared memory; the other
  int res_dpre;        //   rows' tiles are read from L2
  float before, after, initial_begin, initial_end, min_speed, max_speed;
  int n_filters;       // conv filters (0 read as 1)
  int prior_mean;      // 1: window_around_mean
  const float* p_ibT;  // [inter_in^T; inter_gate^T u; inter_gate^T r] of
                       //   each layer l > 0, by layer l-1's S slice
                       //   (N - 1, C, 3Sp, Sc)
  int dec_stack;       // GRU layers N (0 read as 1)
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;     // rows a cluster (a warp each in row sums)
constexpr int kRowChunk = 8;     // rows a product thread keeps in registers
constexpr int kMaxSlices = 32;   // k slices of a product
constexpr int kAhead = 8;        // 16-byte weight loads in flight a thread
                                 //   (twice that for up to four rows)
constexpr int kMaxSmemFloats = 232448 / 4;
constexpr float kNeg = -1e30f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// A plan's slices: frame tile Lt (Lq padded to four), column slices Sc, Mc,
// Dc (multiples of four) and the padded widths C * slice.
struct Dims {
  int C, R, Lt, Lq, L4, Sc, Sp, Mc, Mp, Dc, Dp, M4, Mt, Mch, groups;
};

__host__ __device__ inline Dims dims(int C, int R, int L, int M, int D,
                                     int S) {
  Dims d;
  d.C = C;
  d.R = R;
  d.Lt = cdiv(L, C);
  d.Lq = up4(d.Lt);
  d.L4 = up4(L);
  d.Sc = up4(cdiv(S, C));
  d.Sp = C * d.Sc;
  d.Mc = up4(cdiv(M, C));
  d.Mp = C * d.Mc;
  d.Dc = up4(cdiv(D, C));
  d.Dp = C * d.Dc;
  d.M4 = up4(M);
  d.Mt = M | 1;          // odd pitch of the pre tiles: no bank conflicts
  // the backward's energies: warps over (32-column chunk of M, frame group)
  d.Mch = cdiv(M, 32);
  d.groups = kWarps / min(d.Mch, kWarps);
  return d;
}

// k slices of a product over K rows into `width` columns (four a thread)
__host__ __device__ inline int slices(int K, int width) {
  const int groups = width / 4;
  return max(1, min(min(kMaxSlices, kThreads / groups), K));
}

__host__ __device__ inline int part_floats(int K, int width, int R) {
  return slices(K, width) * min(R, kRowChunk) * width;
}

// Shared-memory layout of a block (offsets in floats, 16-byte aligned);
// kind 0 forward, 1 backward.  -1: not in this kind's layout.  nf: the
// conv filters, 0 without the conv term, whose buffers (wgv, conv;
// backward also dcv, dcvw) then hold nothing and whose band products need
// no room in `part`.  With nf > 1 the backward's dcvw holds one row's
// partials and dhg a block's (rows summed).  N: the GRU layers; a stack's
// rows hold every layer's states and gradients (hst, hp, g1, dh, dhp), a
// forward gin row the layer below's new state first, and the backward the
// gradient reaching the layer below (dbl).
struct Layout {
  int gin, w, wgv, rh, sp, wanp, wa, ek, conv, e, un, comb, xin, gate;
  int hst;            // a stack's states, every layer's (forward)
  int hp, g1, dwan, dspp, dsp, dcv, wn, dwn, dE, dh, dhp, dw, dwa, dcvw,
      dspg, dvg, dhg, dbl;
  int pout, rs, red, vh, part, pre, att, dpre, total;
};

__host__ __device__ inline int take(int& at, int n) {
  const int p = at;
  at += up4(n);
  return p;
}

__host__ __device__ inline Layout layout(int kind, const Dims& d, int L,
                                         int M, int D, int S, int res_pre,
                                         int res_att, int res_dpre,
                                         int nf, int N = 1) {
  Layout o;
  const bool conv = nf > 0;
  const int below = N > 1 ? d.Sp : 0;
  const int hands = nf > 1 ? nf : 1;
  int* all = &o.gin;
  for (int i = 0; i < (int)(sizeof(Layout) / sizeof(int)); ++i) all[i] = -1;
  const int R = d.R;
  int at = 0, pmax = 0, part = 0;
  if (kind == 0) {
    o.gin = take(at, R * (below + d.Dp + d.Sp));   // [below | wan | h]
    o.w = take(at, R * d.L4);
    o.wgv = take(at, conv ? R * d.L4 : 0);
    o.rh = take(at, R * d.Sp);
    o.sp = take(at, R * d.Mp);
    o.wanp = take(at, R * d.Dp);
    o.wa = take(at, R * d.Dc);
    o.ek = take(at, R * d.Lq);
    o.conv = take(at, R * nf * d.Lq);
    o.e = take(at, R * d.Lq);
    o.un = take(at, R * d.Lq);
    o.comb = take(at, R * d.Lq);
    o.xin = take(at, R * d.Sc);
    o.gate = take(at, R * 2 * d.Sc);
    o.hst = take(at, N > 1 ? R * N * d.Sp : 0);
    pmax = max(max(d.Lq, d.Mc), 2 * d.Sc);
    part = max(max(conv ? part_floats(L, nf * d.Lq, R) : 0,
                   part_floats(N > 1 ? N * d.Sp : S, d.Mc, R)),
               max(part_floats(below + d.Dp + d.Sp, 2 * d.Sc, R),
                   max(part_floats(N > 1 ? d.Sp + D : D, d.Sc, R),
                       part_floats(S, d.Sc, R))));
  } else {
    o.hp = take(at, R * N * d.Sp);
    o.wgv = take(at, conv ? R * d.L4 : 0);
    o.g1 = take(at, R * N * 3 * d.Sp);     // [dca | dga_u | dga_r] a layer
    o.sp = take(at, R * d.Mp);
    o.dwan = take(at, R * d.Dp);
    o.dspp = take(at, R * d.Mp);
    o.dsp = take(at, R * d.Mp);
    o.dcv = take(at, R * nf * d.L4);
    o.conv = take(at, R * nf * d.Lq);
    o.wn = take(at, R * d.Lq);
    o.dwn = take(at, R * d.Lq);
    o.dE = take(at, R * d.Lq);
    o.dh = take(at, R * N * d.Sc);
    o.dhp = take(at, R * N * d.Sc);
    o.dw = take(at, R * d.Lq);
    o.dwa = take(at, R * d.Dc);
    // per M chunk: dcv (nf > 1: one row's, filter by filter)
    o.dcvw = take(at, nf > 1 ? nf * d.Mch * d.Lq : nf * d.Mch * R * d.Lq);
    o.dspg = take(at, d.groups * R * d.M4);  // per frame group: dsp, and
    o.dvg = take(at, d.groups * R * d.M4);   //   dv and dhand over the
    // steps (nf > 1: dhand a filter, over the rows too)
    o.dhg = take(at, nf > 1 ? nf * d.groups * d.M4 : d.groups * R * d.M4);
    o.dbl = take(at, below ? R * d.Sc : 0);
    pmax = max(max(d.Lq, d.Mc), max(N * d.Sc, d.Dc));
    part = max(max(max(part_floats(N > 1 ? N * d.Sp : S, d.Mc, R),
                       conv ? max(part_floats(L, nf * d.Lq, R),
                                  part_floats(nf > 1 ? nf * d.L4 : L, d.Lq,
                                              R))
                            : 0),
                   max(part_floats(S, d.Sc, R),
                       part_floats(2 * d.Sp, d.Sc, R))),
               max(part_floats(N * 3 * d.Sp, d.Dc, R),
                   part_floats(M, N * d.Sc, R)));
    if (N > 1) part = max(part, part_floats(3 * d.Sp, d.Sc, R));
  }
  o.pout = take(at, R * pmax);
  o.rs = take(at, 8 * R);
  o.red = take(at, 2 * kWarps);
  o.vh = take(at, (1 + hands) * d.M4);     // v | hand rows
  o.part = take(at, part);
  if (kind == 1 && res_dpre > 0) o.dpre = take(at, res_dpre * d.Lt * d.Mt);
  if (res_att > 0) o.att = take(at, res_att * d.Lt * D);
  if (res_pre > 0) o.pre = take(at, res_pre * d.Lt * d.Mt);
  o.total = at;
  return o;
}

enum Reduce { kSum, kMax, kMin };

__device__ __forceinline__ float combine(float x, float y, Reduce op) {
  return op == kSum ? x + y : op == kMax ? fmaxf(x, y) : fminf(x, y);
}

__device__ __forceinline__ float warp_reduce(float x, Reduce op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = combine(x, __shfl_xor_sync(0xffffffffu, x, o), op);
  return x;
}

// Block-wide reduction of one value per thread; every thread gets the
// result.  red: kWarps floats of shared memory.
__device__ float block_reduce(float x, float* red, Reduce op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = warp_reduce(x, op);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = combine(r, red[w], op);
  __syncthreads();
  return r;
}

// A lane's fold acc = f(i, x[i], acc) over its elements i = lane + 32k < n
// of a row x (shared memory or L2), kBatch loads in flight before their
// uses: a row read from L2 costs one round trip per 32 * kBatch elements.
template <int kBatch, class F>
__device__ __forceinline__ float lane_fold(const float* x, int n, F f) {
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int base = lane; base < n; base += 32 * kBatch) {
    float xv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      xv[k] = base + 32 * k < n ? x[base + 32 * k] : 0.f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + 32 * k < n) acc = f(base + 32 * k, xv[k], acc);
  }
  return acc;
}

// out[r * ldo + c] = sum_k x[r * ldx + k] * P[k * width + c] for r < rows
// (<= RC), c < width: P is the block's packed column slice, (K, width),
// width a multiple of four.  Thread (q, g) takes columns [4g, 4g + 4) of k
// slice q for all rows, so each weight element is loaded once; kAhead (16
// for at most four rows) 16-byte loads are in flight before their FMAs.
// The slices' partials are added in four chains of every fourth slice,
// then the chains in order.
template <int RC>
__device__ __noinline__ void product_rows(const float* x, int ldx, int rows,
                                          int K,
                                          const float* __restrict__ P,
                                          int width, float* part, float* out,
                                          int ldo) {
  // more loads in flight where fewer rows hold registers
  constexpr int kA = RC <= 4 ? 2 * kAhead : kAhead;
  const int G = width / 4, Q = slices(K, width);
  const float* xr[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) xr[r] = x + min(r, rows - 1) * ldx;
  for (int item = threadIdx.x; item < Q * G; item += kThreads) {
    const int q = item / G, g = item % G;
    const int k0 = q * K / Q, k1 = (q + 1) * K / Q;
    const float4* wp = reinterpret_cast<const float4*>(P) + g;
    float acc[RC][4];
#pragma unroll
    for (int r = 0; r < RC; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    auto step = [&](int k, const float4& wv) {
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float xv = xr[r][k];
        acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
        acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
        acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
        acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
      }
    };
    int k = k0;
    for (; k + kA <= k1; k += kA) {
      float4 wv[kA];
#pragma unroll
      for (int s = 0; s < kA; ++s) wv[s] = __ldg(wp + (size_t)(k + s) * G);
#pragma unroll
      for (int s = 0; s < kA; ++s) step(k + s, wv[s]);
    }
    for (; k < k1; ++k) step(k, __ldg(wp + (size_t)k * G));
    float* pp = part + q * RC * width + 4 * g;
#pragma unroll
    for (int r = 0; r < RC; ++r)
      *reinterpret_cast<float4*>(pp + r * width) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  // four chains over the slices, added in a fixed order
  for (int o = threadIdx.x; o < rows * width; o += kThreads) {
    const int r = o / width, c = o % width;
    const float* p = part + r * width + c;
    const int step = RC * width;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int q = 0;
    for (; q + 4 <= Q; q += 4) {
      s0 += p[q * step];
      s1 += p[(q + 1) * step];
      s2 += p[(q + 2) * step];
      s3 += p[(q + 3) * step];
    }
    for (; q < Q; ++q) s0 += p[q * step];
    out[r * ldo + c] = (s0 + s1) + (s2 + s3);
  }
  __syncthreads();
}

// The product of `rows` rows, kRowChunk rows at a time.
__device__ void product(const float* x, int ldx, int rows, int K,
                        const float* P, int width, float* part, float* out,
                        int ldo) {
  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const int n = min(kRowChunk, rows - r0);
    const float* xs = x + r0 * ldx;
    float* os = out + r0 * ldo;
    switch (n) {
      case 1: product_rows<1>(xs, ldx, n, K, P, width, part, os, ldo); break;
      case 2: product_rows<2>(xs, ldx, n, K, P, width, part, os, ldo); break;
      case 3: product_rows<3>(xs, ldx, n, K, P, width, part, os, ldo); break;
      case 4: product_rows<4>(xs, ldx, n, K, P, width, part, os, ldo); break;
      case 5: product_rows<5>(xs, ldx, n, K, P, width, part, os, ldo); break;
      case 6: product_rows<6>(xs, ldx, n, K, P, width, part, os, ldo); break;
      case 7: product_rows<7>(xs, ldx, n, K, P, width, part, os, ldo); break;
      default: product_rows<8>(xs, ldx, n, K, P, width, part, os, ldo);
    }
  }
}

// Copy every peer's slice [q * chunk, (q + 1) * chunk) of rows r < rows of
// buf (row pitch ld) from peer q's shared memory into ours, 16 bytes a load
// (buf, chunk and ld multiples of four floats).
__device__ void pull4(cooperative_groups::cluster_group& cluster, float* buf,
                      int ld, int rows, int chunk, int self, int C) {
  const int per = chunk / 4, count = rows * C * per;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int r = i / (C * per), q = (i / per) % C, c = i % per;
    if (q == self) continue;
    float4* dst = reinterpret_cast<float4*>(buf + r * ld + q * chunk) + c;
    *dst = *cluster.map_shared_rank(dst, q);
  }
}

// The same for a vector of n floats in slices of `chunk`, 4 bytes a load.
__device__ void pull1(cooperative_groups::cluster_group& cluster, float* buf,
                      int ld, int rows, int chunk, int n, int self, int C) {
  const int count = rows * n;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int r = i / n, l = i % n, q = l / chunk;
    if (q == self) continue;
    float* dst = buf + r * ld + l;
    *dst = *cluster.map_shared_rank(dst, q);
  }
}

// sum over the cluster's blocks of x[i] in rank order, x in each block's
// shared memory at the same offset (16 bytes)
__device__ __forceinline__ float4 sum_peers4(
    cooperative_groups::cluster_group& cluster, float* x, int C) {
  float4 v[16];
#pragma unroll
  for (int q = 0; q < 16; ++q)
    if (q < C) v[q] = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(x, q));
  float4 s = v[0];
#pragma unroll
  for (int q = 1; q < 16; ++q)
    if (q < C) {
      s.x += v[q].x;
      s.y += v[q].y;
      s.z += v[q].z;
      s.w += v[q].w;
    }
  return s;
}

// Warp-wide reduction over the cluster's blocks of the float at x (lane q
// reads block q's), in a fixed tree; every lane gets the result.
__device__ __forceinline__ float reduce_peers(
    cooperative_groups::cluster_group& cluster, float* x, int C, Reduce op,
    float identity) {
  const int lane = threadIdx.x % 32;
  const float v = lane < C ? *cluster.map_shared_rank(x, lane) : identity;
  return warp_reduce(v, op);
}

// Thread 0 of each block: arrive at the grid barrier (bar[0] counts
// arrivals, bar[1] is the generation); returns the generation to wait past.
__device__ unsigned grid_arrive(unsigned* bar) {
  volatile unsigned* gen = bar + 1;
  const unsigned g = *gen;
  __threadfence();
  if (atomicAdd(bar, 1u) == gridDim.x - 1) {
    atomicExch(bar, 0u);
    __threadfence();
    atomicAdd(bar + 1, 1u);
  }
  return g;
}

__device__ void grid_wait(unsigned* bar, unsigned g) {
  volatile unsigned* gen = bar + 1;
  while (*gen == g) __nanosleep(32);
  __threadfence();
}

// The rows of cluster c: [b0, b0 + nr), the B rows spread evenly.
__device__ __forceinline__ void cluster_rows(int B, int clusters, int c,
                                             int& b0, int& nr) {
  const int q = B / clusters, rem = B % clusters;
  b0 = c * q + min(c, rem);
  nr = q + (c < rem ? 1 : 0);
}

// g(e) of a normalizer other than softmax, and its derivative g'(e)
template <int kNorm>
__device__ __forceinline__ float numerator(float e) {
  return kNorm == 1 ? sigmoidf(e) : fmaxf(e / 1000.f, 0.f);
}
template <int kNorm>
__device__ __forceinline__ float numerator_grad(float e) {
  if (kNorm == 1) {
    const float s = sigmoidf(e);
    return s * (1.f - s);
  }
  return (e > 0.f ? 1.f : 0.f) / 1000.f;
}

// The conv filters of an instance: 0 for the content branch (kConv 0), one
// (kConv 1), or the struct's n_filters (kConv 2).
template <int kConv>
__device__ __forceinline__ int filters_of(const DecoderArgs& a) {
  return kConv == 0 ? 0 : kConv == 1 ? 1 : a.n_filters;
}

// window_around_mean: each row's bounds [floor(e - before), ceil(e +
// after)) around the mean position e = sum_l w[l] * l of its weights w
// (warp r, row r of pitch L4), into rs[r * 8 + 5], rs[r * 8 + 6], and
// (block 0 of the cluster) into this step's exchange slot for the grid's
// union, as the median's bounds go (out of line: the median route keeps
// its code).
__device__ __noinline__ void mean_bounds(const DecoderArgs& a,
                                         const float* w, int L4, int nr,
                                         int b0, int j, int t, float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= nr) return;
  const float* wr = w + warp * L4;
  float s = 0.f;
  for (int l = lane; l < a.L; l += 32) s += wr[l] * (float)l;
  const float expected = warp_reduce(s, kSum);
  const float begin_b = floorf(expected - a.before);
  const float end_b = ceilf(expected + a.after);
  if (lane == 0) {
    rs[warp * 8 + 5] = begin_b;
    rs[warp * 8 + 6] = end_b;
    if (j == 0) {
      float* slot = a.exch + (t & 1) * 2 * a.B;
      slot[2 * (b0 + warp)] = begin_b;
      slot[2 * (b0 + warp) + 1] = end_b;
      __threadfence();
    }
  }
}

// The forward's GRU over a stack of N layers, one step, after the
// attention has left the new averages in gin's wan (JAX :278-300): layer l
// copies its states into gin's h, forms its gates and candidate from [wan |
// h] (l = 0) or [below | wan | h], where below is layer l-1's new, unmasked
// state, and writes its masked new state to hst and, for the layer above,
// its unmasked one to gin's below; each layer's own slices exchanged like
// the single layer's h.  Every block of the cluster calls it.
__device__ void stack_forward(const DecoderArgs& a,
                              cooperative_groups::cluster_group& cluster,
                              float* gin, float* hst, float* rh, float* xin,
                              float* gate, float* pout, float* part,
                              float* w, const float* rs, int t, int N, int S,
                              int nr, int j, int C, const Dims& d,
                              size_t row0, bool pull_w) {
  const int tid = threadIdx.x;
  const int Sc = d.Sc, Sp = d.Sp, Dp = d.Dp, D = a.D, NS = N * S;
  const int gp = Sp + Dp + Sp, hsp = N * Sp;
  const int s0 = j * Sc, ns = max(0, min(S - s0, Sc));
  float *wan = gin + Sp, *h = wan + Dp;
  for (int ly = 0; ly < N; ++ly) {
    for (int i = tid; i < nr * Sp; i += kThreads)
      h[(i / Sp) * gp + i % Sp] = hst[(i / Sp) * hsp + ly * Sp + i % Sp];
    __syncthreads();
    // ---- gates of own units; own slice of r * h
    const float* xg = ly ? gin : wan;
    const int kg = ly ? 2 * Sp + Dp : Dp + Sp;
    const size_t goff =
        ly ? (size_t)C * (Dp + Sp) * 2 * Sc
                 + (size_t)(ly - 1) * C * (2 * Sp + Dp) * 2 * Sc
           : 0;
    product(xg, gp, nr, kg, a.p_gate + goff + (size_t)j * kg * 2 * Sc,
            2 * Sc, part, gate, 2 * Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const float* fg = a.fg + (row0 + r) * 2 * NS + ly * 2 * S;
      const float u = sigmoidf(gate[r * 2 * Sc + c] + fg[s0 + c]);
      const float rr = sigmoidf(gate[r * 2 * Sc + Sc + c] + fg[S + s0 + c]);
      gate[r * 2 * Sc + c] = u;
      gate[r * 2 * Sc + Sc + c] = rr;
      rh[r * Sp + s0 + c] = rr * h[r * gp + s0 + c];
    }
    cluster_arrive();
    // the averages' (and the layer below's) share of the candidates
    const int kx = ly ? Sp + D : D;
    const size_t xoff =
        ly ? (size_t)C * D * Sc + (size_t)(ly - 1) * C * (Sp + D) * Sc : 0;
    product(xg, gp, nr, kx, a.p_dx + xoff + (size_t)j * kx * Sc, Sc, part,
            xin, Sc);
    cluster_wait();
    pull4(cluster, rh, Sp, nr, Sc, j, C);
    // the whole rows of w feed the convolution and the median or mean
    if (ly == 0 && pull_w) pull1(cluster, w, d.L4, nr, d.Lt, a.L, j, C);
    __syncthreads();
    // ---- candidates and the new state of own units
    product(rh, Sp, nr, S, a.p_ss + (size_t)(ly * C + j) * S * Sc, Sc, part,
            pout, Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const size_t at = (row0 + r) * NS + ly * S + s0 + c;
      const float cand = tanhf(pout[r * Sc + c] + (a.fx[at] + xin[r * Sc + c]));
      const float u = gate[r * 2 * Sc + c];
      const float hold = h[r * gp + s0 + c];
      const float hn = u * cand + (1.f - u) * hold;
      if (rs[r * 8 + 7] > 0.f) hst[r * hsp + ly * Sp + s0 + c] = hn;
      if (ly + 1 < N) gin[r * gp + s0 + c] = hn;
      pout[r * Sc + c] = cand;
    }
    cluster_arrive();
    // this layer's stores, issued after the arrive
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const size_t at = (row0 + r) * NS + ly * S + s0 + c;
      a.h_out[at] = hst[r * hsp + ly * Sp + s0 + c];
      a.u_out[at] = gate[r * 2 * Sc + c];
      a.r_out[at] = gate[r * 2 * Sc + Sc + c];
      a.c_out[at] = pout[r * Sc + c];
    }
    // ---- wait for the cluster's new states; pull the peers' slices
    cluster_wait();
    if (ly + 1 < N) pull4(cluster, gin, gp, nr, Sc, j, C);
    if (t + 1 < a.T) pull4(cluster, hst + ly * Sp, hsp, nr, Sc, j, C);
    __syncthreads();
  }
}

// kConv: 0 the content branch, 1 one conv filter, 2 more filters; kNorm:
// 0 softmax, 1 logistic, 2 relu; each compiled apart so that the
// one-filter softmax route keeps no run-time test of them in its loops;
// kStack: 2-4 GRU layers (instantiated with kConv 2 and softmax)
template <int kConv, int kNorm, bool kStack = false>
__global__ void __launch_bounds__(kThreads, 1)
    decoder_fwd_kernel(const __grid_constant__ DecoderArgs a) {
  namespace cg = cooperative_groups;
  constexpr bool kContent = kConv == 0, kMulti = kConv == 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float sm[];
  const int T = a.T, B = a.B, L = a.L, M = a.M, D = a.D, S = a.S;
  const int C = a.cluster, j = (int)cluster.block_rank();
  const int nf = filters_of<kConv>(a);
  const bool windowed = a.prior_median || a.prior_mean;
  int b0, nr;
  cluster_rows(B, a.clusters, blockIdx.x / C, b0, nr);
  const Dims d = dims(C, cdiv(B, a.clusters), L, M, D, S);
  const int rp = min(a.res_pre, d.R), ra = min(a.res_att, d.R);
  const int N = kStack ? a.dec_stack : 1, NS = N * S;
  const Layout o = layout(0, d, L, M, D, S, rp, ra, 0, nf, N);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Lt = d.Lt, Lq = d.Lq, L4 = d.L4, Sc = d.Sc, Sp = d.Sp;
  const int Mc = d.Mc, Mp = d.Mp, Dc = d.Dc, Dp = d.Dp;
  const int l0 = j * Lt, nl = max(0, min(L - l0, Lt));
  const int s0 = j * Sc, ns = max(0, min(S - s0, Sc));
  const int e0 = j * Dc, nd = max(0, min(D - e0, Dc));
  // gin rows: [wan | h], a stack's [below | wan | h]
  const int bw = kStack ? Sp : 0, gp = bw + Dp + Sp;
  float *gin = sm + o.gin, *wan = gin + bw, *h = wan + Dp, *w = sm + o.w;
  float* wgv = sm + o.wgv;
  // a stack's states, every layer's (one layer: gin's h)
  float* hst = kStack ? sm + o.hst : h;
  const int hsp = kStack ? N * Sp : gp;
  float *rh = sm + o.rh, *sp = sm + o.sp, *wanp = sm + o.wanp;
  float *wa = sm + o.wa, *ek = sm + o.ek, *conv = sm + o.conv, *e = sm + o.e;
  float *un = sm + o.un, *comb = sm + o.comb, *xin = sm + o.xin;
  float *gate = sm + o.gate, *pout = sm + o.pout, *rs = sm + o.rs;
  float *red = sm + o.red, *v = sm + o.vh, *hand = v + d.M4;
  float* part = sm + o.part;
  const int cq = nf * Lq;                    // conv pitch: F frame tiles
  const float ebias = kNorm != 0 ? a.e_bias[0] : 0.f;
  // a row's tiles: resident rows in shared memory, the others in L2
  auto pre_row = [&](int r) -> const float* {
    return r < rp ? sm + o.pre + r * Lt * d.Mt
                  : a.pre + ((size_t)(b0 + r) * L + l0) * M;
  };
  auto att_row = [&](int r) -> const float* {
    return r < ra ? sm + o.att + r * Lt * D
                  : a.att + ((size_t)(b0 + r) * L + l0) * D;
  };

  // zero everything (padding stays zero); state, weights, tiles
  for (int i = tid; i < o.total; i += kThreads) sm[i] = 0.f;
  __syncthreads();
  if (kStack) {
    for (int i = tid; i < nr * NS; i += kThreads)
      hst[(i / NS) * hsp + (i % NS) / S * Sp + i % S] =
          a.h0[(size_t)b0 * NS + i];
  } else {
    for (int i = tid; i < nr * S; i += kThreads)
      h[(i / S) * gp + i % S] = a.h0[(size_t)b0 * S + i];
  }
  for (int i = tid; i < nr * L; i += kThreads)
    w[(i / L) * L4 + i % L] = a.w0[(size_t)b0 * L + i];
  for (int i = tid; i < nr * nd; i += kThreads)
    wa[(i / nd) * Dc + i % nd] = a.wa0[(size_t)(b0 + i / nd) * D + e0 + i % nd];
  for (int m = tid; m < M; m += kThreads) {
    v[m] = a.v[m];
    hand[m] = a.hand[m];
  }
  for (int i = M + tid; kMulti && i < nf * M; i += kThreads)
    hand[(i / M) * d.M4 + i % M] = a.hand[i];
  for (int i = tid; i < min(rp, nr) * nl * M; i += kThreads) {
    const int r = i / (nl * M), l = (i / M) % nl, m = i % M;
    sm[o.pre + (r * Lt + l) * d.Mt + m] =
        a.pre[((size_t)(b0 + r) * L + l0 + l) * M + m];
  }
  for (int i = tid; i < min(ra, nr) * nl * D; i += kThreads) {
    const int r = i / (nl * D), l = (i / D) % nl, c = i % D;
    sm[o.att + (r * Lt + l) * D + c] =
        a.att[((size_t)(b0 + r) * L + l0 + l) * D + c];
  }
  // every block of the cluster initialised before any remote access
  cluster.sync();

  for (int t = 0; t < a.T; ++t) {
    const size_t row0 = (size_t)t * B + b0;
    unsigned gen = 0;
    // ---- window of the prior
    if (windowed) {
      if (a.prior_mean) {
        mean_bounds(a, w, L4, nr, b0, j, t, rs);
      } else if (warp < nr) {
        // warp r: running sum of row r's w over contiguous chunks per
        // lane, and the number of frames whose running sum stays under 0.5
        const float* wr = w + warp * L4;
        const int per = (L + 31) / 32;
        const int la = min(L, lane * per), lb = min(L, la + per);
        float s = 0.f;
        for (int l = la; l < lb; ++l) s += wr[l];
        float incl = s;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        float run = incl - s, count = 0.f;
        for (int l = la; l < lb; ++l) {
          run += wr[l];
          count += run < 0.5f ? 1.f : 0.f;
        }
        count = warp_reduce(count, kSum);
        const float expected = fmaxf(0.f, count - 1.f);
        const float begin_b = floorf(expected - a.before);
        const float end_b = ceilf(expected + a.after);
        if (lane == 0) {
          rs[warp * 8 + 5] = begin_b;
          rs[warp * 8 + 6] = end_b;
          if (j == 0) {
            float* slot = a.exch + (t & 1) * 2 * B;
            slot[2 * (b0 + warp)] = begin_b;
            slot[2 * (b0 + warp) + 1] = end_b;
            __threadfence();
          }
        }
      }
      __syncthreads();
      if (tid == 0) gen = grid_arrive(a.barrier);
    }
    // ---- the state's keys, own M slice (needs no window)
    if (kStack)
      product(hst, hsp, nr, N * Sp, a.p_st + (size_t)j * N * Sp * Mc, Mc,
              part, sp + j * Mc, Mp);
    else
      product(h, gp, nr, S, a.p_st + (size_t)j * S * Mc, Mc, part,
              sp + j * Mc, Mp);
    cluster_arrive();
    float gb, ge;
    if (windowed) {
      if (tid == 0) grid_wait(a.barrier, gen);
      __syncthreads();
      const float* slot = a.exch + (t & 1) * 2 * B;
      float lo = 3.4e38f, hi = -3.4e38f;
      for (int i = tid; i < B; i += kThreads) {
        lo = fminf(lo, __ldcg(slot + 2 * i));
        hi = fmaxf(hi, __ldcg(slot + 2 * i + 1));
      }
      lo = block_reduce(lo, red, kMin);
      hi = block_reduce(hi, red, kMax);
      gb = floorf(fmaxf(0.f, lo));
      ge = ceilf(fminf((float)L, hi));
    } else {
      const float s = (float)a.step0[t];
      gb = floorf(fmaxf(0.f, fminf((float)(L - 1),
                                   a.initial_begin + s * a.min_speed)));
      ge = ceilf(fmaxf(0.f, fminf((float)L,
                                  a.initial_end + s * a.max_speed)));
    }
    if (blockIdx.x == 0 && tid == 0) {
      a.bounds[2 * t] = gb;
      a.bounds[2 * t + 1] = ge;
    }
    auto inside = [&](int l) { return (float)l >= gb && (float)l < ge; };
    for (int i = tid; !kContent && i < nr * L; i += kThreads) {
      const int r = i / L, l = i % L;
      wgv[r * L4 + l] = inside(l) ? w[r * L4 + l] : 0.f;
    }
    for (int i = tid; i < nr * nl; i += kThreads) {
      const int r = i / nl, l = i % nl, pos = l0 + l;
      const float add = !windowed || ((float)pos > rs[r * 8 + 5] &&
                                      (float)pos < rs[r * 8 + 6])
                            ? 1.f : 0.f;
      comb[r * Lq + l] = (inside(pos) ? 1.f : 0.f) * add
                         * a.amask[(size_t)(b0 + r) * L + pos];
    }
    __syncthreads();
    // ---- convolution of the windowed weights, own frames, each filter
    if (!kContent)
      product(wgv, L4, nr, L, a.p_toep + (size_t)j * L * cq, cq, part, conv,
              cq);
    cluster_wait();
    pull4(cluster, sp, Mp, nr, Mc, j, C);
    __syncthreads();
    // ---- energies of own frames: one warp per frame, lanes over M
    for (int item = warp; item < nr * nl; item += kWarps) {
      const int r = item / nl, l = item % nl;
      const float* pl = pre_row(r) + (size_t)l * (r < rp ? d.Mt : M);
      const float* spr = sp + r * Mp;
      float acc;
      if (kMulti) {
        const float* cr = conv + r * cq + l;
        acc = lane_fold<8>(pl, M, [&](int m, float p, float s) {
          float x = p + spr[m];
          for (int f = 0; f < nf; ++f) x = x + cr[f * Lq] * hand[f * d.M4 + m];
          return fmaf(v[m], tanhf(x), s);
        });
      } else if (!kContent) {
        const float cl = conv[r * Lq + l];
        acc = lane_fold<8>(pl, M, [&](int m, float p, float s) {
          return fmaf(v[m], tanhf(p + spr[m] + cl * hand[m]), s);
        });
      } else {
        acc = lane_fold<8>(pl, M, [&](int m, float p, float s) {
          return fmaf(v[m], tanhf(p + spr[m]), s);
        });
      }
      acc = warp_reduce(acc, kSum);
      if (lane == 0) e[r * Lq + l] = kNorm != 0 ? acc + ebias : acc;
    }
    __syncthreads();
    if (warp < nr) {
      float mx = kNeg;
      for (int l = lane; l < nl; l += 32)
        if (inside(l0 + l)) mx = fmaxf(mx, e[warp * Lq + l]);
      mx = warp_reduce(mx, kMax);
      if (lane == 0) rs[warp * 8] = mx;
    }
    cluster_arrive();
    cluster_wait();
    // ---- normalizer over the window: numerators and partial sums of own
    // frames (the max shift is softmax's alone)
    if (warp < nr) {
      float mx = reduce_peers(cluster, rs + warp * 8, C, kMax, kNeg);
      mx = mx > kNeg / 2 ? mx : 0.f;
      float sum = 0.f, csum = 0.f;
      for (int l = lane; l < nl; l += 32) {
        const float cb = comb[warp * Lq + l];
        const float u = kNorm == 0 ? expf(e[warp * Lq + l] - mx) * cb
                                   : numerator<kNorm>(e[warp * Lq + l]) * cb;
        un[warp * Lq + l] = u;
        sum += u;
        csum += cb;
      }
      sum = warp_reduce(sum, kSum);
      csum = warp_reduce(csum, kSum);
      if (lane == 0) {
        rs[warp * 8 + 1] = sum;
        rs[warp * 8 + 2] = csum;
      }
    }
    __syncthreads();
    // ---- weighted average: partial sums of own frames
    for (int i = tid; i < nr * Dp; i += kThreads) {
      const int r = i / Dp, c = i % Dp;
      float acc = 0.f;
      if (c < D) {
        const float* ar = att_row(r) + c;
#pragma unroll 16
        for (int l = 0; l < nl; ++l)
          acc = fmaf(un[r * Lq + l], ar[(size_t)l * D], acc);
      }
      wanp[i] = acc;
    }
    cluster_arrive();
    cluster_wait();
    if (warp < nr) {
      const float sum = reduce_peers(cluster, rs + warp * 8 + 1, C, kSum, 0.f);
      const float csum = reduce_peers(cluster, rs + warp * 8 + 2, C, kSum,
                                      0.f);
      if (lane == 0) {
        rs[warp * 8 + 4] = sum + (csum == 0.f ? 1.f : 0.f);
        rs[warp * 8 + 7] = a.mask[row0 + warp] > 0.5f ? 1.f : 0.f;
      }
    }
    for (int i = tid; i < nr * Dp / 4; i += kThreads) {
      const int r = i / (Dp / 4), c = 4 * (i % (Dp / 4));
      const float4 s = sum_peers4(cluster, wanp + r * Dp + c, C);
      float* dst = wan + r * gp + c;
      dst[0] = s.x;
      dst[1] = s.y;
      dst[2] = s.z;
      dst[3] = s.w;
    }
    __syncthreads();
    for (int i = tid; i < nr * Dp; i += kThreads) {
      const int r = i / Dp;
      wan[r * gp + i % Dp] /= rs[r * 8 + 4];
    }
    // the new weights of own frames, the averages of own columns
    for (int i = tid; i < nr * nl; i += kThreads) {
      const int r = i / nl, l = i % nl;
      const size_t at = (row0 + r) * L + l0 + l;
      if (rs[r * 8 + 7] > 0.f) {
        w[r * L4 + l0 + l] = un[r * Lq + l] / rs[r * 8 + 4];
        ek[r * Lq + l] = inside(l0 + l) ? e[r * Lq + l] : 0.f;
      }
      a.w_out[at] = w[r * L4 + l0 + l];
      a.e_out[at] = ek[r * Lq + l];
      if (kNorm != 0)
        a.gsc[at] = numerator_grad<kNorm>(e[r * Lq + l]) * comb[r * Lq + l]
                    / rs[r * 8 + 4];
    }
    __syncthreads();
    for (int i = tid; i < nr * nd; i += kThreads) {
      const int r = i / nd, c = i % nd;
      if (rs[r * 8 + 7] > 0.f) wa[r * Dc + c] = wan[r * gp + e0 + c];
      a.wa_out[(row0 + r) * D + e0 + c] = wa[r * Dc + c];
    }
    if (kStack) {
      stack_forward(a, cluster, gin, hst, rh, xin, gate, pout, part, w, rs,
                    t, N, S, nr, j, C, d, row0, !kContent || windowed);
      continue;
    }
    // ---- GRU gates of own units; own slice of r * h
    product(gin, gp, nr, Dp + Sp, a.p_gate + (size_t)j * (Dp + Sp) * 2 * Sc,
            2 * Sc, part, gate, 2 * Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const float* fg = a.fg + (row0 + r) * 2 * S;
      const float u = sigmoidf(gate[r * 2 * Sc + c] + fg[s0 + c]);
      const float rr = sigmoidf(gate[r * 2 * Sc + Sc + c] + fg[S + s0 + c]);
      gate[r * 2 * Sc + c] = u;
      gate[r * 2 * Sc + Sc + c] = rr;
      rh[r * Sp + s0 + c] = rr * h[r * gp + s0 + c];
    }
    cluster_arrive();
    // the averages' share of the candidates (needs no r * h)
    product(gin, gp, nr, D, a.p_dx + (size_t)j * D * Sc, Sc, part, xin, Sc);
    cluster_wait();
    pull4(cluster, rh, Sp, nr, Sc, j, C);
    // the whole rows of w feed the convolution and the median or mean
    if (!kContent || windowed) pull1(cluster, w, L4, nr, Lt, L, j, C);
    __syncthreads();
    // ---- candidates and the new state of own units
    product(rh, Sp, nr, S, a.p_ss + (size_t)j * S * Sc, Sc, part, pout, Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const float cand = tanhf(
          pout[r * Sc + c] + (a.fx[(row0 + r) * S + s0 + c] + xin[r * Sc + c]));
      const float u = gate[r * 2 * Sc + c];
      const float hold = h[r * gp + s0 + c];
      const float hn = u * cand + (1.f - u) * hold;
      if (rs[r * 8 + 7] > 0.f) h[r * gp + s0 + c] = hn;
      pout[r * Sc + c] = cand;
    }
    cluster_arrive();
    // this step's stores, issued after the arrive
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const size_t at = (row0 + r) * S + s0 + c;
      a.h_out[at] = h[r * gp + s0 + c];
      a.u_out[at] = gate[r * 2 * Sc + c];
      a.r_out[at] = gate[r * 2 * Sc + Sc + c];
      a.c_out[at] = pout[r * Sc + c];
    }
    // ---- wait for the cluster's new state; pull the peers' slices
    cluster_wait();
    if (t + 1 < T) pull4(cluster, h, gp, nr, Sc, j, C);
    __syncthreads();
  }
  // no block leaves while a peer may still read its shared memory
  cluster.sync();
}

// The backward's GRU over a stack of N layers, one step, the layers in
// reverse (JAX :445-520): layer l's gate gradients from its carried dh (and,
// below the top, the gradient dbl reaching its new state from layer l+1),
// the reset and gate paths into its dhp, and for l > 0 the gradient
// reaching layer l-1's new state, dbl = [dca | dgu | dgr] @ p_ibT.  The top
// layer's pass also recomputes the state's keys and the convolutions, as
// the single layer's GRU backward does.  Every block calls it.
__device__ void stack_backward(const DecoderArgs& a,
                               cooperative_groups::cluster_group& cluster,
                               const float* hp, float* g1, float* dh,
                               float* dhp, float* dbl, float* sp,
                               float* pout, float* part, const float* wgv,
                               float* conv, const float* rs, int N, int S,
                               int nr, int j, int C, const Dims& d, int L,
                               int cq, size_t row0, bool recompute_conv) {
  const int tid = threadIdx.x;
  const int Sc = d.Sc, Sp = d.Sp, Mc = d.Mc, Mp = d.Mp, NS = N * S;
  const int gp = N * 3 * Sp, hsp = N * Sp, dsc = N * Sc;
  const int s0 = j * Sc, ns = max(0, min(S - s0, Sc));
  for (int ly = N - 1; ly >= 0; --ly) {
    float* gl = g1 + ly * 3 * Sp;           // layer ly's [dca | dgu | dgr]
    // ---- GRU backward of own units
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const size_t at = (row0 + r) * NS + ly * S + s0 + c;
      const float m = rs[r * 8 + 2];
      float* dhl = dh + r * dsc + ly * Sc + c;
      const float g = *dhl + a.dh[at];
      float dhn = g * m;
      if (ly + 1 < N) dhn = dhn + dbl[r * Sc + c];
      *dhl = g * (1.f - m);
      const float u = a.u_out[at], cc = a.c_out[at];
      const float du = dhn * (cc - hp[r * hsp + ly * Sp + s0 + c]);
      const float dcand = dhn * u;
      dhp[r * dsc + ly * Sc + c] = dhn * (1.f - u);
      const float dca = dcand * (1.f - cc * cc);
      const float dgu = du * u * (1.f - u);
      gl[r * gp + s0 + c] = dca;
      gl[r * gp + Sp + s0 + c] = dgu;
      a.dfx[at] = dca;
      a.dfg[(row0 + r) * 2 * NS + ly * 2 * S + s0 + c] = dgu;
    }
    // the recomputed state's keys, own M slice
    if (ly == N - 1)
      product(hp, hsp, nr, N * Sp, a.p_st + (size_t)j * N * Sp * Mc, Mc,
              part, sp + j * Mc, Mp);
    cluster_arrive();
    cluster_wait();
    pull4(cluster, gl, gp, nr, Sc, j, C);
    pull4(cluster, gl + Sp, gp, nr, Sc, j, C);
    if (ly == N - 1) pull4(cluster, sp, Mp, nr, Mc, j, C);
    __syncthreads();
    // ---- reset path: dca @ wss^T; own slice of the reset gradients
    product(gl, gp, nr, S, a.p_ssT + (size_t)(ly * C + j) * S * Sc, Sc, part,
            pout, Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const size_t at = (row0 + r) * NS + ly * S + s0 + c;
      const float tmp = pout[r * Sc + c];
      const float rr = a.r_out[at];
      float* dhpl = dhp + r * dsc + ly * Sc + c;
      *dhpl = *dhpl + tmp * rr;
      const float dgr = tmp * hp[r * hsp + ly * Sp + s0 + c] * rr * (1.f - rr);
      gl[r * gp + 2 * Sp + s0 + c] = dgr;
      a.dfg[(row0 + r) * 2 * NS + ly * 2 * S + S + s0 + c] = dgr;
    }
    cluster_arrive();
    // the recomputed convolutions of own frames (need no gradient)
    if (ly == N - 1 && recompute_conv)
      product(wgv, d.L4, nr, L, a.p_toep + (size_t)j * L * cq, cq, part,
              conv, cq);
    cluster_wait();
    pull4(cluster, gl + 2 * Sp, gp, nr, Sc, j, C);
    __syncthreads();
    // ---- gate path
    product(gl + Sp, gp, nr, 2 * Sp,
            a.p_sgT + (size_t)(ly * C + j) * 2 * Sp * Sc, Sc, part, pout, Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      float* dhpl = dhp + r * dsc + ly * Sc + c;
      *dhpl = *dhpl + pout[r * Sc + c];
    }
    // ---- the gradient reaching the layer below's new state, own slice
    if (ly > 0)
      product(gl, gp, nr, 3 * Sp,
              a.p_ibT + (size_t)((ly - 1) * C + j) * 3 * Sp * Sc, Sc, part,
              dbl, Sc);
  }
}

template <int kConv, int kNorm, bool kStack = false>
__global__ void __launch_bounds__(kThreads, 1)
    decoder_bwd_kernel(const __grid_constant__ DecoderArgs a) {
  namespace cg = cooperative_groups;
  constexpr bool kContent = kConv == 0, kMulti = kConv == 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float sm[];
  const int B = a.B, L = a.L, M = a.M, D = a.D, S = a.S;
  const int C = a.cluster, j = (int)cluster.block_rank();
  const int nf = filters_of<kConv>(a);
  int b0, nr;
  cluster_rows(B, a.clusters, blockIdx.x / C, b0, nr);
  const Dims d = dims(C, cdiv(B, a.clusters), L, M, D, S);
  const int R = d.R, rp = min(a.res_pre, R), ra = min(a.res_att, R);
  const int rd = min(a.res_dpre, R);
  const int N = kStack ? a.dec_stack : 1, NS = N * S;
  const Layout o = layout(1, d, L, M, D, S, rp, ra, rd, nf, N);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Lt = d.Lt, Lq = d.Lq, L4 = d.L4, Sc = d.Sc, Sp = d.Sp;
  const int Mc = d.Mc, Mp = d.Mp, Dc = d.Dc, Dp = d.Dp, M4 = d.M4;
  const int l0 = j * Lt, nl = max(0, min(L - l0, Lt));
  const int s0 = j * Sc, ns = max(0, min(S - s0, Sc));
  const int m0 = j * Mc, nm = max(0, min(M - m0, Mc));
  const int e0 = j * Dc, nd = max(0, min(D - e0, Dc));
  // g1 pitch: [dca | dga_u | dga_r] of every layer; hp, dh and dhp
  // pitches: every layer's
  const int gp = N * 3 * Sp, hsp = N * Sp, dsc = N * Sc;
  float *hp = sm + o.hp, *wgv = sm + o.wgv, *g1 = sm + o.g1, *sp = sm + o.sp;
  float *dwan = sm + o.dwan, *dspp = sm + o.dspp, *dsp = sm + o.dsp;
  float *dcv = sm + o.dcv, *conv = sm + o.conv, *wn = sm + o.wn;
  float *dwn = sm + o.dwn, *dE = sm + o.dE, *dh = sm + o.dh, *dhp = sm + o.dhp;
  float *dw = sm + o.dw, *dwa = sm + o.dwa, *dcvw = sm + o.dcvw;
  float *dspg = sm + o.dspg, *dvg = sm + o.dvg, *dhg = sm + o.dhg;
  float *pout = sm + o.pout, *rs = sm + o.rs;
  float *v = sm + o.vh, *hand = v + M4, *part = sm + o.part;
  float* dbl = sm + o.dbl;
  const int cq = nf * Lq, cl4 = nf * L4;     // conv, dcv pitches
  auto pre_row = [&](int r) -> const float* {
    return r < rp ? sm + o.pre + r * Lt * d.Mt
                  : a.pre + ((size_t)(b0 + r) * L + l0) * M;
  };
  auto att_row = [&](int r) -> const float* {
    return r < ra ? sm + o.att + r * Lt * D
                  : a.att + ((size_t)(b0 + r) * L + l0) * D;
  };
  auto dpre_row = [&](int r) -> float* {
    return r < rd ? sm + o.dpre + r * Lt * d.Mt
                  : a.dpre + ((size_t)(b0 + r) * L + l0) * M;
  };

  for (int i = tid; i < o.total; i += kThreads) sm[i] = 0.f;
  for (int i = tid; i < nr * nl * M; i += kThreads) {
    const int r = i / (nl * M);
    if (r >= rd) a.dpre[((size_t)(b0 + r) * L + l0) * M + i % (nl * M)] = 0.f;
  }
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    v[m] = a.v[m];
    hand[m] = a.hand[m];
  }
  for (int i = M + tid; kMulti && i < nf * M; i += kThreads)
    hand[(i / M) * M4 + i % M] = a.hand[i];
  for (int i = tid; i < min(rp, nr) * nl * M; i += kThreads) {
    const int r = i / (nl * M), l = (i / M) % nl, m = i % M;
    sm[o.pre + (r * Lt + l) * d.Mt + m] =
        a.pre[((size_t)(b0 + r) * L + l0 + l) * M + m];
  }
  for (int i = tid; i < min(ra, nr) * nl * D; i += kThreads) {
    const int r = i / (nl * D), l = (i / D) % nl, c = i % D;
    sm[o.att + (r * Lt + l) * D + c] =
        a.att[((size_t)(b0 + r) * L + l0 + l) * D + c];
  }
  cluster.sync();

  for (int t = a.T - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * B + b0, prev = row0 - B;
    const float gb = a.bounds[2 * t], ge = a.bounds[2 * t + 1];
    auto inside = [&](int l) { return (float)l >= gb && (float)l < ge; };
    // ---- step inputs: previous state and weights, this step's weights
    if (kStack) {
      for (int i = tid; i < nr * NS; i += kThreads) {
        const int r = i / NS, k = i % NS;
        hp[r * hsp + k / S * Sp + k % S] = t > 0
            ? a.h_out[(prev + r) * NS + k] : a.h0[(size_t)(b0 + r) * NS + k];
      }
    } else {
      for (int i = tid; i < nr * S; i += kThreads) {
        const int r = i / S, k = i % S;
        hp[r * Sp + k] = t > 0 ? a.h_out[(prev + r) * S + k]
                               : a.h0[(size_t)(b0 + r) * S + k];
      }
    }
    for (int i = tid; !kContent && i < nr * L; i += kThreads) {
      const int r = i / L, l = i % L;
      const float wp = t > 0 ? a.w_out[(prev + r) * L + l]
                             : a.w0[(size_t)(b0 + r) * L + l];
      wgv[r * L4 + l] = inside(l) ? wp : 0.f;
    }
    for (int i = tid; i < nr * nl; i += kThreads) {
      const int r = i / nl, l = i % nl;
      wn[r * Lq + l] = a.w_out[(row0 + r) * L + l0 + l];
    }
    for (int r = tid; r < nr; r += kThreads) rs[r * 8 + 2] = a.mask[row0 + r];
    __syncthreads();
    if (kStack) {
      stack_backward(a, cluster, hp, g1, dh, dhp, dbl, sp, pout, part, wgv,
                     conv, rs, N, S, nr, j, C, d, L, cq, row0, !kContent);
    } else {
    // ---- GRU backward of own units
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const size_t at = (row0 + r) * S + s0 + c;
      const float m = rs[r * 8 + 2];
      const float g = dh[r * Sc + c] + a.dh[at];
      const float dhn = g * m;
      dh[r * Sc + c] = g * (1.f - m);
      const float u = a.u_out[at], cc = a.c_out[at];
      const float du = dhn * (cc - hp[r * Sp + s0 + c]);
      const float dcand = dhn * u;
      dhp[r * Sc + c] = dhn * (1.f - u);
      const float dca = dcand * (1.f - cc * cc);
      const float dgu = du * u * (1.f - u);
      g1[r * gp + s0 + c] = dca;
      g1[r * gp + Sp + s0 + c] = dgu;
      a.dfx[at] = dca;
      a.dfg[(row0 + r) * 2 * S + s0 + c] = dgu;
    }
    // the recomputed state's keys, own M slice
    product(hp, Sp, nr, S, a.p_st + (size_t)j * S * Mc, Mc, part,
            sp + j * Mc, Mp);
    cluster_arrive();
    cluster_wait();
    pull4(cluster, g1, gp, nr, Sc, j, C);
    pull4(cluster, g1 + Sp, gp, nr, Sc, j, C);
    pull4(cluster, sp, Mp, nr, Mc, j, C);
    __syncthreads();
    // ---- reset path: dca @ wss^T; own slice of the reset gradients
    product(g1, gp, nr, S, a.p_ssT + (size_t)j * S * Sc, Sc, part, pout, Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      const float tmp = pout[r * Sc + c];
      const float rr = a.r_out[(row0 + r) * S + s0 + c];
      dhp[r * Sc + c] = dhp[r * Sc + c] + tmp * rr;
      const float dgr = tmp * hp[r * Sp + s0 + c] * rr * (1.f - rr);
      g1[r * gp + 2 * Sp + s0 + c] = dgr;
      a.dfg[(row0 + r) * 2 * S + S + s0 + c] = dgr;
    }
    cluster_arrive();
    // the recomputed convolutions of own frames (need no gradient)
    if (!kContent)
      product(wgv, L4, nr, L, a.p_toep + (size_t)j * L * cq, cq, part, conv,
              cq);
    cluster_wait();
    pull4(cluster, g1 + 2 * Sp, gp, nr, Sc, j, C);
    __syncthreads();
    // ---- gate path and the distribute products' backward
    product(g1 + Sp, gp, nr, 2 * Sp, a.p_sgT + (size_t)j * 2 * Sp * Sc, Sc,
            part, pout, Sc);
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      dhp[r * Sc + c] = dhp[r * Sc + c] + pout[r * Sc + c];
    }
    }
    // ---- the distribute products' backward, every layer's
    product(g1, gp, nr, N * 3 * Sp, a.p_dxgT + (size_t)j * N * 3 * Sp * Dc,
            Dc, part, pout, Dc);
    for (int i = tid; i < nr * nd; i += kThreads) {
      const int r = i / nd, c = i % nd;
      const size_t at = (row0 + r) * D + e0 + c;
      const float m = rs[r * 8 + 2];
      const float g = dwa[r * Dc + c] + a.dwa[at];
      const float dn = g * m + pout[r * Dc + c];
      dwa[r * Dc + c] = g * (1.f - m);
      dwan[r * Dp + e0 + c] = dn;
      a.dwan[at] = dn;
    }
    cluster_arrive();
    cluster_wait();
    pull4(cluster, dwan, Dp, nr, Dc, j, C);
    __syncthreads();
    // ---- weighted-average backward of own frames: a warp a frame
    for (int item = warp; item < nr * nl; item += kWarps) {
      const int r = item / nl, l = item % nl;
      const float* al = att_row(r) + (size_t)l * D;
      const float* gr = dwan + r * Dp;
      float acc = lane_fold<16>(al, D, [&](int c, float x, float s) {
        return fmaf(x, gr[c], s);
      });
      acc = warp_reduce(acc, kSum);
      if (lane == 0) {
        const float m = rs[r * 8 + 2];
        const float g = dw[r * Lq + l] + a.dw[(row0 + r) * L + l0 + l];
        dwn[r * Lq + l] = g * m + acc;
        dw[r * Lq + l] = g * (1.f - m);
      }
    }
    __syncthreads();
    if (warp < nr) {
      float s = 0.f;
      for (int l = lane; l < nl; l += 32)
        s += dwn[warp * Lq + l] * wn[warp * Lq + l];
      s = warp_reduce(s, kSum);
      if (lane == 0) rs[warp * 8] = s;
    }
    cluster_arrive();
    cluster_wait();
    // ---- normalizer backward: softmax's max shift cancels, and
    // dE = w * (dw - sum(dw * w)); else dE = (dw - sum(dw * w)) * g'(e) *
    // combined / denominator, whose sum is the bias's gradient
    if (warp < nr) {
      const float srow = reduce_peers(cluster, rs + warp * 8, C, kSum, 0.f);
      float deb = 0.f;
      for (int l = lane; l < nl; l += 32) {
        const int i = warp * Lq + l;
        if (kNorm == 0) {
          dE[i] = wn[i] * (dwn[i] - srow);
        } else {
          dE[i] = (dwn[i] - srow) * a.gsc[(row0 + warp) * L + l0 + l];
          deb += dE[i];
        }
        if (!kContent)
          a.wg[(row0 + warp) * L + l0 + l] = wgv[warp * L4 + l0 + l];
      }
      if (kNorm != 0) {
        deb = warp_reduce(deb, kSum);
        if (lane == 0) rs[warp * 8 + 4] += deb;
      }
    }
    __syncthreads();
    // ---- energies backward over the recomputed match: warp (c, g) takes
    // the 32 columns of M chunk c over frame group g, lanes over columns.
    // More filters: the rows one after another, each row's per-chunk
    // partials of every filter's dconv summed before the next
    if (kMulti) {
      const int nch = min(d.Mch, kWarps), g = warp / nch;
      for (int r = 0; r < nr; ++r) {
        if (g < d.groups) {
          const float* pr = pre_row(r);
          float* dpr = dpre_row(r);
          const int pp = r < rp ? d.Mt : M, dp = r < rd ? d.Mt : M;
          const float* cr = conv + r * cq;
          const float* er = dE + r * Lq;
          for (int c = warp % nch; c < d.Mch; c += nch) {
            const int mm = c * 32 + lane;
            const bool ok = mm < M;
            const float spm = ok ? sp[r * Mp + mm] : 0.f;
            const float vm = ok ? v[mm] : 0.f;
            float dsa = 0.f, dva = 0.f;
            for (int l = g; l < nl; l += d.groups) {
              const float el = er[l];
              float mt = 0.f, dmt = 0.f;
              if (ok) {
                float x = pr[(size_t)l * pp + mm] + spm;
                for (int f = 0; f < nf; ++f)
                  x = x + cr[f * Lq + l] * hand[f * M4 + mm];
                mt = tanhf(x);
                dmt = el * vm * (1.f - mt * mt);
                dpr[(size_t)l * dp + mm] += dmt;
                for (int f = 0; f < nf; ++f)
                  dhg[(f * d.groups + g) * M4 + mm] += dmt * cr[f * Lq + l];
              }
              dsa += dmt;
              dva += mt * el;
              for (int f = 0; f < nf; ++f) {
                const float dc =
                    warp_reduce(ok ? dmt * hand[f * M4 + mm] : 0.f, kSum);
                if (lane == 0) dcvw[(f * d.Mch + c) * Lq + l] = dc;
              }
            }
            if (ok) {
              const int at = (g * R + r) * M4 + mm;
              dspg[at] = dsa;
              dvg[at] += dva;
            }
          }
        }
        __syncthreads();
        for (int i = tid; i < nf * nl; i += kThreads) {
          const int f = i / nl, l = i % nl;
          float sum = 0.f;
          for (int c = 0; c < d.Mch; ++c) sum += dcvw[(f * d.Mch + c) * Lq + l];
          dcv[r * cl4 + f * L4 + l0 + l] = sum;
          a.dconv[((row0 + r) * nf + f) * L + l0 + l] = sum;
        }
        __syncthreads();
      }
    } else if (warp / min(d.Mch, kWarps) < d.groups) {
      const int nch = min(d.Mch, kWarps), g = warp / nch;
      for (int r = 0; r < nr; ++r) {
        const float* pr = pre_row(r);
        float* dpr = dpre_row(r);
        const int pp = r < rp ? d.Mt : M, dp = r < rd ? d.Mt : M;
        const float* cr = conv + r * Lq;
        const float* er = dE + r * Lq;
        for (int c = warp % nch; c < d.Mch; c += nch) {
          const int mm = c * 32 + lane;
          const bool ok = mm < M;
          const float spm = ok ? sp[r * Mp + mm] : 0.f;
          const float vm = ok ? v[mm] : 0.f, hm = ok ? hand[mm] : 0.f;
          float dsa = 0.f, dva = 0.f, dha = 0.f;
          // kBatch frames' keys and dpre loaded before their uses
          constexpr int kBatch = 8;
          const int stride = kBatch * d.groups;
          for (int lb = g; lb < nl; lb += stride) {
            float pk[kBatch], dk[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
              const int l = lb + k * d.groups;
              const bool in = ok && l < nl;
              pk[k] = in ? pr[(size_t)l * pp + mm] : 0.f;
              dk[k] = in ? dpr[(size_t)l * dp + mm] : 0.f;
            }
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
              const int l = lb + k * d.groups;
              if (l >= nl) break;
              const float cl = kContent ? 0.f : cr[l], el = er[l];
              float mt = 0.f, dmt = 0.f;
              if (ok) {
                mt = kContent ? tanhf(pk[k] + spm)
                               : tanhf(pk[k] + spm + cl * hm);
                dmt = el * vm * (1.f - mt * mt);
                dpr[(size_t)l * dp + mm] = dk[k] + dmt;
              }
              dsa += dmt;
              dva += mt * el;
              if (!kContent) {
                dha += dmt * cl;
                const float dc = warp_reduce(dmt * hm, kSum);
                if (lane == 0) dcvw[(c * R + r) * Lq + l] = dc;
              }
            }
          }
          if (ok) {
            const int at = (g * R + r) * M4 + mm;
            dspg[at] = dsa;
            dvg[at] += dva;
            dhg[at] += dha;
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; !kContent && !kMulti && i < nr * nl; i += kThreads) {
      const int r = i / nl, l = i % nl;
      float s = 0.f;
      for (int c = 0; c < d.Mch; ++c) s += dcvw[(c * R + r) * Lq + l];
      dcv[r * L4 + l0 + l] = s;
      a.dconv[(row0 + r) * L + l0 + l] = s;
    }
    for (int i = tid; i < nr * M; i += kThreads) {
      const int r = i / M, m = i % M;
      float s = dspg[r * M4 + m];
      for (int g = 1; g < d.groups; ++g) s += dspg[(g * R + r) * M4 + m];
      dspp[r * Mp + m] = s;
    }
    cluster_arrive();
    cluster_wait();
    for (int i = tid; i < nr * Mp / 4; i += kThreads) {
      const int r = i / (Mp / 4), c = 4 * (i % (Mp / 4));
      const float4 s = sum_peers4(cluster, dspp + r * Mp + c, C);
      *reinterpret_cast<float4*>(dsp + r * Mp + c) = s;
    }
    for (int f = 0; f < nf; ++f)
      pull1(cluster, dcv + f * L4, cl4, nr, Lt, L, j, C);
    __syncthreads();
    for (int i = tid; i < nr * nm; i += kThreads) {
      const int r = i / nm, c = i % nm;
      a.dsp[(row0 + r) * M + m0 + c] = dsp[r * Mp + m0 + c];
    }
    // ---- state and convolution backward; carry to the step before
    product(dsp, Mp, nr, M, a.p_stT + (size_t)j * M * dsc, dsc, part, pout,
            dsc);
    if (kStack) {
      for (int i = tid; i < N * nr * ns; i += kThreads) {
        const int r = i / (N * ns), k = i % (N * ns);
        const int q = r * dsc + k / ns * Sc + k % ns;
        dh[q] = (dhp[q] + pout[q]) + dh[q];
      }
    } else {
      for (int i = tid; i < nr * ns; i += kThreads) {
        const int r = i / ns, c = i % ns;
        dh[r * Sc + c] = (dhp[r * Sc + c] + pout[r * Sc + c]) + dh[r * Sc + c];
      }
    }
    if (!kContent) {
      // the F bands' rows each padded to L4 (one band: L rows)
      const int kd = kMulti ? cl4 : L;
      product(dcv, cl4, nr, kd, a.p_toepT + (size_t)j * kd * Lq, Lq, part,
              pout, Lq);
      for (int i = tid; i < nr * nl; i += kThreads) {
        const int r = i / nl, l = i % nl;
        dw[r * Lq + l] = pout[r * Lq + l] * (inside(l0 + l) ? 1.f : 0.f)
                         + dw[r * Lq + l];
      }
    }
    __syncthreads();
  }
  // no block leaves while a peer may still read its shared memory
  cluster.sync();
  if (kStack) {
    for (int i = tid; i < N * nr * ns; i += kThreads) {
      const int r = i / (N * ns), ly = i % (N * ns) / ns, c = i % ns;
      a.dh0[(size_t)(b0 + r) * NS + ly * S + s0 + c] =
          dh[r * dsc + ly * Sc + c];
    }
  } else {
    for (int i = tid; i < nr * ns; i += kThreads) {
      const int r = i / ns, c = i % ns;
      a.dh0[(size_t)(b0 + r) * S + s0 + c] = dh[r * Sc + c];
    }
  }
  for (int i = tid; i < nr * nd; i += kThreads) {
    const int r = i / nd, c = i % nd;
    a.dwa0[(size_t)(b0 + r) * D + e0 + c] = dwa[r * Dc + c];
  }
  for (int i = tid; i < nr * M; i += kThreads) {
    const int r = i / M, m = i % M;
    float sv = dvg[r * M4 + m], sh = kMulti ? 0.f : dhg[r * M4 + m];
    for (int g = 1; g < d.groups; ++g) {
      sv += dvg[(g * R + r) * M4 + m];
      if (!kMulti) sh += dhg[(g * R + r) * M4 + m];
    }
    const size_t at = ((size_t)(b0 + r) * C + j) * M + m;
    a.dv[kNorm != 0 ? at + (b0 + r) * C + j : at] = sv;
    if (!kContent && !kMulti) a.dhand[at] = sh;
  }
  // more filters: the block's handler gradient, over its rows and steps
  for (int i = tid; kMulti && i < nf * M; i += kThreads) {
    const int f = i / M, m = i % M;
    float sh = dhg[f * d.groups * M4 + m];
    for (int g = 1; g < d.groups; ++g) sh += dhg[(f * d.groups + g) * M4 + m];
    a.dhand[(size_t)blockIdx.x * nf * M + i] = sh;
  }
  // the bias's gradient: the (row, block)'s sum over its steps, in the
  // last column of its dv row
  for (int r = tid; kNorm != 0 && r < nr; r += kThreads)
    a.dv[((size_t)(b0 + r) * C + j) * (M + 1) + M] = rs[r * 8 + 4];
  for (int i = tid; i < min(rd, nr) * nl * M; i += kThreads) {
    const int r = i / (nl * M), l = (i / M) % nl, m = i % M;
    a.dpre[((size_t)(b0 + r) * L + l0 + l) * M + m] =
        sm[o.dpre + (r * Lt + l) * d.Mt + m];
  }
}

template <int kConv>
const void* kernel_by_norm(int kind, int normalizer) {
  switch (normalizer) {
    case 0:
      return kind == 0 ? (const void*)decoder_fwd_kernel<kConv, 0>
                       : (const void*)decoder_bwd_kernel<kConv, 0>;
    case 1:
      return kind == 0 ? (const void*)decoder_fwd_kernel<kConv, 1>
                       : (const void*)decoder_bwd_kernel<kConv, 1>;
    case 2:
      return kind == 0 ? (const void*)decoder_fwd_kernel<kConv, 2>
                       : (const void*)decoder_bwd_kernel<kConv, 2>;
    default:
      return nullptr;
  }
}

// The conv filters a struct asks for: 0 for the content branch, else
// n_filters (0 read as 1).
int filters(const DecoderArgs& a) {
  return a.content ? 0 : max(a.n_filters, 1);
}

// The kernel of a kind (0 forward, 1 backward) and a variant: the content
// branch (softmax), or the conv branch with one filter or more and
// normalizer 0, 1 or 2, or a stack of 2-4 layers with more filters and
// softmax; nullptr for a variant out of range.
const void* kernel_of(int kind, int nf, int normalizer, int N = 1) {
  if (N > 1)
    return N > 4 || nf < 2 || normalizer != 0
               ? nullptr
               : kind == 0 ? (const void*)decoder_fwd_kernel<2, 0, true>
                           : (const void*)decoder_bwd_kernel<2, 0, true>;
  if (nf == 0)
    return kind == 0 ? (const void*)decoder_fwd_kernel<0, 0>
                     : (const void*)decoder_bwd_kernel<0, 0>;
  return nf == 1 ? kernel_by_norm<1>(kind, normalizer)
                 : kernel_by_norm<2>(kind, normalizer);
}

int smem_bytes(int kind, const DecoderArgs& a) {
  const Dims d = dims(a.cluster, cdiv(a.B, a.clusters), a.L, a.M, a.D, a.S);
  return layout(kind, d, a.L, a.M, a.D, a.S, min(a.res_pre, d.R),
                min(a.res_att, d.R), kind == 1 ? min(a.res_dpre, d.R) : 0,
                filters(a), max(a.dec_stack, 1))
             .total
         * (int)sizeof(float);
}

cudaError_t set_attributes(const void* kernel, int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

int max_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

bool plan_valid(const DecoderArgs& a) {
  return (a.cluster == 4 || a.cluster == 8 || a.cluster == 16)
         && a.clusters >= 1 && a.clusters <= a.B
         && cdiv(a.B, a.clusters) <= kMaxRows && a.res_pre >= 0
         && a.res_att >= 0 && a.res_dpre >= 0;
}

// -1 when the plan is not covered (its layout exceeds a block's shared
// memory, or, forward, its clusters cannot all be co-resident), else a CUDA
// error code (0: launched).
int launch(int kind, const DecoderArgs* args, cudaStream_t stream) {
  if (!plan_valid(*args)) return -1;
  const int smem = smem_bytes(kind, *args);
  int max_smem = 0;
  int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  if (smem > max_smem) return -1;
  const void* kernel = kernel_of(kind, filters(*args), args->normalizer,
                                 max(args->dec_stack, 1));
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_attributes(kernel, args->cluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args->clusters * args->cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // the forward's grid barrier needs every block resident at once
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kind == 0 ? 2 : 1;
  void* params[] = {const_cast<DecoderArgs*>(args)};
  e = cudaLaunchKernelExC(&cfg, kernel, params);
  if (e == cudaErrorCooperativeLaunchTooLarge) {
    cudaGetLastError();
    return -1;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The layout's dynamic shared memory in bytes (kind 0 forward, 1
// backward) for the plan in *args (cluster, clusters, res_pre, res_att,
// res_dpre).
extern "C" int decoder_train_smem_bytes(int kind, const DecoderArgs* args) {
  return smem_bytes(kind, *args);
}

// How many `cluster`-block clusters of the kernel (kind 0 forward, 1
// backward; n_filters 0 the content branch, 1 the conv branch with one
// filter, more the conv branch with more filters; dec_stack above 1 a
// stack's instance) the current device holds at once at the most shared
// memory a block may take, into *count; a CUDA error code.
extern "C" int decoder_train_max_clusters(int kind, int n_filters,
                                          int dec_stack, int cluster,
                                          int* count) {
  int smem = 0;
  int err = max_smem_optin(&smem);
  if (err != 0) return err;
  // every variant of a kind takes the same shared memory and block, so
  // the softmax instance of a branch stands for its three normalizers
  const void* kernel = kernel_of(kind, n_filters, 0, dec_stack);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_attributes(kernel, cluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

extern "C" int decoder_train_fwd_f32(const DecoderArgs* args, void* stream) {
  return launch(0, args, (cudaStream_t)stream);
}

extern "C" int decoder_train_bwd_f32(const DecoderArgs* args, void* stream) {
  return launch(1, args, (cudaStream_t)stream);
}
