// One decode score step of every hypothesis, one block per utterance.
//
// Replaces attention_lvcsr_tpu/ops/pallas/decode_score.py::
// fused_decode_score for conv attention with one filter, the softmax
// normalizer, no states in the readout and a tanh post-merge layer (what
// SequenceGenerator.fused_score_supported admits).  Per utterance and its
// K rows it runs the phases of the Pallas body in its order: the prior's
// window (window_around_median with the TPU kernel's median rule
// max(0, #(cumsum < 0.5) - 1), or expanding at the row's step), the
// alignment convolution, the state projection, the energies, the masked
// softmax, the weighted average and the readout with log-softmax costs.
// Outputs: costs (U*K, V), the new weights and the windowed energies
// (U*K, L), the weighted averages (U*K, D).
//
// The Toeplitz band and the triangular matrix the TPU kernel multiplies
// by become the filter taps themselves and a warp prefix sum; the phases
// are the device functions of decode_step.cuh, which the whole-loop
// kernel (beam_loop.cu) runs too.
//
// What bounds it on the card: latency.  The step is a chain of dependent
// phases, each a small product over K rows, and a block streams about
// 0.9 MB of weight tables (state projection, merge, post-merge) plus its
// utterance's keys inside the window and encoder outputs.  The design
// keeps every per-row intermediate (weights, convolution, energies, state
// projection, weighted averages, activations) in shared memory and writes
// only the four outputs; each weight load serves all K rows.
#include <cuda_runtime.h>

#include "decode_step.cuh"

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
};

namespace {

constexpr int kThreads = 512;

struct ScoreLayout {
  int w, conv, e, sp, h, wa, act, costs, mask, taps, handler, v, begins, ends;
  int total;
};

__host__ __device__ inline ScoreLayout score_layout(const DecodeScoreArgs& a) {
  ScoreLayout o;
  const int K = a.K;
  int p = 0;
  o.w = p; p += K * a.L;
  o.conv = p; p += K * a.L;
  o.e = p; p += K * a.L;
  o.sp = p; p += K * a.M;
  o.h = p; p += K * a.S;
  o.wa = p; p += K * a.D;
  o.act = p; p += K * a.R;
  o.costs = p; p += K * a.V;
  o.mask = p; p += a.L;
  o.taps = p; p += a.n_taps;
  o.handler = p; p += a.M;
  o.v = p; p += a.M;
  o.begins = p; p += K;
  o.ends = p; p += K;
  o.total = p;
  return o;
}

template <int RB>
__global__ void __launch_bounds__(kThreads, 1)
decode_score_kernel(DecodeScoreArgs a) {
  extern __shared__ float sm[];
  const ScoreLayout o = score_layout(a);
  const int u = blockIdx.x;
  const int K = a.K, L = a.L, M = a.M, D = a.D, S = a.S, R = a.R, V = a.V;
  const int tid = threadIdx.x;
  float* W = sm + o.w;
  float* CONV = sm + o.conv;
  float* E = sm + o.e;
  float* SP = sm + o.sp;
  float* H = sm + o.h;
  float* WA = sm + o.wa;
  float* ACT = sm + o.act;
  float* COSTS = sm + o.costs;
  float* MASK = sm + o.mask;
  float* TAPS = sm + o.taps;
  float* HAND = sm + o.handler;
  float* VV = sm + o.v;
  float* BEGINS = sm + o.begins;
  float* ENDS = sm + o.ends;
  const size_t row0 = (size_t)u * K;   // first hypothesis row
  const float* pre = a.pre + (size_t)u * L * M;
  const float* att = a.attended + (size_t)u * L * D;

  // ---- load the rows and the small tables --------------------------
  for (int i = tid; i < K * L; i += blockDim.x)
    W[i] = a.weights[row0 * L + i];
  for (int i = tid; i < K * S; i += blockDim.x)
    H[i] = a.states[row0 * S + i];
  for (int l = tid; l < L; l += blockDim.x)
    MASK[l] = a.att_mask[(size_t)u * L + l];
  for (int j = tid; j < a.n_taps; j += blockDim.x) TAPS[j] = a.conv_taps[j];
  for (int m = tid; m < M; m += blockDim.x) {
    HAND[m] = a.handler[m];
    VV[m] = a.v[m];
  }
  __syncthreads();

  // ---- window prior -------------------------------------------------
  int lb, le;
  if (a.prior_median) {
    median_bounds(W, K, L, a.before, a.after, false, BEGINS, ENDS);
    union_window(BEGINS, ENDS, K, L, lb, le);
  } else {
    expanding_window(a.step[row0], L, a.initial_begin, a.initial_end,
                     a.min_speed, a.max_speed, lb, le);
  }

  // ---- convolution and state projection ------------------------------
  window_conv(W, TAPS, a.n_taps, K, L, lb, le, CONV);
  rows_matvec<RB>(H, S, K, S, a.state_trans, M, nullptr, SP, M, false);
  __syncthreads();

  // ---- energies inside the window ------------------------------------
  window_energies(pre, M, CONV, SP, HAND, VV, K, L, lb, le, E);
  __syncthreads();
  for (int i = tid; i < K * L; i += blockDim.x) {
    const int l = i % L;
    a.energies[row0 * L + i] = (l >= lb && l < le) ? E[i] : 0.f;
  }
  __syncthreads();

  // ---- masked softmax ------------------------------------------------
  window_softmax(E, MASK, BEGINS, ENDS, a.prior_median, K, L, lb, le);
  __syncthreads();
  for (int i = tid; i < K * L; i += blockDim.x) a.wnew[row0 * L + i] = E[i];

  // ---- weighted average ------------------------------------------------
  rows_matvec<RB>(E + lb, L, K, le - lb, att + (size_t)lb * D, D, nullptr, WA,
                  D, false);
  __syncthreads();
  for (int i = tid; i < K * D; i += blockDim.x) a.wa[row0 * D + i] = WA[i];

  // ---- readout and costs ---------------------------------------------
  readout_costs<RB>(WA, D, H, S, K, a.merge_k, a.merge_b, nullptr, a.post_k,
                    a.post_b, R, V, nullptr, ACT, COSTS);
  __syncthreads();
  for (int i = tid; i < K * V; i += blockDim.x)
    a.costs[row0 * V + i] = COSTS[i];
}

}  // namespace

extern "C" int decode_score_smem_bytes(const DecodeScoreArgs* args) {
  return score_layout(*args).total * (int)sizeof(float);
}

extern "C" int decode_score_f32(const DecodeScoreArgs* args, void* stream) {
  const int smem = score_layout(*args).total * (int)sizeof(float);
  void (*kernel)(DecodeScoreArgs) =
      args->K <= 4 ? decode_score_kernel<4>
      : args->K <= 8 ? decode_score_kernel<8>
      : args->K <= 10 ? decode_score_kernel<10> : decode_score_kernel<16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<args->U, kThreads, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
