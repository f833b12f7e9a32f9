// Attention energies of every beam hypothesis over its utterance's frames.
//
// Replaces attention_lvcsr_tpu/ops/pallas/attention_energy.py::
// beam_attention_energies (the energy step of the module-driven decode,
// which every LM-fused decode runs):
//
//   out[u*K + k, l] = v . tanh(pre[u, l] + state_sum[u*K + k]
//                              + conv[u*K + k, l] * handler) + bias
//
// The TPU kernel loads each utterance's (L, M) key tile once and reuses it
// for the K hypotheses, so the (U*K, L, M) match tensor never exists.  The
// same here: a block takes one utterance and a tile of `tile` frames, and
// stages with cp.async the tile's keys, the utterance's K state rows, the
// handler and the energy vector in shared memory (rows padded to an odd
// stride, so that the lanes' rows fall in different banks).  A thread owns
// a register tile of RK rows x 2 frames over one of `slices` slices of
// the M match columns, and walks its slice in order: each step's shared
// loads (two keys, RK state values, handler, energy vector) feed 2 * RK
// independent tanh chains.  The slices' partial sums meet in shared memory
// and are added in slice order, the bias in a register, and each output
// is written once, coalesced.  No atomics and no shuffle tree: a second
// call repeats the bits.
//
// What bounds it on the card: instruction issue.  Every (row, frame,
// column) costs an accurate tanhf (18 SASS instructions, 2 of them MUFU)
// and four operations around it; the loop issues 22 instructions an
// element (tools/torch_tanh_floor.py counts them), 32M elements at the
// flagship shape: 0.021 ms of issue on 132 SMs, five times the byte
// bound.  The keys are read from device memory once.  The frame tile
// (ops/attention_energy.py::plan) is chosen so that the blocks spread over
// the SMs in balanced waves.
#include <cuda_runtime.h>

#include "energy_tile.cuh"
#include "sm90_async.cuh"

// Must match the ctypes.Structure in ops/attention_energy.py.
struct AttentionEnergyArgs {
  const float* pre;        // (U, L, M)
  const float* state_sum;  // (U*K, M)
  const float* conv;       // (U*K, L)
  const float* handler;    // (M,)
  const float* v;          // (M,)
  float* out;              // (U*K, L)
  float bias;
  int U, K, L, M;
  int tile, slices;        // frames a block, M slices (the launch plan)
};

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;        // registers: up to 64 a thread
constexpr int kRL = 2;               // frames a thread

// odd row stride of the staged rows
__host__ __device__ inline int padded(int M) { return M | 1; }

__host__ __device__ inline int row_groups(int K, int RK) {
  return (K + RK - 1) / RK;
}

// floats of shared memory: keys, state rows, handler, energy vector,
// the slices' partial sums
__host__ __device__ inline int energy_smem_floats(const AttentionEnergyArgs& a) {
  const int Mp = padded(a.M);
  return (a.tile + a.K + 2) * Mp + a.slices * a.K * a.tile;
}

template <int RK>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
attention_energy_kernel(AttentionEnergyArgs a) {
  extern __shared__ float sm[];
  const int M = a.M, L = a.L, K = a.K, TL = a.tile, MS = a.slices;
  const int Mp = padded(M);
  const int u = blockIdx.y, l0 = blockIdx.x * TL;
  const int nl = min(TL, L - l0);
  float* PRE = sm;                       // TL x Mp
  float* SP = PRE + TL * Mp;             // K x Mp
  float* HAND = SP + K * Mp;             // Mp
  float* VV = HAND + Mp;                 // Mp
  float* RED = VV + Mp;                  // MS x K x TL

  // ---- stage the keys, state rows, handler and energy vector ----------
  // a warp a row: rows nl keys, then K state rows, then the two vectors
  {
    const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const float* pre = a.pre + ((size_t)u * L + l0) * M;
    const float* sp = a.state_sum + (size_t)u * K * M;
    for (int r = threadIdx.x >> 5; r < nl + K + 2; r += nwarps) {
      const float* src = r < nl ? pre + (size_t)r * M
                         : r < nl + K ? sp + (size_t)(r - nl) * M
                         : r == nl + K ? a.handler : a.v;
      float* dst = r < nl ? PRE + r * Mp : SP + (r - nl) * Mp;
      for (int m = lane; m < M; m += 32) cp_async<4>(dst + m, src + m, 4);
    }
  }
  cp_async_commit();

  // ---- this thread's tile: RK rows x RL frames over one M slice -------
  constexpr int RL = kRL;
  const int RG = row_groups(K, RK), FG = (nl + RL - 1) / RL;
  const int tiles = RG * FG;
  const int item = threadIdx.x;
  const bool active = item < tiles * MS;
  const int tile = item % tiles, slice = item / tiles;
  const int rg = tile % RG, fg = tile / RG;
  int rows[RK], frames[RL];
#pragma unroll
  for (int i = 0; i < RK; ++i) rows[i] = min(rg * RK + i, K - 1);
#pragma unroll
  for (int j = 0; j < RL; ++j) frames[j] = min(fg * RL + j, nl - 1);
  float c[RK][RL];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const float* cr = a.conv + ((size_t)u * K + rows[i]) * L + l0;
#pragma unroll
    for (int j = 0; j < RL; ++j) c[i][j] = active ? __ldg(cr + frames[j]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  if (active) {
    const int m0 = (int)((long long)slice * M / MS);
    const int m1 = (int)((long long)(slice + 1) * M / MS);
    const float* p[RL];
    const float* s[RK];
#pragma unroll
    for (int j = 0; j < RL; ++j) p[j] = PRE + frames[j] * Mp;
#pragma unroll
    for (int i = 0; i < RK; ++i) s[i] = SP + rows[i] * Mp;
    float acc[RK][RL];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RL; ++j) acc[i][j] = 0.f;
    energy_tile<RK, RL, false>(p, s, c, HAND, VV, m0, m1, acc);
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int r = rg * RK + i;
#pragma unroll
      for (int j = 0; j < RL; ++j)
        if (r < K && fg * RL + j < nl)
          RED[(slice * K + r) * TL + fg * RL + j] = acc[i][j];
    }
  }
  __syncthreads();

  // ---- the slices' sums in slice order, the bias, one coalesced write --
  for (int o = threadIdx.x; o < K * nl; o += blockDim.x) {
    const int r = o / nl, f = o % nl;
    float e = RED[r * TL + f];
    for (int q = 1; q < MS; ++q) e += RED[(q * K + r) * TL + f];
    a.out[((size_t)u * K + r) * L + l0 + f] = e + a.bias;
  }
}

SmemAllowance g_allowed[2];          // an instance's, by RK - 1

template <int RK>
int launch(const AttentionEnergyArgs& a, cudaStream_t stream) {
  const int smem = energy_smem_floats(a) * (int)sizeof(float);
  const cudaError_t err =
      allow_dynamic_smem(attention_energy_kernel<RK>, g_allowed[RK - 1], smem);
  if (err != cudaSuccess) return (int)err;
  const int FG = (min(a.tile, a.L) + kRL - 1) / kRL;
  const int items = row_groups(a.K, RK) * FG * a.slices;
  const int threads = (items + 31) / 32 * 32;
  const dim3 grid((a.L + a.tile - 1) / a.tile, a.U);
  attention_energy_kernel<RK><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// cudaErrorInvalidValue when the plan's block exceeds kMaxThreads
extern "C" int attention_energy_f32(const AttentionEnergyArgs* args,
                                    void* stream) {
  const AttentionEnergyArgs& a = *args;
  const int RK = a.K == 1 ? 1 : 2;
  const int FG = (min(a.tile, a.L) + kRL - 1) / kRL;
  if (a.tile < 1 || a.slices < 1
      || row_groups(a.K, RK) * FG * a.slices > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  return RK == 1 ? launch<1>(a, (cudaStream_t)stream)
                 : launch<2>(a, (cudaStream_t)stream);
}
