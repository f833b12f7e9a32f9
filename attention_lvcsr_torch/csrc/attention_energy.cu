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
// same here: one block per (utterance, tile of kTile frames) copies its
// keys into shared memory once (contiguous, coalesced) and loops over the K
// rows; a warp takes one frame at a time, its lanes own match columns and
// keep the frame's keys, handler and energy vector in registers across the
// K rows, and the sum over M is a warp shuffle reduction.  The whole tile
// of L=200, M=250 would be 200 KB, hence the frame tiles; they also give
// U * ceil(L / kTile) blocks (832 at U=64, L=200) to fill the 132 SMs.
//
// What bounds it on the card: the accurate tanhf of every (row, frame,
// column), U*K*L*M of them (32M at the flagship shape); the keys are read
// from device memory once.  The state rows (K x M per utterance) are read
// through the read-only cache, where the block's frames hit them again.
#include <cuda_runtime.h>

#include "decode_step.cuh"

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
};

namespace {

constexpr int kEnergyThreads = 256;
constexpr int kTile = 16;            // frames per block

__global__ void __launch_bounds__(kEnergyThreads)
attention_energy_kernel(AttentionEnergyArgs a) {
  extern __shared__ float sm[];
  const int M = a.M, L = a.L, K = a.K;
  const int u = blockIdx.y, l0 = blockIdx.x * kTile;
  const int nl = min(kTile, L - l0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* PRE = sm;                     // nl x M
  float* HAND = sm + kTile * M;
  float* VV = HAND + M;

  const float* src = a.pre + ((size_t)u * L + l0) * M;
  for (int i = threadIdx.x; i < nl * M; i += blockDim.x) PRE[i] = src[i];
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    HAND[m] = a.handler[m];
    VV[m] = a.v[m];
  }
  __syncthreads();

  for (int t = warp; t < nl; t += nwarps) {
    const int l = l0 + t;
    for (int m0 = 0; m0 < M; m0 += 32 * kMq) {
      float pv[kMq], hv[kMq], vv[kMq];
#pragma unroll
      for (int q = 0; q < kMq; ++q) {
        const int m = m0 + lane + 32 * q;
        pv[q] = m < M ? PRE[t * M + m] : 0.f;
        hv[q] = m < M ? HAND[m] : 0.f;
        vv[q] = m < M ? VV[m] : 0.f;
      }
      for (int k = 0; k < K; ++k) {
        const size_t row = (size_t)u * K + k;
        const float c = __ldg(a.conv + row * L + l);
        const float* sp = a.state_sum + row * M;
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < kMq; ++q) {
          const int m = m0 + lane + 32 * q;
          if (m < M)
            part = fmaf(vv[q], tanhf((pv[q] + __ldg(sp + m)) + c * hv[q]),
                        part);
        }
        part = warp_sum(part);
        if (lane == 0) {
          float* o = a.out + row * L + l;
          *o = m0 == 0 ? part : *o + part;
        }
      }
    }
    if (lane == 0)
      for (int k = 0; k < K; ++k) {
        float* o = a.out + ((size_t)u * K + k) * L + l;
        *o = *o + a.bias;
      }
  }
}

}  // namespace

extern "C" int attention_energy_f32(const AttentionEnergyArgs* args,
                                    void* stream) {
  const int smem = (kTile + 2) * args->M * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args->L + kTile - 1) / kTile, args->U);
  attention_energy_kernel<<<grid, kEnergyThreads, smem,
                            (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
