// What the module path's two decode kernels (attention_energy.cu and
// decode_score.cu) share: the energies' register tile, and (from
// dynamic_smem.cuh) the launch helper that lets a kernel take more than
// 48 KB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

#include "dynamic_smem.cuh"

namespace {

// A thread's tile of attention energies: RK rows x RL frames over the
// match columns [m0, m1), in order,
//   acc[i][j] += v[m] tanh((key[j][m] + state[i][m]) + conv[i][j] handler[m])
// with key[j] = p[j], state[i] = s[i] (both indexed by m), the handler
// and the energy vector in shared memory.  Each step's loads (RL keys, RK
// state values, handler, energy vector) feed RK * RL independent tanh
// chains, two steps in flight.  kLdgKeys reads the keys from global
// memory through the read-only path, else they are in shared memory.
template <int RK, int RL, bool kLdgKeys>
__device__ __forceinline__ void energy_tile(const float* (&p)[RL],
                                            const float* (&s)[RK],
                                            const float (&c)[RK][RL],
                                            const float* HAND,
                                            const float* VV, int m0, int m1,
                                            float (&acc)[RK][RL]) {
#pragma unroll 2
  for (int m = m0; m < m1; ++m) {
    const float h = HAND[m], v = VV[m];
    float pv[RL];
#pragma unroll
    for (int j = 0; j < RL; ++j) pv[j] = kLdgKeys ? __ldg(p[j] + m) : p[j][m];
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const float sv = s[i][m];
#pragma unroll
      for (int j = 0; j < RL; ++j)
        acc[i][j] = fmaf(v, tanhf((pv[j] + sv) + c[i][j] * h), acc[i][j]);
    }
  }
}

}  // namespace
