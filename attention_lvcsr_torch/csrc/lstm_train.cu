// Backward peephole-LSTM scan of the training path: the whole reverse-time
// recurrence in one launch, for one direction or both directions of a
// bidirectional layer at once.
//
// Replaces the backward kernel of attention_lvcsr_tpu/ops/pallas/
// lstm_train.py (_bwd_kernel, _lstm_train_bwd; lstm_scan_train :374).  The
// forward of that function is lstm_scan.cu's kernel with its residual
// outputs set (the in, forget, cell and out gates of every step, as the
// TPU kernel stores them); the cell before each step is read from the
// forward's cells.  Per step, walking the forward's steps backwards, per
// batch row and column, with dh, dc the carried gradients:
//
//   dh += dstates[t];  dc += dcells[t]            (dcells may be absent)
//   a masked step (mask[t, b] == 0) passes dh and dc through unchanged;
//   otherwise, with c_prev the cell before the step and c' = f c_prev + i z:
//   da_o   = dh tanh(c') o (1 - o)
//   dc'    = dh o (1 - tanh(c')^2) + da_o pco + dc
//   da_f   = dc' c_prev f (1 - f),   da_i = dc' z i (1 - i)
//   da_z   = dc' i (1 - z^2)                         -> dx[t] = [da_i..da_o]
//   dc     = dc' f + da_f pcf + da_i pci
//   dh     = da @ w_state^T                          -> dh0, dc0 at the end
//
// The weight gradients are not formed here: dW_state = sum h_prev^T da is
// outer_sum.cu's reduction of the dx rows this kernel writes, after it.
// The peephole gradients (sums over T*B of da_i c_prev, da_f c_prev and
// da_o c') are summed over time per batch row in registers, in the fixed
// reverse-time order, and written as (B, 3D) rows that outer_sum.cu sums
// over B with a column of ones: no atomics, so every gradient repeats bit
// for bit.
//
// What bounds it on the card: latency, as in the forward: one dependent
// (16 x 4D) x (4D x D) product a step per cluster.  The design is the
// forward's (gru_cluster.cuh): an 8-block cluster serves 16 rows of one
// direction, block j owns state columns [j*n, (j+1)*n) and keeps the rows
// of w_state that produce them, transposed (4*D*n floats, 128 KB at
// D=250), in shared memory for the whole scan; the carried gradients of
// its columns stay in registers.  Per step a block computes its columns'
// four gate gradients and broadcasts them into every block of the cluster
// (distributed shared memory), meets them at a cluster barrier, computes
// its columns of da @ w_state^T, and meets them again before the next
// step's broadcast overwrites the buffer (a second buffer of 4D x 16
// floats would not fit beside the weights).  Widths whose weight slice and
// gradient buffer do not fit in a block's shared memory (D above about
// 275) are not covered: lstm_train_supported() says so before a launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gru_cluster.cuh"

// Must match the ctypes.Structures in ops/lstm_train.py field for field.
struct LstmBwdDir {
  const float* dh;       // dstates (t, b, c) at dh[(t * B + b) * ld_dout + c]
  const float* dc;       // dcells, same layout, or null
  const float* cs;       // forward cells at cs[(t * B + b) * ld_states + c]
  const float* c0;       // (B, D)
  const float* gi;       // residuals (T, B, D): in, forget, cell, out gates
  const float* gf;
  const float* gz;
  const float* go;
  const float* w_state;  // (D, 4D)
  const float* pci;      // (D,)
  const float* pcf;
  const float* pco;
  float* dx;             // (t, b, g*D + c) at dx[(t * B + b) * ld_dx + ...]
  float* dh0;            // (B, D)
  float* dc0;            // (B, D)
  float* dpeep;          // (B, 3D): per row, [sum da_i c_prev | sum da_f
                         //   c_prev | sum da_o c'] over the steps
  int reverse;           // the forward visited t = T-1 .. 0
};

struct LstmBwdArgs {
  LstmBwdDir dir[2];
  const float* mask;     // (T, B) or null
  int T, B, D, ld_dout, ld_states, ld_dx;
};

namespace {

struct BwdLayout {
  int n, wt, da, part, total;   // offsets in floats
};

// da and part start on 16-byte boundaries (float4 loads)
__host__ __device__ inline BwdLayout bwd_layout(int D) {
  BwdLayout o;
  o.n = (D + kCluster - 1) / kCluster;
  o.wt = 0;                                   // (4D, n): w_state[c0 + c][k]
  o.da = (4 * D * o.n + 3) / 4 * 4;           // (4D, kGroupRows)
  o.part = o.da + 4 * D * kGroupRows;
  o.total = o.part + kPartFloats;
  return o;
}

constexpr int kItems = 2;   // (row, owned column) pairs per thread

__host__ inline bool bwd_fits(int D, int max_smem) {
  const BwdLayout o = bwd_layout(D);
  return (kGroupRows / kRowsPerThread) * o.n <= kClusterThreads
         && kGroupRows * o.n <= kItems * kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

// The arguments stay in the constant bank (__grid_constant__) and the
// direction's pointers are read from there where they are used: a copy of
// the 16 pointers in registers spilled at the 128-register limit.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kClusterThreads, 1)
    lstm_bwd_kernel(const __grid_constant__ LstmBwdArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const LstmBwdDir& d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D, D4 = 4 * a.D;
  const BwdLayout o = bwd_layout(D);
  const int n = o.n;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kCluster) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* wt = smem + o.wt;
  float* daT = smem + o.da;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int slices = cluster_slices(n, D4);

  // the owned rows of w_state, transposed (zero past D)
  for (int i = tid; i < D4 * n; i += blockDim.x) {
    const int k = i / n, c = c0 + i % n;
    wt[i] = c < D ? d.w_state[(size_t)c * D4 + k] : 0.f;
  }
  for (int i = tid; i < D4 * kGroupRows; i += blockDim.x) daT[i] = 0.f;
  float dh[kItems], dc[kItems], pi[kItems], pf[kItems], po[kItems];
  float spi[kItems], spf[kItems], spo[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int item = tid + e * kClusterThreads;
    const int r = item / n, c = c0 + item % n;
    const bool ok = r < nrows && c < D;
    dh[e] = dc[e] = spi[e] = spf[e] = spo[e] = 0.f;
    pi[e] = ok ? d.pci[c] : 0.f;
    pf[e] = ok ? d.pcf[c] : 0.f;
    po[e] = ok ? d.pco[c] : 0.f;
  }
  cluster.sync();

  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? step : T - 1 - step;
    const int tp = d.reverse ? t + 1 : t - 1;      // the forward's step before
    const size_t row0 = (size_t)t * B + b0;
    float dh_keep[kItems];
    // ---- elementwise: cell and gate gradients; broadcast da
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      dh_keep[e] = 0.f;
      if (r >= nrows || c >= D) continue;
      const size_t idx = row0 + r;
      const float g_h = dh[e] + d.dh[idx * a.ld_dout + c];
      const float g_c =
          d.dc != nullptr ? dc[e] + d.dc[idx * a.ld_dout + c] : dc[e];
      float da_i = 0.f, da_f = 0.f, da_z = 0.f, da_o = 0.f;
      if (a.mask == nullptr || a.mask[idx] != 0.f) {
        const float cp =
            (tp < 0 || tp >= T)
                ? d.c0[(size_t)(b0 + r) * D + c]
                : d.cs[((size_t)tp * B + b0 + r) * a.ld_states + c];
        const size_t ridx = idx * D + c;
        const float ig = d.gi[ridx], fg = d.gf[ridx];
        const float zg = d.gz[ridx], og = d.go[ridx];
        const float cn = fg * cp + ig * zg;
        const float hc = tanhf(cn);
        da_o = g_h * hc * og * (1.f - og);
        const float dcn = g_h * og * (1.f - hc * hc) + da_o * po[e] + g_c;
        da_f = dcn * cp * fg * (1.f - fg);
        da_i = dcn * zg * ig * (1.f - ig);
        da_z = dcn * ig * (1.f - zg * zg);
        dc[e] = dcn * fg + da_f * pf[e] + da_i * pi[e];
        spi[e] += da_i * cp;
        spf[e] += da_f * cp;
        spo[e] += da_o * cn;
      } else {
        dh_keep[e] = g_h;
        dc[e] = g_c;
      }
      float* dx_row = d.dx + idx * a.ld_dx;
      dx_row[c] = da_i;
      dx_row[D + c] = da_f;
      dx_row[2 * D + c] = da_z;
      dx_row[3 * D + c] = da_o;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        float* remote = cluster.map_shared_rank(daT, q);
        remote[c * kGroupRows + r] = da_i;
        remote[(D + c) * kGroupRows + r] = da_f;
        remote[(2 * D + c) * kGroupRows + r] = da_z;
        remote[(3 * D + c) * kGroupRows + r] = da_o;
      }
    }
    // ---- wait for the cluster's da
    cluster.sync();
    // ---- state gradient of the owned columns: da @ w_state^T
    cluster_partials(daT, wt, n, n, slices, D4, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      if (r >= nrows || c >= D) continue;
      dh[e] = dh_keep[e] + cluster_sum(part, slices, n, r, cc);
    }
    // ---- every block has read da before the next step overwrites it
    cluster.sync();
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int item = tid + e * kClusterThreads;
    const int r = item / n, c = c0 + item % n;
    if (r >= nrows || c >= D) continue;
    const size_t row = (size_t)(b0 + r);
    d.dh0[row * D + c] = dh[e];
    d.dc0[row * D + c] = dc[e];
    d.dpeep[row * 3 * D + c] = spi[e];
    d.dpeep[row * 3 * D + D + c] = spf[e];
    d.dpeep[row * 3 * D + 2 * D + c] = spo[e];
  }
}

}  // namespace

// Whether the backward kernel covers width D on the current device: 1 or
// 0, or a negative CUDA error code.
extern "C" int lstm_train_supported(int D) {
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return bwd_fits(D, max_smem) ? 1 : 0;
}

extern "C" int lstm_train_bwd_f32(const LstmBwdArgs* args, int ndir,
                                  void* stream) {
  const int supported = lstm_train_supported(args->D);
  if (supported < 0) return -supported;
  if (supported == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bwd_layout(args->D).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args->B + kGroupRows - 1) / kGroupRows;
  const dim3 grid(groups * kCluster, ndir);
  lstm_bwd_kernel<<<grid, kClusterThreads, smem, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
