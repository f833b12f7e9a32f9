// Backward GRU scan of the training path: the whole reverse-time recurrence
// in one launch, for one direction or both directions of a bidirectional
// layer at once.
//
// Replaces the backward kernels of attention_lvcsr_tpu/ops/pallas/
// gru_train.py (_bwd_kernel, _bwd_kernel_bd; gru_scan_train :291 and
// gru_scan_train_bidir :570).  The forward of those functions is
// gru_scan.cu's kernel with its residual outputs set (update gate u, reset
// gate r and candidate c of every step).  Per step, walking the forward's
// steps backwards, per batch row and column:
//
//   dh     = dh_carry + dstates[t]
//   draw   = dh * m,            dh_prev = dh * (1 - m)     (m = mask[t, b])
//   du     = draw * (c - h_prev)
//   da     = draw * u * (1 - c^2)                 -> dx_in[t]
//   dh_prev += draw * (1 - u)
//   dhr    = da @ w_state^T;    dh_prev += dhr * r
//   dg     = [du, dhr * h_prev] * [u, r] * (1 - [u, r])   -> dx_gate[t]
//   dh_prev += dg @ w_gates^T;  dh_carry = dh_prev          -> dh0 at the end
//
// with h_prev the state before the step (h0 first).  The weight gradients
// dW_state = sum (h_prev * r)^T da and dW_gates = sum h_prev^T dg are not
// formed here: ops/gru_train.py reduces the dx_in and dx_gate rows this
// kernel writes with outer_sum.cu after it, off the recurrence's chain.
//
// What bounds it on the card: latency, as in the forward: two dependent
// products per step (D x D, then 2D x D) over 16 batch rows.  The design
// is the forward's (gru_cluster.cuh): an 8-block cluster serves 16 rows of
// one direction, block j owns state columns [j*n, (j+1)*n) and keeps the
// rows of w_state and w_gates that produce them, transposed (3*D*n floats,
// 96 KB at D=250), in shared memory for the whole scan; the carried state
// gradient of its columns stays in registers.  Per step a block computes
// its columns' da and broadcasts it into every block of the cluster
// (distributed shared memory), meets them at a cluster barrier, computes
// its columns of dhr and dg and broadcasts dg, meets them again, and
// finishes its columns of dh_prev.  Widths whose weight slices and gradient
// buffers do not fit in a block's shared memory (D above about 310) are not
// covered: gru_train_supported() says so before a launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gru_cluster.cuh"

// Must match the ctypes.Structures in ops/gru_train.py field for field.
struct GruBwdDir {
  const float* dout;     // dstates (t, b, c) at dout[(t * B + b) * ld_dout + c]
  const float* states;   // forward states at states[(t*B + b) * ld_states + c]
  const float* h0;       // (B, D)
  const float* u;        // residuals (T, B, D): update gate, reset gate,
  const float* r;        //   candidate
  const float* c;
  const float* w_state;  // (D, D)
  const float* w_gates;  // (D, 2D)
  float* dx;             // dx_in (t, b, c) at dx[(t * B + b) * ld_dproj + c]
  float* dg;             // dx_gate (t, b, c < 2D), same row stride
  float* dh0;            // (B, D)
  int reverse;           // the forward visited t = T-1 .. 0
};

struct GruBwdArgs {
  GruBwdDir dir[2];
  const float* mask;     // (T, B) or null
  int T, B, D, ld_dout, ld_states, ld_dproj;
};

namespace {

struct BwdLayout {
  int n, ws, wg, da, dg, part, total;   // offsets in floats
};

// da, dg and part start on 16-byte boundaries (float4 loads)
__host__ __device__ inline BwdLayout bwd_layout(int D) {
  BwdLayout o;
  o.n = (D + kCluster - 1) / kCluster;
  o.ws = 0;                                   // (D, n): w_state[c0 + c][k]
  o.wg = o.ws + D * o.n;                      // (2D, n): w_gates[c0 + c][k]
  o.da = (o.wg + 2 * D * o.n + 3) / 4 * 4;    // (D, kGroupRows)
  o.dg = o.da + D * kGroupRows;               // (2D, kGroupRows)
  o.part = o.dg + 2 * D * kGroupRows;
  o.total = o.part + kPartFloats;
  return o;
}

__host__ inline bool bwd_fits(int D, int max_smem) {
  const BwdLayout o = bwd_layout(D);
  return (kGroupRows / kRowsPerThread) * o.n <= kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kClusterThreads, 1)
    gru_bwd_kernel(GruBwdArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const GruBwdDir d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D, D2 = 2 * a.D;
  const BwdLayout o = bwd_layout(D);
  const int n = o.n;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kCluster) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* wsT = smem + o.ws;
  float* wgT = smem + o.wg;
  float* daT = smem + o.da;
  float* dgT = smem + o.dg;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int slices_a = cluster_slices(n, D), slices_g = cluster_slices(n, D2);

  // the owned rows of both matrices, transposed (zero past D)
  for (int i = tid; i < D * n; i += blockDim.x) {
    const int k = i / n, c = c0 + i % n;
    wsT[i] = c < D ? d.w_state[(size_t)c * D + k] : 0.f;
  }
  for (int i = tid; i < D2 * n; i += blockDim.x) {
    const int k = i / n, c = c0 + i % n;
    wgT[i] = c < D ? d.w_gates[(size_t)c * D2 + k] : 0.f;
  }
  for (int i = tid; i < 3 * D * kGroupRows; i += blockDim.x) daT[i] = 0.f;
  cluster.sync();

  // items tid + e * blockDim: (row, owned column) pairs this thread finishes
  constexpr int kItems = 2;
  float dh[kItems] = {0.f, 0.f};
  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? step : T - 1 - step;
    const int tp = d.reverse ? t + 1 : t - 1;      // the forward's step before
    const size_t row0 = (size_t)t * B + b0;
    float du[kItems], dhp[kItems], rg[kItems], hp[kItems], ug[kItems];
    // ---- elementwise: state, update and candidate gradients; broadcast da
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      du[e] = dhp[e] = rg[e] = hp[e] = ug[e] = 0.f;
      if (r >= nrows || c >= D) continue;
      const size_t idx = (row0 + r) * D + c;
      const float m = a.mask != nullptr ? a.mask[row0 + r] : 1.f;
      const float u = d.u[idx], cand = d.c[idx];
      const float h_prev =
          (tp < 0 || tp >= T)
              ? d.h0[(size_t)(b0 + r) * D + c]
              : d.states[((size_t)tp * B + b0 + r) * a.ld_states + c];
      const float g = dh[e] + d.dout[(row0 + r) * a.ld_dout + c];
      const float draw = g * m;
      float dprev = g * (1.f - m);
      du[e] = draw * (cand - h_prev);
      const float dcand = draw * u;
      dprev = dprev + draw * (1.f - u);
      const float da = dcand * (1.f - cand * cand);
      d.dx[(row0 + r) * a.ld_dproj + c] = da;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        cluster.map_shared_rank(daT, q)[c * kGroupRows + r] = da;
      dhp[e] = dprev;
      rg[e] = d.r[idx];
      hp[e] = h_prev;
      ug[e] = u;
    }
    // ---- wait for the cluster's da
    cluster.sync();
    // ---- reset path: da @ w_state^T; gate gradients; broadcast dg
    cluster_partials(daT, wsT, n, n, slices_a, D, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      if (r >= nrows || c >= D) continue;
      const float dhr = cluster_sum(part, slices_a, n, r, cc);
      dhp[e] = dhp[e] + dhr * rg[e];
      const float dr = dhr * hp[e];
      const float dgu = du[e] * ug[e] * (1.f - ug[e]);
      const float dgr = dr * rg[e] * (1.f - rg[e]);
      float* dg_row = d.dg + (row0 + r) * a.ld_dproj;
      dg_row[c] = dgu;
      dg_row[D + c] = dgr;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        float* remote = cluster.map_shared_rank(dgT, q);
        remote[c * kGroupRows + r] = dgu;
        remote[(D + c) * kGroupRows + r] = dgr;
      }
    }
    // ---- wait for the cluster's dg
    cluster.sync();
    // ---- gate path: dg @ w_gates^T finishes the owned state gradients
    cluster_partials(dgT, wgT, n, n, slices_g, D2, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      if (r >= nrows || c >= D) continue;
      dh[e] = dhp[e] + cluster_sum(part, slices_g, n, r, cc);
    }
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int item = tid + e * kClusterThreads;
    const int r = item / n, c = c0 + item % n;
    if (r < nrows && c < D) d.dh0[(size_t)(b0 + r) * D + c] = dh[e];
  }
  // no block may leave while another can still write into its shared memory
  cluster.sync();
}

}  // namespace

// Whether the kernel covers width D on the current device: 1 or 0, or a
// negative CUDA error code.
extern "C" int gru_train_supported(int D) {
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return bwd_fits(D, max_smem) && cluster_fits(D, max_smem) ? 1 : 0;
}

extern "C" int gru_train_bwd_f32(const GruBwdArgs* args, int ndir,
                                 void* stream) {
  const int supported = gru_train_supported(args->D);
  if (supported < 0) return -supported;
  if (supported == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bwd_layout(args->D).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args->B + kGroupRows - 1) / kGroupRows;
  const dim3 grid(groups * kCluster, ndir);
  gru_bwd_kernel<<<grid, kClusterThreads, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
