// Forward peephole-LSTM scan over time: the whole recurrence in one launch,
// for one direction or for both directions of a bidirectional layer at
// once.
//
// Replaces attention_lvcsr_tpu/ops/pallas/lstm_train.py::lstm_scan (the
// forward-only kernel of the LSTM encoder's inference path) and the
// forward kernel of lstm_scan_train (_lstm_train_fwd), which is this kernel
// with its residual outputs set.  Per time step t and batch row b, with the
// blocks' gate order [in, forget, cell, out] along the 4D columns:
//
//   a  = h @ w_state + x_proj[t, b]
//   i  = sigmoid(a_i + c * pci),   f = sigmoid(a_f + c * pcf)
//   z  = tanh(a_z),                c' = f * c + i * z
//   o  = sigmoid(a_o + c' * pco),  h' = o * tanh(c')
//
// A masked step (mask[t, b] == 0) keeps h and c, by selection, so a NaN in
// a padded row cannot reach the carried state.  A direction marked reverse
// visits t = T-1 .. 0: the JAX package's backward direction (flip inputs
// and mask, scan, flip back) without the flips.  The input projections are
// one large product outside the kernel (torch.matmul), as the JAX package
// leaves them to XLA; they are read through a row stride, so both
// directions' projections can come from one matmul.
//
// What bounds it on the card: latency.  A step is one dependent (16 x D) x
// (D x 4D) product per cluster and a few elementwise operations; only a
// few clusters have work.  The design is gru_cluster.cuh's: an 8-block
// cluster serves 16 batch rows of one direction, block j owns state
// columns [j*n, (j+1)*n) and keeps the 4n columns of w_state that produce
// their four gates (128 KB at D=250) in shared memory for the whole scan;
// the cells of its columns stay in registers.  The LSTM has one product a
// step where the GRU has two, so it needs one cluster barrier a step: the
// state is double-buffered (step s reads buffer s % 2 and broadcasts the
// new state into the other), and a block can only write a buffer again
// after every block has passed the barrier that ends the step reading it.
// Widths whose weight slice and two state buffers do not fit in a block's
// shared memory (D above about 300) are not covered: lstm_scan_supported()
// says so before a launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gru_cluster.cuh"

// Must match the ctypes.Structures in ops/lstm_scan.py field for field.
struct LstmDir {
  const float* x;        // x_proj: (t, b, g*D + c) at x[(t * B + b) * ldx + ...]
  const float* h0;       // (B, D)
  const float* c0;       // (B, D)
  const float* w_state;  // (D, 4D)
  const float* pci;      // (D,) peepholes: in, forget, out
  const float* pcf;
  const float* pco;
  float* hs;             // states (t, b, c) at hs[(t * B + b) * ldo + c]
  float* cs;             // cells, same layout
  float* gi;             // residuals for training, (T, B, D) each, or null:
  float* gf;             //   the in, forget, cell and out gates
  float* gz;
  float* go;
  int reverse;           // visit t = T-1 .. 0
};

struct LstmArgs {
  LstmDir dir[2];
  const float* mask;     // (T, B) or null
  int T, B, D, ldx, ldo;
};

namespace {

struct LstmLayout {
  int n, w, h, part, total;   // offsets in floats
};

// h and part start on 16-byte boundaries (float4 loads)
__host__ __device__ inline LstmLayout lstm_layout(int D) {
  LstmLayout o;
  o.n = (D + kCluster - 1) / kCluster;
  o.w = 0;                                    // (D, 4n) own gate columns
  o.h = (D * 4 * o.n + 3) / 4 * 4;            // 2 x (D, kGroupRows) state
  o.part = o.h + 2 * D * kGroupRows;
  // one slice of 16 rows x 4n columns when 4n exceeds a pass of threads
  const int part = kGroupRows * 4 * o.n;
  o.total = o.part + (part > kPartFloats ? part : kPartFloats);
  return o;
}

constexpr int kItems = 2;   // (row, owned column) pairs per thread

__host__ inline bool lstm_fits(int D, int max_smem) {
  const LstmLayout o = lstm_layout(D);
  return kGroupRows * o.n <= kItems * kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kClusterThreads, 1)
    lstm_scan_kernel(LstmArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const LstmDir d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D, D4 = 4 * a.D;
  const LstmLayout o = lstm_layout(D);
  const int n = o.n, n4 = 4 * o.n;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kCluster) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* w = smem + o.w;
  float* hT = smem + o.h;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int slices = cluster_slices(n4, D);

  // gate column cc of the block: gate cc / n of state column c0 + cc % n
  for (int i = tid; i < D * n4; i += blockDim.x) {
    const int k = i / n4, cc = i % n4, c = c0 + cc % n;
    w[i] = c < D ? d.w_state[(size_t)k * D4 + (cc / n) * D + c] : 0.f;
  }
  for (int i = tid; i < D * kGroupRows; i += blockDim.x) {
    const int k = i / kGroupRows, r = i % kGroupRows;
    hT[i] = r < nrows ? d.h0[(size_t)(b0 + r) * D + k] : 0.f;
    hT[D * kGroupRows + i] = 0.f;
  }
  // items tid + e * blockDim: (row, owned column) pairs this thread
  // finishes; their cells and peepholes stay in registers
  float cell[kItems], pi[kItems], pf[kItems], po[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int item = tid + e * kClusterThreads;
    const int r = item / n, c = c0 + item % n;
    const bool ok = r < nrows && c < D;
    cell[e] = ok ? d.c0[(size_t)(b0 + r) * D + c] : 0.f;
    pi[e] = ok ? d.pci[c] : 0.f;
    pf[e] = ok ? d.pcf[c] : 0.f;
    po[e] = ok ? d.pco[c] : 0.f;
  }
  cluster.sync();

  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
    const float* hcur = hT + (step & 1) * D * kGroupRows;
    float* hnext = hT + ((step & 1) ^ 1) * D * kGroupRows;
    // this step's input projections and mask, loaded ahead of the product
    float xin[kItems][4];
    bool keep[kItems];
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      const bool ok = r < nrows && c < D;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xin[e][g] = ok ? d.x[(row0 + r) * a.ldx + g * D + c] : 0.f;
      keep[e] = !ok || a.mask == nullptr || a.mask[row0 + r] != 0.f;
    }
    // ---- gate pre-activations of the owned columns: h @ w_state
    cluster_partials(hcur, w, n4, n4, slices, D, part);
    __syncthreads();
    // ---- cell and state update; broadcast the new state
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      if (r >= nrows || c >= D) continue;
      const float a_i = cluster_sum(part, slices, n4, r, cc) + xin[e][0];
      const float a_f = cluster_sum(part, slices, n4, r, n + cc) + xin[e][1];
      const float a_z = cluster_sum(part, slices, n4, r, 2 * n + cc)
                        + xin[e][2];
      const float a_o = cluster_sum(part, slices, n4, r, 3 * n + cc)
                        + xin[e][3];
      const float cp = cell[e];
      const float ig = sigmoidf(a_i + cp * pi[e]);
      const float fg = sigmoidf(a_f + cp * pf[e]);
      const float zg = tanhf(a_z);
      const float cn = fg * cp + ig * zg;
      const float og = sigmoidf(a_o + cn * po[e]);
      const float hn = og * tanhf(cn);
      const float h_out = keep[e] ? hn : hcur[c * kGroupRows + r];
      const float c_out = keep[e] ? cn : cp;
      cell[e] = c_out;
      const size_t idx = row0 + r;
      d.hs[idx * a.ldo + c] = h_out;
      d.cs[idx * a.ldo + c] = c_out;
      if (d.gi != nullptr) {
        const size_t ridx = idx * D + c;
        d.gi[ridx] = ig;
        d.gf[ridx] = fg;
        d.gz[ridx] = zg;
        d.go[ridx] = og;
      }
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        cluster.map_shared_rank(hnext, q)[c * kGroupRows + r] = h_out;
    }
    // ---- wait for the cluster's new state
    cluster.sync();
  }
}

}  // namespace

// Whether the kernel covers width D on the current device: 1 or 0, or a
// negative CUDA error code.
extern "C" int lstm_scan_supported(int D) {
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return lstm_fits(D, max_smem) ? 1 : 0;
}

extern "C" int lstm_scan_f32(const LstmArgs* args, int ndir, void* stream) {
  const int supported = lstm_scan_supported(args->D);
  if (supported < 0) return -supported;
  if (supported == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)lstm_layout(args->D).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args->B + kGroupRows - 1) / kGroupRows;
  const dim3 grid(groups * kCluster, ndir);
  lstm_scan_kernel<<<grid, kClusterThreads, smem, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
