// Forward GRU scan over time: the whole recurrence in one launch, for one
// direction or for both directions of a bidirectional layer at once.
//
// Replaces attention_lvcsr_tpu/ops/pallas/gru_scan.py::gru_scan (the
// Pallas kernel that carries the encoder on every inference path).
// Computes exactly what it computes, per time step t and batch row b:
//
//   [z, r] = sigmoid(h @ w_gates + gate_proj[t, b])      (update, reset)
//   c      = tanh((h * r) @ w_state + x_proj[t, b])
//   h'     = z * c + (1 - z) * h
//   h'     = m * h' + (1 - m) * h      with m = mask[t, b] when masked
//
// A direction marked reverse visits t = T-1 .. 0, which is the JAX
// package's backward direction (flip inputs and mask, scan, flip back)
// without the flips.  The input and gate projections are large batched
// products computed outside the kernel (torch.matmul), as the JAX
// package leaves them to XLA; they are read through a row stride, so the
// four projections of a bidirectional layer can come from one matmul.
//
// What bounds it on the card: latency, not FLOPs or HBM.  The scan is 2*T
// dependent small products (gates, then candidate) over a few batch rows,
// and only a few blocks per direction have work, so most SMs idle.  A
// block that keeps the recurrent matrices in L2 re-reads all of them
// (3*D*D floats, 750 KB at D=250) every step.
//
// What the design does about it: both directions run in the same launch
// (blockIdx.y), and the kernel removes the L2 stream: a thread-block
// cluster of kCluster blocks serves kGroupRows batch rows of one
// direction, and block j of the cluster keeps columns [j*n, (j+1)*n) of
// both recurrent matrices (n = ceil(D / kCluster); 96 KB at D=250) in its
// shared memory for the whole scan.  Each block holds the full state of
// its rows (transposed, k-major, so four rows load as one float4); per
// step it computes its gate columns, broadcasts its slice of r*h into
// every block of the cluster through distributed shared memory, meets
// them at a cluster barrier, computes its candidate columns and
// broadcasts its slice of the new state, and meets them again.  Loads of
// the step's input projections are issued before the products so their
// latency hides behind them.  Widths whose weight slices do not fit in a
// block's shared memory (D above about 330) are not covered:
// gru_scan_supported() says so before a launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Must match the ctypes.Structures in ops/gru_scan.py field for field.
struct GruDir {
  const float* x;        // x_proj: (t, b, c) at x[(t * B + b) * ldx + c]
  const float* g;        // gate_proj: (t, b, c) at g[(t * B + b) * ldg + c]
  const float* h0;       // (B, D)
  const float* w_state;  // (D, D)
  const float* w_gates;  // (D, 2D)
  float* out;            // (t, b, c) at out[(t * B + b) * ldo + c]
  int reverse;           // visit t = T-1 .. 0
};

struct GruArgs {
  GruDir dir[2];
  const float* mask;     // (T, B) or null
  int T, B, D, ldx, ldg, ldo;
};

namespace {

constexpr int kPrefetch = 8;   // k steps loaded ahead per thread

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

constexpr int kCluster = 8;       // blocks per cluster (portable maximum)
constexpr int kGroupRows = 16;    // batch rows per cluster
constexpr int kRowsPerThread = 4; // one float4 of the k-major state
constexpr int kClusterThreads = 512;
constexpr int kPartFloats = 4 * kClusterThreads;  // partial-sum buffer

struct ClusterLayout {
  int n, wg, ws, h, rh, z, part, total;   // offsets in floats
};

// h, rh and part start on 16-byte boundaries (float4 loads)
__host__ __device__ inline ClusterLayout cluster_layout(int D) {
  ClusterLayout o;
  o.n = (D + kCluster - 1) / kCluster;
  o.wg = 0;                                   // (D, 2n) own gate columns
  o.ws = o.wg + D * 2 * o.n;                  // (D, n) own state columns
  o.h = (o.ws + D * o.n + 3) / 4 * 4;         // (D, kGroupRows) state
  o.rh = o.h + D * kGroupRows;                // (D, kGroupRows) r * state
  o.z = o.rh + D * kGroupRows;                // (kGroupRows, n) update gate
  o.part = (o.z + kGroupRows * o.n + 3) / 4 * 4;
  o.total = o.part + kPartFloats;
  return o;
}

// The cluster kernel needs every (4 rows, gate column) product in one pass
// of the block's threads, and the weight slices in shared memory.
__host__ inline bool cluster_fits(int D, int max_smem) {
  const ClusterLayout o = cluster_layout(D);
  return (kGroupRows / kRowsPerThread) * 2 * o.n <= kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

// k slices per output column when `cols` columns x 4-row groups share
// the block's threads
__device__ __forceinline__ int cluster_slices(int cols, int D) {
  const int s = kClusterThreads / ((kGroupRows / kRowsPerThread) * cols);
  return max(1, min(D, s));
}

// acc[i] = sum_{k0 <= k < k1} x[k * kGroupRows + 4 * rp + i] * w[k * ldw + c]
// in k order: the k-major state gives four rows per float4 load, and
// kPrefetch iterations' shared-memory loads are issued before their FMAs.
__device__ __forceinline__ void kmajor_dot(const float* x, int rp,
                                           const float* w, int ldw, int c,
                                           int k0, int k1, float (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  int k = k0;
  for (; k + kPrefetch <= k1; k += kPrefetch) {
    float wv[kPrefetch];
    float4 xv[kPrefetch];
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      wv[q] = w[(k + q) * ldw + c];
      xv[q] = *reinterpret_cast<const float4*>(
          x + (k + q) * kGroupRows + rp * kRowsPerThread);
    }
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      acc[0] = fmaf(xv[q].x, wv[q], acc[0]);
      acc[1] = fmaf(xv[q].y, wv[q], acc[1]);
      acc[2] = fmaf(xv[q].z, wv[q], acc[2]);
      acc[3] = fmaf(xv[q].w, wv[q], acc[3]);
    }
  }
  for (; k < k1; ++k) {
    const float wv = w[k * ldw + c];
    const float4 xv = *reinterpret_cast<const float4*>(
        x + k * kGroupRows + rp * kRowsPerThread);
    acc[0] = fmaf(xv.x, wv, acc[0]);
    acc[1] = fmaf(xv.y, wv, acc[1]);
    acc[2] = fmaf(xv.z, wv, acc[2]);
    acc[3] = fmaf(xv.w, wv, acc[3]);
  }
}

// part[(q * kGroupRows + row) * cols + c]: slice q of the product of the
// k-major rows x with the `cols` weight columns w (row stride ldw).
__device__ __forceinline__ void cluster_partials(const float* x,
                                                 const float* w, int ldw,
                                                 int cols, int slices, int D,
                                                 float* part) {
  const int groups = kGroupRows / kRowsPerThread;
  const int tid = threadIdx.x;
  if (tid >= slices * groups * cols) return;
  const int q = tid / (groups * cols), rem = tid % (groups * cols);
  const int rp = rem / cols, c = rem % cols;
  float acc[kRowsPerThread];
  kmajor_dot(x, rp, w, ldw, c, q * D / slices, (q + 1) * D / slices, acc);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    part[(q * kGroupRows + rp * kRowsPerThread + i) * cols + c] = acc[i];
}

__device__ __forceinline__ float cluster_sum(const float* part, int slices,
                                             int cols, int r, int c) {
  float s = part[r * cols + c];
  for (int q = 1; q < slices; ++q) s += part[(q * kGroupRows + r) * cols + c];
  return s;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kClusterThreads, 1)
    gru_scan_kernel(GruArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const GruDir d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D, D2 = 2 * a.D;
  const ClusterLayout o = cluster_layout(D);
  const int n = o.n, n2 = 2 * o.n;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kCluster) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* wg = smem + o.wg;
  float* ws = smem + o.ws;
  float* hT = smem + o.h;
  float* rhT = smem + o.rh;
  float* z = smem + o.z;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int slices_g = cluster_slices(n2, D), slices_c = cluster_slices(n, D);

  // weights of the owned columns (zero past D), initial state, k-major
  for (int i = tid; i < D * n2; i += blockDim.x) {
    const int k = i / n2, cc = i % n2;
    const int c = c0 + (cc < n ? cc : cc - n);
    wg[i] = c < D ? d.w_gates[(size_t)k * D2 + (cc < n ? c : D + c)] : 0.f;
  }
  for (int i = tid; i < D * n; i += blockDim.x) {
    const int k = i / n, c = c0 + i % n;
    ws[i] = c < D ? d.w_state[(size_t)k * D + c] : 0.f;
  }
  for (int i = tid; i < D * kGroupRows; i += blockDim.x) {
    const int k = i / kGroupRows, r = i % kGroupRows;
    hT[i] = r < nrows ? d.h0[(size_t)(b0 + r) * D + k] : 0.f;
    rhT[i] = 0.f;
  }
  cluster.sync();

  // outputs this thread finishes: gate items tid + e * blockDim
  // (row, column of 2n), candidate items tid + e * blockDim (row, of n)
  constexpr int kGateItems = 4, kCandItems = 2;
  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
    // this step's input projections and mask, loaded ahead of the products
    float gin[kGateItems], xin[kCandItems], mk[kCandItems];
#pragma unroll
    for (int e = 0; e < kGateItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n2, cc = item % n2;
      const int c = c0 + (cc < n ? cc : cc - n);
      gin[e] = r < nrows && c < D
                   ? d.g[(row0 + r) * a.ldg + (cc < n ? c : D + c)] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kCandItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      const bool ok = r < nrows && c < D;
      xin[e] = ok ? d.x[(row0 + r) * a.ldx + c] : 0.f;
      mk[e] = ok && a.mask != nullptr ? a.mask[row0 + r] : 1.f;
    }
    // ---- gates of the owned columns; broadcast r * h into the cluster
    cluster_partials(hT, wg, n2, n2, slices_g, D, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kGateItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n2, cc = item % n2;
      const int c = c0 + (cc < n ? cc : cc - n);
      if (r >= nrows || c >= D) continue;
      const float g = sigmoidf(cluster_sum(part, slices_g, n2, r, cc)
                               + gin[e]);
      if (cc < n) {
        z[r * n + cc] = g;
      } else {
        const float v = g * hT[c * kGroupRows + r];
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          cluster.map_shared_rank(rhT, q)[c * kGroupRows + r] = v;
      }
    }
    // ---- wait for the cluster's r * h
    cluster.sync();
    // ---- candidates of the owned columns; broadcast the new state
    cluster_partials(rhT, ws, n, n, slices_c, D, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kCandItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      if (r >= nrows || c >= D) continue;
      const float cand = tanhf(cluster_sum(part, slices_c, n, r, cc)
                               + xin[e]);
      const float hold = hT[c * kGroupRows + r];
      const float up = z[r * n + cc];
      float hn = up * cand + (1.f - up) * hold;
      if (a.mask != nullptr) hn = mk[e] * hn + (1.f - mk[e]) * hold;
      d.out[(row0 + r) * a.ldo + c] = hn;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        cluster.map_shared_rank(hT, q)[c * kGroupRows + r] = hn;
    }
    // ---- wait for the cluster's new state
    cluster.sync();
  }
}

}  // namespace

// Whether the kernel covers width D on the current device: 1 or 0, or a
// negative CUDA error code.
extern "C" int gru_scan_supported(int D) {
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return cluster_fits(D, max_smem) ? 1 : 0;
}

extern "C" int gru_scan_f32(const GruArgs* args, int ndir, void* stream) {
  const int supported = gru_scan_supported(args->D);
  if (supported < 0) return -supported;
  if (supported == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cluster_layout(args->D).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args->B + kGroupRows - 1) / kGroupRows;
  const dim3 grid(groups * kCluster, ndir);
  gru_scan_kernel<<<grid, kClusterThreads, smem, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
