// Cluster building blocks of the recurrent scans of the pull design: the
// GRU forward (gru_scan.cu, decode and training) and training backward
// (gru_train.cu), and the LSTM forward (lstm_scan.cu) and training backward
// (lstm_train.cu).
//
// A thread-block cluster of 8 or 16 blocks serves kGroupRows batch rows of
// one direction; block j owns n state columns [j*n, (j+1)*n) (n even), so
// the cluster covers Dp = cluster * n >= D columns, the padding zero.  The
// vector a product reads (state, r * state, or a gradient) is held k-major,
// kGroupRows floats per k, in every block: a block writes its own slice (the
// k range [j*n, (j+1)*n)) once, and after a cluster barrier every block
// pulls the peers' slices with 16-byte distributed-shared-memory loads.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroupRows = 16;     // batch rows per cluster
constexpr int kClusterThreads = 512;
constexpr int kTileRows = 8;       // a product thread's register tile:
constexpr int kTileCols = 2;       //   8 rows x 2 columns of one k slice
constexpr int kMaxSlices = 8;      // k slices per product output
constexpr int kAhead = 4;          // k steps loaded ahead
// the most dynamic shared memory a block may opt in to on sm_90 (227 KB)
constexpr int kMaxSmemFloats = 232448 / 4;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// n: the owned columns of a block of a `cluster`-block cluster at width D
__host__ __device__ inline int owned_columns(int D, int cluster) {
  return ((D + cluster - 1) / cluster + 1) / 2 * 2;
}

// k slices of a product of `cols` columns (kTileRows x kTileCols tiles),
// at most `cap`, so that every tile of every slice has a thread
__host__ __device__ inline int tile_slices(int cols, int cap) {
  const int tiles = (kGroupRows / kTileRows) * (cols / kTileCols);
  return max(1, min(cap, kClusterThreads / tiles));
}

// part[(q * kGroupRows + row) * n + c] = sum over k in slice q of `K` of
// x[k * kGroupRows + row] * w[k * n + c].  A thread takes kTileRows rows x
// kTileCols columns of one slice: two float4s of x and one float2 of w a k
// step, with kAhead steps' loads issued before their FMAs.
__device__ __forceinline__ void tile_partials(const float* x, const float* w,
                                              int n, int K, int slices,
                                              float* part) {
  constexpr int R = kTileRows, C = kTileCols;
  const int groups = n / C, tiles = (kGroupRows / R) * groups;
  const int item = threadIdx.x;
  if (item >= slices * tiles) return;
  const int q = item / tiles, rem = item % tiles;
  const int rg = rem / groups, c = (rem % groups) * C;
  const int k0 = q * K / slices, k1 = (q + 1) * K / slices;
  const float* xp = x + rg * R;
  const float* wp = w + c;
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = 0.f;
  auto load = [&](int k, float (&xs)[R], float2& ws) {
    const float4 lo = *reinterpret_cast<const float4*>(xp + k * kGroupRows);
    const float4 hi = *reinterpret_cast<const float4*>(
        xp + k * kGroupRows + 4);
    xs[0] = lo.x;
    xs[1] = lo.y;
    xs[2] = lo.z;
    xs[3] = lo.w;
    xs[4] = hi.x;
    xs[5] = hi.y;
    xs[6] = hi.z;
    xs[7] = hi.w;
    ws = *reinterpret_cast<const float2*>(wp + k * n);
  };
  auto step = [&](const float (&xs)[R], const float2& ws) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i][0] = fmaf(xs[i], ws.x, acc[i][0]);
      acc[i][1] = fmaf(xs[i], ws.y, acc[i][1]);
    }
  };
  int k = k0;
  for (; k + kAhead <= k1; k += kAhead) {
    float xs[kAhead][R];
    float2 ws[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s) load(k + s, xs[s], ws[s]);
#pragma unroll
    for (int s = 0; s < kAhead; ++s) step(xs[s], ws[s]);
  }
  for (; k < k1; ++k) {
    float xs[R];
    float2 ws;
    load(k, xs, ws);
    step(xs, ws);
  }
  float* out = part + (q * kGroupRows + rg * R) * n + c;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    out[i * n] = acc[i][0];
    out[i * n + 1] = acc[i][1];
  }
}

// the slices' partial sums of output (r, c), added in slice order
__device__ __forceinline__ float slice_sum(const float* part, int slices,
                                           int n, int r, int c) {
  float s = part[r * n + c];
  for (int q = 1; q < slices; ++q) s += part[(q * kGroupRows + r) * n + c];
  return s;
}

// Copy every peer's slices of the k-major buffer `buf` into ours: `parts`
// regions Dp rows apart, block q's slice of each the rows [q*n, (q+1)*n).
// Four 16-byte remote loads are in flight per thread before their stores.
template <int kCluster>
__device__ __forceinline__ void pull_peers(cooperative_groups::cluster_group&
                                               cluster,
                                           float* buf, int n, int Dp,
                                           int parts, int self) {
  const int per = n * kGroupRows / 4;             // float4s of one slice
  const int count = parts * kCluster * per;
  float4* mine = reinterpret_cast<float4*>(buf);
  for (int base = threadIdx.x; base < count; base += 4 * kClusterThreads) {
    float4 v[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kClusterThreads;
      const int part = i / (kCluster * per), q = (i / per) % kCluster;
      at[u] = i < count && q != self ? part * Dp * kGroupRows / 4
                                           + i % (kCluster * per)
                                     : -1;
      if (at[u] >= 0)
        v[u] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(buf, q))[at[u]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) mine[at[u]] = v[u];
  }
}

// The opt-in shared memory of a block on the current device, into *bytes;
// a CUDA error code.
inline int max_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// Let `kernel` take `smem` bytes of dynamic shared memory and, in clusters
// of more than 8 blocks, a non-portable cluster size.
template <typename Kernel>
cudaError_t prepare_cluster_kernel(Kernel kernel, int cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// A launch of `grid` blocks of kClusterThreads threads in clusters of
// `cluster` blocks along x, `smem` bytes of dynamic shared memory each
// (cudaLaunchKernelEx, cudaOccupancyMaxActiveClusters); *attr holds the
// cluster's shape and must outlive the configuration.
inline cudaLaunchConfig_t cluster_launch(dim3 grid, int cluster, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The forward's shared memory (gru_scan.cu), offsets in floats, every
// buffer on a 16-byte boundary (n is even, Dp a multiple of 16):
//   wg    (Dp, 2n)  the owned gate columns [update | reset], k-major
//   ws    (Dp, n)   the owned candidate columns
//   h, rh (Dp, kGroupRows) the state and r * state, k-major
//   z     (kGroupRows, n)  the owned update gates of the step
//   stage the next step's gate inputs (kGroupRows * 2n), input
//         projections and mask (kGroupRows * n each), per item
//   part  the products' slice partial sums
// The slices are capped at kMaxSlices, halved while the layout does not
// fit in kMaxSmemFloats (D above about 400 for 16 blocks).
struct FwdLayout {
  int n, Dp, slices_g, slices_c;
  int wg, ws, h, rh, z, stage, part, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int D, int cluster) {
  FwdLayout o;
  o.n = owned_columns(D, cluster);
  o.Dp = cluster * o.n;
  o.wg = 0;
  o.ws = o.wg + o.Dp * 2 * o.n;
  o.h = o.ws + o.Dp * o.n;
  o.rh = o.h + o.Dp * kGroupRows;
  o.z = o.rh + o.Dp * kGroupRows;
  o.stage = o.z + kGroupRows * o.n;
  o.part = o.stage + 4 * kGroupRows * o.n;
  for (int cap = kMaxSlices;; cap /= 2) {
    o.slices_g = tile_slices(2 * o.n, cap);
    o.slices_c = tile_slices(o.n, cap);
    o.total = o.part + max(o.slices_g * 2, o.slices_c) * kGroupRows * o.n;
    if (o.total <= kMaxSmemFloats || cap == 1) break;
  }
  return o;
}

// Each thread finishes at most two gate items and one candidate item of
// the block's (row, column) outputs, and the layout fits in `max_smem`.
__host__ inline bool fwd_fits(int D, int cluster, int max_smem) {
  const FwdLayout o = fwd_layout(D, cluster);
  return kGroupRows * o.n <= kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

}  // namespace
