// Cluster-GRU building blocks shared by the forward scan (gru_scan.cu)
// and the training backward scan (gru_train.cu).
//
// A thread-block cluster of kCluster blocks serves kGroupRows batch rows
// of one direction; block j of the cluster owns columns [j*n, (j+1)*n) of
// the recurrent products (n = ceil(D / kCluster)) and keeps the weight
// slices it needs in shared memory for the whole scan.  The vector a
// product reads (state, r * state, or a gradient) is held k-major in
// every block, kGroupRows floats per k, so four rows load as one float4.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

}  // namespace
