// The wide instances of the GRU scans: gru_scan.cu's forward and
// gru_train.cu's backward at widths whose recurrent weight slices do not
// fit a block's shared memory beside its buffers (D above 448 forward, 384
// backward), up to kWideMaxD.
//
// The cluster, the owned columns and the k-major exchange buffers are
// gru_pull.cuh's.  What changes is where the weights live: a block's slice
// (3*Dp*n floats, 768 KB at D=1000) is streamed from global memory, where
// the wrapper packs it per block (ops/gru_scan.py::pack_forward,
// ops/gru_train.py::pack_backward; zero past D, so the padding stays zero),
// through a ring of kRingStages tiles in shared memory, every step.  The
// copies are cp.async (sm90_async.cuh), kRingStages - 1 tiles ahead of the
// tile whose FMAs run; the slices of every tile are the products' k slices,
// so a second call repeats bit for bit.  Both directions' slices of one
// layer (24 MB at D=1000) stay in the 50 MB L2 across steps.
#pragma once
#include "gru_pull.cuh"
#include "sm90_async.cuh"

namespace {

constexpr int kWideMaxD = 1024;    // the widest width covered
constexpr int kRingStages = 4;     // tiles of the weight ring
constexpr int kRingFloats = 2048;  // floats of one ring tile (8 KB)

// (row, gate column) and (row, state column) items a thread finishes in
// the wide forward with `cluster` blocks: enough for n at kWideMaxD
__host__ __device__ constexpr int wide_gate_items(int cluster) {
  return kGroupRows * 2 * (kWideMaxD / cluster) / kClusterThreads;
}
__host__ __device__ constexpr int wide_cand_items(int cluster) {
  return kGroupRows * (kWideMaxD / cluster) / kClusterThreads;
}

// k rows of a ring tile of a `cols`-column product over `slices` k slices:
// the same number for every slice, within kRingFloats floats, and an even
// count where a row is not a whole number of 16-byte copies (cols even)
__host__ __device__ inline int ring_rows(int cols, int slices) {
  int per = max(1, kRingFloats / (cols * slices));
  if (cols % 4 != 0 && per * slices % 2 != 0) per = per > 1 ? per - 1 : 2;
  return per * slices;
}

// The wide forward's shared memory (offsets in floats, 16-byte aligned):
// gru_pull.cuh's FwdLayout without the weights, plus the ring.
//   h, rh (Dp, kGroupRows)  the state and r * state, k-major
//   z     (kGroupRows, n)   the owned update gates of the step
//   stage the next step's gate inputs (kGroupRows * 2n), input
//         projections and mask (kGroupRows * n each), per item
//   part  the products' slice partial sums
//   ring  kRingStages tiles of the streamed weights
struct WideLayout {
  int n, Dp, slices_g, slices_c, kt_g, kt_c;
  int h, rh, z, stage, part, ring, total;
};

__host__ __device__ inline WideLayout wide_layout(int D, int cluster) {
  WideLayout o;
  o.n = owned_columns(D, cluster);
  o.Dp = cluster * o.n;
  o.slices_g = tile_slices(2 * o.n, kMaxSlices);
  o.slices_c = tile_slices(o.n, kMaxSlices);
  o.kt_g = ring_rows(2 * o.n, o.slices_g);
  o.kt_c = ring_rows(o.n, o.slices_c);
  o.h = 0;
  o.rh = o.h + o.Dp * kGroupRows;
  o.z = o.rh + o.Dp * kGroupRows;
  o.stage = o.z + kGroupRows * o.n;
  o.part = o.stage + 4 * kGroupRows * o.n;
  o.ring = o.part + max(o.slices_g * 2, o.slices_c) * kGroupRows * o.n;
  o.total = o.ring + kRingStages * kRingFloats;
  return o;
}

// D up to kWideMaxD, every item of a block with a thread, and the layout
// within `max_smem`.
__host__ inline bool wide_fits(int D, int cluster, int max_smem) {
  if (D < 1 || D > kWideMaxD || (cluster != 8 && cluster != 16))
    return false;
  const WideLayout o = wide_layout(D, cluster);
  return kGroupRows * 2 * o.n <= wide_gate_items(cluster) * kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

// The wide backward's shared memory (gru_train.cu, 16-block clusters):
//   big   (2Dp, kGroupRows)  every block's da slices (rows [0, Dp)), then
//         every block's [du | dr] gate gradients, k-major: pulled into
//   oa    (n, kGroupRows)    the block's own da slice, and
//   og    (2n, kGroupRows)   its own [du | dr] slices, which the peers pull
//   stage (6, kGroupRows * n) the next step's u, r, c, h_prev, dstates
//         and mask, per item
//   part  the products' slice partial sums (slices halved while the
//         layout does not fit)
//   ring  kRingStages tiles of the streamed weights
struct BwdWideLayout {
  int n, Dp, slices, kt;
  int big, oa, og, stage, part, ring, total;
};

__host__ __device__ inline BwdWideLayout bwd_wide_layout(int D) {
  constexpr int kCluster = 16;
  BwdWideLayout o;
  o.n = owned_columns(D, kCluster);
  o.Dp = kCluster * o.n;
  o.big = 0;
  o.oa = o.big + 2 * o.Dp * kGroupRows;
  o.og = o.oa + o.n * kGroupRows;
  o.stage = o.og + 2 * o.n * kGroupRows;
  o.part = o.stage + 6 * kGroupRows * o.n;
  for (int cap = kMaxSlices;; cap /= 2) {
    o.slices = tile_slices(o.n, cap);
    o.ring = o.part + o.slices * kGroupRows * o.n;
    o.total = o.ring + kRingStages * kRingFloats;
    if (o.total <= kMaxSmemFloats || cap == 1) break;
  }
  o.kt = ring_rows(o.n, o.slices);
  return o;
}

__host__ inline bool bwd_wide_fits(int D, int max_smem) {
  if (D < 1 || D > kWideMaxD) return false;
  const BwdWideLayout o = bwd_wide_layout(D);
  return kGroupRows * o.n <= 2 * kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

// Copy every block's own k-major slices `own` (parts regions of n rows,
// kGroupRows floats a row; this block's too) into `big`: block q's region
// g to the rows [g*Dp + q*n, g*Dp + (q+1)*n).  Four 16-byte loads, remote
// but for this block's own, are in flight per thread before their stores.
template <int kCluster>
__device__ __forceinline__ void pull_slices(cooperative_groups::cluster_group&
                                                cluster,
                                            float* own, float* big, int n,
                                            int Dp, int parts) {
  const int per = n * kGroupRows / 4;             // float4s of one region
  const int count = parts * kCluster * per;
  float4* dst = reinterpret_cast<float4*>(big);
  for (int base = threadIdx.x; base < count; base += 4 * kClusterThreads) {
    float4 v[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kClusterThreads;
      const int g = i / (kCluster * per), q = (i / per) % kCluster;
      const int w = i % per;
      at[u] = i < count ? g * Dp * kGroupRows / 4 + q * per + w : -1;
      if (at[u] >= 0)
        v[u] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(own, q))[g * per + w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// part[(q * kGroupRows + row) * cols + c] = sum over k < K, in slice q of
// every tile, of x[k * kGroupRows + row] * w[k * cols + c].  w (K, cols) is
// in global memory, 16-byte aligned, streamed through `ring` in tiles of
// kt rows; slice q takes the rows [q*kt/slices, (q+1)*kt/slices) of each
// tile; a thread takes tile_partials' kTileRows x kTileCols tile and adds
// its slice's rows tile after tile.  Every thread of the block calls it;
// the caller puts a barrier between the last read of the ring, x or part
// before the call and the call, and between it and the next use of part.
__device__ __forceinline__ void stream_partials(const float* x,
                                                const float* w, int cols,
                                                int K, int kt, int slices,
                                                float* ring, float* part) {
  constexpr int R = kTileRows, C = kTileCols;
  const int tid = threadIdx.x;
  const int tiles = (K + kt - 1) / kt;
  auto issue = [&](int t) {
    if (t < tiles) {
      const int count = min(kt, K - t * kt) * cols / 4;
      const float* src = w + (size_t)t * kt * cols;
      float* dst = ring + (t % kRingStages) * kRingFloats;
      for (int i = tid; i < count; i += kClusterThreads)
        cp_async<16>(dst + 4 * i, src + 4 * i, 16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) issue(s);
  const int groups = cols / C, ntiles = (kGroupRows / R) * groups;
  const bool active = tid < slices * ntiles;
  const int q = tid / ntiles, rem = tid % ntiles;
  const int rg = rem / groups, c = (rem % groups) * C;
  const int per = kt / slices;
  const float* xp = x + rg * R;
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = 0.f;
  // x's row k, and the tile's row kl of the owned columns
  auto load = [&](const float* wt, int k, int kl, float (&xs)[R],
                  float2& ws) {
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
    ws = *reinterpret_cast<const float2*>(wt + kl * cols);
  };
  auto step = [&](const float (&xs)[R], const float2& ws) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i][0] = fmaf(xs[i], ws.x, acc[i][0]);
      acc[i][1] = fmaf(xs[i], ws.y, acc[i][1]);
    }
  };
  for (int t = 0; t < tiles; ++t) {
    // tile t has landed for every thread, and every thread is done with
    // tile t - 1, whose slot the copy of tile t + kRingStages - 1 takes
    cp_async_wait<kRingStages - 2>();
    __syncthreads();
    issue(t + kRingStages - 1);
    if (!active) continue;
    const int base = t * kt;
    const float* wt = ring + (t % kRingStages) * kRingFloats + c;
    const int k1 = min(base + (q + 1) * per, K);
    int k = base + q * per;
    for (; k + kAhead <= k1; k += kAhead) {
      float xs[kAhead][R];
      float2 ws[kAhead];
#pragma unroll
      for (int s = 0; s < kAhead; ++s)
        load(wt, k + s, k + s - base, xs[s], ws[s]);
#pragma unroll
      for (int s = 0; s < kAhead; ++s) step(xs[s], ws[s]);
    }
    for (; k < k1; ++k) {
      float xs[R];
      float2 ws;
      load(wt, k, k - base, xs, ws);
      step(xs, ws);
    }
  }
  if (!active) return;
  float* out = part + (q * kGroupRows + rg * R) * cols + c;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    out[i * cols] = acc[i][0];
    out[i * cols + 1] = acc[i][1];
  }
}

}  // namespace
