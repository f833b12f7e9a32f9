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
// What bounds it on the card: latency.  Each step is two dependent
// products (D x D, then 2D x D) over 16 batch rows, spread over a cluster,
// with two cluster-wide exchanges between them.  A 16-block cluster (a
// non-portable size, launched with cudaLaunchKernelEx) serves 16 rows of
// one direction; block j owns the n state columns [j*n, (j+1)*n) (n =
// ceil(D/16) rounded up to even, so the cluster covers Dp = 16n >= D
// columns, the padding zero) and keeps the rows of w_state and w_gates
// that produce them, transposed (3*Dp*n floats, 48 KB at D=250), in shared
// memory for the whole scan; the carried state gradient of its columns
// stays in registers.  Sixteen blocks rather than the forward's eight
// halve each block's products, which the phase probes show dominate once
// the exchanges are cheap.  What the design does about the latency:
//
// * operands off the chain: the next step's u, r, c, h_prev, dstates and
//   mask for the block's (row, column) items are copied into a stage with
//   cp.async while this step's gate path runs; each thread copies exactly
//   the items it later reads, so the stage needs no barrier.  The copies
//   are issued after the step's last cluster arrive: a release arrive
//   waits for the thread's outstanding reads, and these would stall it;
// * pull, not push: a block writes its da (then dg) slice once, into its
//   own k-major copy; after the cluster barrier every block pulls the
//   peers' slices with 16-byte distributed-shared-memory loads (the slice
//   of block q is the contiguous k range [q*n, (q+1)*n)), instead of 24
//   scalar remote stores per item;
// * a split barrier: after writing its dg slice a block arrives, issues
//   the prefetch and the step's dx_in / dx_gate stores, and only then
//   waits for the cluster (the da exchange has no such work to overlap);
// * short k-chains: a thread computes 8 rows x 2 columns (two float4s of
//   the gradient and one float2 of the weights feed 16 FMAs) over one of
//   up to 8 k slices (32 and 64 dependent steps at D=250); the slices'
//   partial sums are added in slice order, so the result repeats bit for
//   bit.
//
// Widths whose weight slices and buffers do not fit in a block's shared
// memory (D above 384; the forward's limit is D=448) take the wide
// instance, gru_bwd_wide_kernel, up to D=1024 (gru_wide.cuh): the leading
// tiles of the weight slices resident and the rest streamed from L2 every
// step through a TMA ring that runs ahead across products and steps, and the
// gradients a product reads gathered into one buffer that holds the da
// slices, then the [du | dr] slices, pulled from small per-block buffers
// of the block's own slices (the two exchanges do not fit side by side at
// D=1024).  gru_train_supported() and gru_train_wide_supported() say what
// each covers before a launch.  The product tiles, the slice sums and the
// pulls are gru_pull.cuh's, shared with the forward.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gru_pull.cuh"
#include "gru_wide.cuh"
#include "sm90_async.cuh"

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

// The wide instance's arguments: the resident ones, and per direction the
// weights packed per block (ops/gru_train.py::pack_backward): block j's
// slice at pack[(size_t)j * 3 * Dp * n], the owned rows of w_state
// transposed (Dp, n) then those of w_gates (2Dp, n: update, then reset
// k), zero past D.
struct GruBwdWideArgs {
  GruBwdArgs a;
  const float* pack[2];
};

namespace {

constexpr int kBwdCluster = 16;    // blocks per cluster (non-portable)
constexpr int kItems = 2;          // (row, owned column) items per thread
constexpr int kOperands = 6;       // staged per item: u, r, c, h_prev,
                                   // dstates, mask

struct BwdLayout {
  int n, Dp, slices;                       // columns, padded width, slices
  int ws, wg, da, dg, stage, part, total;  // offsets in floats
};

// every buffer starts on a 16-byte boundary (float4 pulls and loads)
__host__ __device__ inline BwdLayout bwd_layout(int D) {
  BwdLayout o;
  o.n = owned_columns(D, kBwdCluster);
  o.Dp = kBwdCluster * o.n;
  o.slices = tile_slices(o.n, kMaxSlices);
  o.ws = 0;                                 // (Dp, n): w_state[c0 + c][k]
  o.wg = o.ws + o.Dp * o.n;                 // (2Dp, n): w_gates[c0 + c][.]
  o.da = o.wg + 2 * o.Dp * o.n;             // (Dp, kGroupRows) da, k-major
  o.dg = o.da + o.Dp * kGroupRows;          // (2Dp, kGroupRows) [du | dr]
  o.stage = o.dg + 2 * o.Dp * kGroupRows;   // (kOperands, kGroupRows * n)
  o.part = o.stage + kOperands * kGroupRows * o.n;
  o.total = o.part + o.slices * kGroupRows * o.n;
  return o;
}

__host__ inline bool bwd_fits(int D, int max_smem) {
  const BwdLayout o = bwd_layout(D);
  return kGroupRows * o.n <= kItems * kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

__global__ void __launch_bounds__(kClusterThreads, 1)
    gru_bwd_kernel(const __grid_constant__ GruBwdArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const GruBwdDir& d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D;
  const BwdLayout o = bwd_layout(D);
  const int n = o.n, Dp = o.Dp, slices = o.slices;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kBwdCluster) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* wsT = smem + o.ws;
  float* wgT = smem + o.wg;
  float* daT = smem + o.da;
  float* dgT = smem + o.dg;
  float* stage = smem + o.stage;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int items = kGroupRows * n;           // stage stride per operand

  // the owned rows of both matrices, transposed (zero past D)
  for (int i = tid; i < Dp * n; i += blockDim.x) {
    const int k = i / n, c = c0 + i % n;
    wsT[i] = k < D && c < D ? d.w_state[(size_t)c * D + k] : 0.f;
  }
  for (int i = tid; i < 2 * Dp * n; i += blockDim.x) {
    const int g = i / (Dp * n), k = (i / n) % Dp, c = c0 + i % n;
    wgT[i] = k < D && c < D ? d.w_gates[(size_t)c * 2 * D + g * D + k] : 0.f;
  }
  for (int i = tid; i < 3 * Dp * kGroupRows; i += blockDim.x) daT[i] = 0.f;

  // the step's operands of this thread's items into the stage
  auto prefetch = [&](int step) {
    const int t = d.reverse ? step : T - 1 - step;
    const int tp = d.reverse ? t + 1 : t - 1;     // the forward's step before
    const size_t row0 = (size_t)t * B + b0;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      if (r >= nrows || c >= D) continue;
      const size_t idx = (row0 + r) * D + c;
      float* s = stage + item;
      cp_async<4>(s, d.u + idx, 4);
      cp_async<4>(s + items, d.r + idx, 4);
      cp_async<4>(s + 2 * items, d.c + idx, 4);
      cp_async<4>(s + 3 * items,
                  tp < 0 || tp >= T
                      ? d.h0 + (size_t)(b0 + r) * D + c
                      : d.states + ((size_t)tp * B + b0 + r) * a.ld_states + c,
                  4);
      cp_async<4>(s + 4 * items, d.dout + (row0 + r) * a.ld_dout + c, 4);
      if (a.mask != nullptr) cp_async<4>(s + 5 * items, a.mask + row0 + r, 4);
    }
    cp_async_commit();
  };
  prefetch(0);
  // weights and zeroed buffers in place, every block of the cluster running
  cluster.sync();

  float dh[kItems] = {0.f, 0.f};
  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? step : T - 1 - step;
    const size_t row0 = (size_t)t * B + b0;
    float du[kItems], dhp[kItems], rg[kItems], hp[kItems], ug[kItems],
        dav[kItems], gv[kItems][2];
    // ---- elementwise: state, update and candidate gradients; own da slice
    cp_async_wait<0>();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      du[e] = dhp[e] = rg[e] = hp[e] = ug[e] = dav[e] = 0.f;
      if (r >= nrows || c >= D) continue;
      const float* s = stage + item;
      const float u = s[0], cand = s[2 * items], h_prev = s[3 * items];
      const float m = a.mask != nullptr ? s[5 * items] : 1.f;
      const float g = dh[e] + s[4 * items];
      const float draw = g * m;
      float dprev = g * (1.f - m);
      du[e] = draw * (cand - h_prev);
      const float dcand = draw * u;
      dprev = dprev + draw * (1.f - u);
      const float da = dcand * (1.f - cand * cand);
      daT[c * kGroupRows + r] = da;
      dav[e] = da;
      dhp[e] = dprev;
      rg[e] = s[items];
      hp[e] = h_prev;
      ug[e] = u;
    }
    // ---- wait for the cluster's da; pull the peers' slices
    cluster.sync();
    pull_peers<kBwdCluster>(cluster, daT, n, Dp, 1, j);
    __syncthreads();
    // ---- reset path: da @ w_state^T; gate gradients; own dg slices
    tile_partials(daT, wsT, n, Dp, slices, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      if (r >= nrows || c >= D) continue;
      const float dhr = slice_sum(part, slices, n, r, cc);
      dhp[e] = dhp[e] + dhr * rg[e];
      const float dr = dhr * hp[e];
      gv[e][0] = du[e] * ug[e] * (1.f - ug[e]);
      gv[e][1] = dr * rg[e] * (1.f - rg[e]);
      dgT[c * kGroupRows + r] = gv[e][0];
      dgT[(Dp + c) * kGroupRows + r] = gv[e][1];
    }
    cluster_arrive();
    // the next step's operands, then this step's dx_in and dx_gate rows:
    // issued after the arrive, whose release would otherwise wait for
    // these reads and writes too
    if (step + 1 < T) prefetch(step + 1);
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      if (r >= nrows || c >= D) continue;
      d.dx[(row0 + r) * a.ld_dproj + c] = dav[e];
      float* dg_row = d.dg + (row0 + r) * a.ld_dproj;
      dg_row[c] = gv[e][0];
      dg_row[D + c] = gv[e][1];
    }
    // ---- wait for the cluster's dg; pull the peers' slices
    cluster_wait();
    pull_peers<kBwdCluster>(cluster, dgT, n, Dp, 2, j);
    __syncthreads();
    // ---- gate path: dg @ w_gates^T finishes the owned state gradients
    tile_partials(dgT, wgT, n, 2 * Dp, slices, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n;
      if (r >= nrows || c0 + cc >= D) continue;
      dh[e] = dhp[e] + slice_sum(part, slices, n, r, cc);
    }
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int item = tid + e * kClusterThreads;
    const int r = item / n, c = c0 + item % n;
    if (r < nrows && c < D)
      d.dh0[(size_t)(b0 + r) * D + c] = dh[e];
  }
  // no block may leave while a peer can still read its shared memory
  cluster.sync();
}

// The wide instance: gru_bwd_kernel's step with the weight slices in a
// WeightRing (the reset path's product 0, the gate path's product 1).
// Buffer hazards (step s; A_s the barrier after the own da slices are
// written, B_s the one after the own [du | dr] slices):
// * oa: written at step s+1, after B_s's wait; the peers pull step s's
//   after A_s and before they arrive at B_s.
// * og: written at step s after A_s; the peers pull step s-1's after
//   B_{s-1} and before they arrive at A_s.
// * big, part, the stage: the block's own, as in gru_bwd_kernel (big is
//   filled by this block's pulls and read by its products, a block barrier
//   between each).  The ring's slots pass between the copies and the
//   readers through its mbarriers.
// * exit: the last remote load is the og pull of step T-1, before the
//   final cluster barrier.
__global__ void __launch_bounds__(kClusterThreads, 1)
    gru_bwd_wide_kernel(const __grid_constant__ GruBwdWideArgs wa) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const GruBwdArgs& a = wa.a;
  const GruBwdDir& d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D;
  const BwdWideLayout o = bwd_wide_layout(D);
  const int n = o.n, Dp = o.Dp, slices = o.slices;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kBwdCluster) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  const float* wsT = wa.pack[blockIdx.y] + (size_t)j * 3 * Dp * n;
  const float* wgT = wsT + (size_t)Dp * n;
  float* big = smem + o.big;
  float* oa = smem + o.oa;
  float* og = smem + o.og;
  float* stage = smem + o.stage;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int items = kGroupRows * n;           // stage stride per operand
  WeightRing ring = ring_start(smem, o.r, RingTiles{wsT, nullptr, n, Dp,
                                                    o.kt, 0},
                               RingTiles{wgT, nullptr, n, 2 * Dp, o.kt, 0},
                               T);

  // the own slices zero: a padded column or row is never written
  for (int i = tid; i < 3 * n * kGroupRows; i += blockDim.x) oa[i] = 0.f;

  // the step's operands of this thread's items into the stage
  auto prefetch = [&](int step) {
    const int t = d.reverse ? step : T - 1 - step;
    const int tp = d.reverse ? t + 1 : t - 1;     // the forward's step before
    const size_t row0 = (size_t)t * B + b0;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      if (r >= nrows || c >= D) continue;
      const size_t idx = (row0 + r) * D + c;
      float* s = stage + item;
      cp_async<4>(s, d.u + idx, 4);
      cp_async<4>(s + items, d.r + idx, 4);
      cp_async<4>(s + 2 * items, d.c + idx, 4);
      cp_async<4>(s + 3 * items,
                  tp < 0 || tp >= T
                      ? d.h0 + (size_t)(b0 + r) * D + c
                      : d.states + ((size_t)tp * B + b0 + r) * a.ld_states + c,
                  4);
      cp_async<4>(s + 4 * items, d.dout + (row0 + r) * a.ld_dout + c, 4);
      if (a.mask != nullptr) cp_async<4>(s + 5 * items, a.mask + row0 + r, 4);
    }
    cp_async_commit();
  };
  prefetch(0);
  // zeroed slices in place, every block of the cluster running
  cluster.sync();
  ring.wait_resident();

  float dh[kItems] = {0.f, 0.f};
  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? step : T - 1 - step;
    const size_t row0 = (size_t)t * B + b0;
    float du[kItems], dhp[kItems], rg[kItems], hp[kItems], ug[kItems],
        dav[kItems], gv[kItems][2];
    // ---- elementwise: state, update and candidate gradients; own da slice
    cp_async_wait<0>();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      du[e] = dhp[e] = rg[e] = hp[e] = ug[e] = dav[e] = 0.f;
      if (r >= nrows || c >= D) continue;
      const float* s = stage + item;
      const float u = s[0], cand = s[2 * items], h_prev = s[3 * items];
      const float m = a.mask != nullptr ? s[5 * items] : 1.f;
      const float g = dh[e] + s[4 * items];
      const float draw = g * m;
      float dprev = g * (1.f - m);
      du[e] = draw * (cand - h_prev);
      const float dcand = draw * u;
      dprev = dprev + draw * (1.f - u);
      const float da = dcand * (1.f - cand * cand);
      oa[cc * kGroupRows + r] = da;
      dav[e] = da;
      dhp[e] = dprev;
      rg[e] = s[items];
      hp[e] = h_prev;
      ug[e] = u;
    }
    // ---- wait for the cluster's da; gather every block's slice
    cluster.sync();
    pull_slices<kBwdCluster>(cluster, oa, big, n, Dp, 1);
    __syncthreads();
    // ---- reset path: da @ w_state^T; gate gradients; own dg slices
    ring.product(big, 0, slices, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n, c = c0 + cc;
      if (r >= nrows || c >= D) continue;
      const float dhr = slice_sum(part, slices, n, r, cc);
      dhp[e] = dhp[e] + dhr * rg[e];
      const float dr = dhr * hp[e];
      gv[e][0] = du[e] * ug[e] * (1.f - ug[e]);
      gv[e][1] = dr * rg[e] * (1.f - rg[e]);
      og[cc * kGroupRows + r] = gv[e][0];
      og[(n + cc) * kGroupRows + r] = gv[e][1];
    }
    cluster_arrive();
    // the next step's operands, then this step's dx_in and dx_gate rows:
    // issued after the arrive, whose release would otherwise wait for
    // these reads and writes too
    if (step + 1 < T) prefetch(step + 1);
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, c = c0 + item % n;
      if (r >= nrows || c >= D) continue;
      d.dx[(row0 + r) * a.ld_dproj + c] = dav[e];
      float* dg_row = d.dg + (row0 + r) * a.ld_dproj;
      dg_row[c] = gv[e][0];
      dg_row[D + c] = gv[e][1];
    }
    // ---- wait for the cluster's dg; gather every block's slices
    cluster_wait();
    pull_slices<kBwdCluster>(cluster, og, big, n, Dp, 2);
    __syncthreads();
    // ---- gate path: dg @ w_gates^T finishes the owned state gradients
    ring.product(big, 1, slices, part);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int item = tid + e * kClusterThreads;
      const int r = item / n, cc = item % n;
      if (r >= nrows || c0 + cc >= D) continue;
      dh[e] = dhp[e] + slice_sum(part, slices, n, r, cc);
    }
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int item = tid + e * kClusterThreads;
    const int r = item / n, c = c0 + item % n;
    if (r < nrows && c < D)
      d.dh0[(size_t)(b0 + r) * D + c] = dh[e];
  }
  // no block may leave while a peer can still read its shared memory
  cluster.sync();
}

}  // namespace

// The resident layout's dynamic shared memory in bytes, a block.
extern "C" int gru_train_smem_bytes(int D) {
  return bwd_layout(D).total * (int)sizeof(float);
}

// Whether the kernel covers width D on the current device: 1 or 0, or a
// negative CUDA error code.
extern "C" int gru_train_supported(int D) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return -err;
  return bwd_fits(D, max_smem) && fwd_fits(D, kBwdCluster, max_smem) ? 1 : 0;
}

extern "C" int gru_train_bwd_f32(const GruBwdArgs* args, int ndir,
                                 void* stream) {
  const int supported = gru_train_supported(args->D);
  if (supported < 0) return -supported;
  if (supported == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bwd_layout(args->D).total * sizeof(float);
  cudaError_t err = prepare_cluster_kernel(gru_bwd_kernel, kBwdCluster, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args->B + kGroupRows - 1) / kGroupRows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(groups * kBwdCluster, ndir), kBwdCluster, smem,
                     (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gru_bwd_kernel, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Whether the wide instance covers width D on the current device: 1 or 0,
// or a negative CUDA error code.
extern "C" int gru_train_wide_supported(int D) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return -err;
  return bwd_wide_fits(D, max_smem) ? 1 : 0;
}

// The wide layout's dynamic shared memory in bytes, a block.
extern "C" int gru_train_wide_smem_bytes(int D) {
  return bwd_wide_layout(D).r.total * (int)sizeof(float);
}

extern "C" int gru_train_wide_bwd_f32(const GruBwdWideArgs* args, int ndir,
                                      void* stream) {
  const int supported = gru_train_wide_supported(args->a.D);
  if (supported < 0) return -supported;
  if (supported == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)bwd_wide_layout(args->a.D).r.total * sizeof(float);
  cudaError_t err =
      prepare_cluster_kernel(gru_bwd_wide_kernel, kBwdCluster, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args->a.B + kGroupRows - 1) / kGroupRows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(groups * kBwdCluster, ndir), kBwdCluster, smem,
                     (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gru_bwd_wide_kernel, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
