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
// The training forward (ops/gru_train.py) is this kernel with its residual
// outputs set: the update gate, reset gate and candidate of every step,
// which the backward scan in gru_train.cu reads.
//
// What bounds it on the card: latency, not FLOPs or HBM.  The scan is 2*T
// dependent small products (gates, then candidate) over a few batch rows,
// with an exchange of the product's input between the blocks that share
// a row group after each.  What the design does about it (gru_pull.cuh):
//
// * the weights stay in shared memory: a cluster of kC blocks (16, a
//   non-portable size launched with cudaLaunchKernelEx, or 8) serves
//   kGroupRows batch rows of one direction, and block j keeps the n
//   columns [j*n, (j+1)*n) of w_gates' update and reset halves and of
//   w_state that it produces (n = ceil(D / kC) rounded up to even; Dp =
//   kC * n, the padding zero): 3*Dp*n floats, 48 KB at D=250 with 16
//   blocks.  The launcher picks kC from the number of clusters the launch
//   needs and cudaOccupancyMaxActiveClusters (ops/gru_scan.py): 16 unless
//   8 takes fewer waves;
// * pull, not push: a block writes its slice of r*h, and later of the new
//   state, once into its own k-major buffer; after the cluster barrier
//   every block pulls the peers' slices with 16-byte DSMEM loads;
// * a split barrier: between a block's arrive and its wait go the step's
//   global stores (out and, in training, the residuals u, r, c) and the
//   cp.async prefetch of the next step's gate inputs, input projections
//   and mask into a stage; each thread copies exactly the items it later
//   reads, so the stage needs no barrier;
// * short k-chains: a product thread computes 8 rows x 2 columns over one
//   of up to 8 k slices; the slices' partial sums are added in slice
//   order, so a second call repeats bit for bit.
//
// Buffer hazards (step s; A_s is the barrier after the r*h slices are
// written, B_s the one after the new state's):
// * h, own slice: written after A_s's wait.  Peers pull the previous
//   state's slice after B_{s-1} and before they arrive at A_s, and this
//   block read all of h (gate product, r*h of its columns) before its own
//   arrive at A_s: every reader is done.
// * r*h, own slice: written at step s+1 before A_{s+1}, after B_s's wait.
//   Peers pull step s's slice after A_s and before they arrive at B_s, and
//   this block's candidate product read r*h before its arrive at B_s.
// * h and r*h, the peers' slices: written only by this block's pulls
//   (after B_s and after A_s), read only by its own products; no peer
//   reads them.  The product before each pull ended before the barrier.
// * z, part: written and read inside the block, a barrier between.
// * the stage: a thread overwrites its own items after it has read them.
// * exit: the last remote load is the r*h pull of step T-1, before B_{T-1};
//   the last step skips the state pull, so no block leaves while a peer
//   can still read its shared memory.
//
// Widths whose weight slices and buffers do not fit in a block's shared
// memory (D above 448; 256 with 8 blocks) take the wide instance,
// gru_wide_kernel, up to D=1024 (gru_wide.cuh): the same cluster, items,
// exchanges and barriers, with the leading tiles of the weight slices
// resident and the rest streamed from L2 every step through a TMA ring
// that runs ahead across products and steps, and a thread finishing up to
// four gate and two candidate items (eight and four with 8 blocks).  It is
// a kernel of its own, chosen by width before the launch
// (ops/gru_scan.py::route), so the resident instance keeps its code.
// gru_scan_fits() and gru_scan_wide_fits() say what each covers before a
// launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gru_pull.cuh"
#include "gru_wide.cuh"
#include "sm90_async.cuh"

// Must match the ctypes.Structures in ops/gru_scan.py field for field.
struct GruDir {
  const float* x;        // x_proj: (t, b, c) at x[(t * B + b) * ldx + c]
  const float* g;        // gate_proj: (t, b, c) at g[(t * B + b) * ldg + c]
  const float* h0;       // (B, D)
  const float* w_state;  // (D, D)
  const float* w_gates;  // (D, 2D)
  float* out;            // (t, b, c) at out[(t * B + b) * ldo + c]
  float* u;              // residuals for training, (T, B, D) each, or null:
  float* r;              //   update gate, reset gate, candidate
  float* c;
  int reverse;           // visit t = T-1 .. 0
};

struct GruArgs {
  GruDir dir[2];
  const float* mask;     // (T, B) or null
  int T, B, D, ldx, ldg, ldo;
};

// The wide instance's arguments: the resident ones, and per direction the
// weights packed per block (ops/gru_scan.py::pack_forward): block j's
// slice at pack[(size_t)j * 3 * Dp * n], the owned [update | reset] gate
// columns (Dp, 2n) then the owned candidate columns (Dp, n), k-major,
// zero past D.
struct GruWideArgs {
  GruArgs a;
  const float* pack[2];
};

namespace {

constexpr int kGateItems = 2;      // (row, gate column) items per thread
constexpr int kCandItems = 1;      // (row, state column) items per thread

template <int kC>
__global__ void __launch_bounds__(kClusterThreads, 1)
    gru_fwd_kernel(const __grid_constant__ GruArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const GruDir& d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D;
  const FwdLayout o = fwd_layout(D, kC);
  const int n = o.n, n2 = 2 * o.n, Dp = o.Dp;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kC) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* wg = smem + o.wg;
  float* ws = smem + o.ws;
  float* hT = smem + o.h;
  float* rhT = smem + o.rh;
  float* z = smem + o.z;
  float* stage_g = smem + o.stage;            // gate items
  float* stage_x = stage_g + kGroupRows * n2; // candidate items
  float* stage_m = stage_x + kGroupRows * n;
  float* part = smem + o.part;
  const int tid = threadIdx.x;

  // the owned columns of both matrices, k-major (zero past D), and the
  // initial state of the row group; r * h zero (its padding stays so)
  for (int i = tid; i < Dp * n2; i += blockDim.x) {
    const int k = i / n2, cc = i % n2;
    const int c = c0 + (cc < n ? cc : cc - n);
    wg[i] = k < D && c < D
                ? d.w_gates[(size_t)k * 2 * D + (cc < n ? c : D + c)] : 0.f;
  }
  for (int i = tid; i < Dp * n; i += blockDim.x) {
    const int k = i / n, c = c0 + i % n;
    ws[i] = k < D && c < D ? d.w_state[(size_t)k * D + c] : 0.f;
  }
  for (int i = tid; i < Dp * kGroupRows; i += blockDim.x) {
    const int k = i / kGroupRows, r = i % kGroupRows;
    hT[i] = k < D && r < nrows ? d.h0[(size_t)(b0 + r) * D + k] : 0.f;
    rhT[i] = 0.f;
  }

  // this thread's items: gate item tid + e * kClusterThreads is (row,
  // column cc of 2n), candidate item tid is (row, column of n)
  auto gate_item = [&](int e, int& r, int& cc, int& c) {
    const int item = tid + e * kClusterThreads;
    r = item / n2;
    cc = item % n2;
    c = c0 + (cc < n ? cc : cc - n);
    return r < nrows && c < D;
  };
  const int cr = tid / n, ccc = tid % n, cc_col = c0 + ccc;
  const bool cand_ok = cr < nrows && cc_col < D;

  // the step's gate inputs, input projections and mask of this thread's
  // items into the stage
  auto prefetch = [&](int step) {
    const int t = d.reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
#pragma unroll
    for (int e = 0; e < kGateItems; ++e) {
      int r, cc, c;
      if (gate_item(e, r, cc, c))
        cp_async<4>(stage_g + tid + e * kClusterThreads,
                    d.g + (row0 + r) * a.ldg + (cc < n ? c : D + c), 4);
    }
    if (cand_ok) {
      cp_async<4>(stage_x + tid, d.x + (row0 + cr) * a.ldx + cc_col, 4);
      if (a.mask != nullptr)
        cp_async<4>(stage_m + tid, a.mask + row0 + cr, 4);
    }
    cp_async_commit();
  };
  prefetch(0);
  // weights and state in place, every block of the cluster running
  cluster.sync();

  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
    float gv[kGateItems];
    // ---- gates of the owned columns; own slice of r * h
    tile_partials(hT, wg, n2, Dp, o.slices_g, part);
    __syncthreads();
    cp_async_wait<0>();
#pragma unroll
    for (int e = 0; e < kGateItems; ++e) {
      int r, cc, c;
      gv[e] = 0.f;
      if (!gate_item(e, r, cc, c)) continue;
      gv[e] = sigmoidf(slice_sum(part, o.slices_g, n2, r, cc)
                       + stage_g[tid + e * kClusterThreads]);
      if (cc < n)
        z[r * n + cc] = gv[e];
      else
        rhT[c * kGroupRows + r] = gv[e] * hT[c * kGroupRows + r];
    }
    cluster_arrive();
    // this step's update and reset gates, for the training backward
    if (d.u != nullptr) {
#pragma unroll
      for (int e = 0; e < kGateItems; ++e) {
        int r, cc, c;
        if (gate_item(e, r, cc, c))
          (cc < n ? d.u : d.r)[(row0 + r) * D + c] = gv[e];
      }
    }
    // ---- wait for the cluster's r * h; pull the peers' slices
    cluster_wait();
    pull_peers<kC>(cluster, rhT, n, Dp, 1, j);
    __syncthreads();
    // ---- candidates of the owned columns; own slice of the new state
    tile_partials(rhT, ws, n, Dp, o.slices_c, part);
    __syncthreads();
    float cand = 0.f, hn = 0.f;
    if (cand_ok) {
      cand = tanhf(slice_sum(part, o.slices_c, n, cr, ccc) + stage_x[tid]);
      const float hold = hT[cc_col * kGroupRows + cr];
      const float up = z[cr * n + ccc];
      hn = up * cand + (1.f - up) * hold;
      if (a.mask != nullptr) {
        const float m = stage_m[tid];
        hn = m * hn + (1.f - m) * hold;
      }
      hT[cc_col * kGroupRows + cr] = hn;
    }
    cluster_arrive();
    // the next step's operands, then this step's stores: issued after the
    // arrive, whose release would otherwise wait for them too
    if (step + 1 < T) prefetch(step + 1);
    if (cand_ok) {
      d.out[(row0 + cr) * a.ldo + cc_col] = hn;
      if (d.c != nullptr) d.c[(row0 + cr) * D + cc_col] = cand;
    }
    // ---- wait for the cluster's new state; pull the peers' slices
    cluster_wait();
    if (step + 1 < T) {
      pull_peers<kC>(cluster, hT, n, Dp, 1, j);
      __syncthreads();
    }
  }
}

// The wide instance: gru_fwd_kernel's step with the weight slices in a
// WeightRing (the gate product 0, the candidate product 1) and kGI gate and
// kCI candidate items a thread.  The buffer hazards are the resident
// kernel's, the mask staged once a row in two steps' halves; the ring is
// the block's own, its slots passed between the copies and the readers by
// its mbarriers.
template <int kC>
__global__ void __launch_bounds__(kClusterThreads, 1)
    gru_wide_kernel(const __grid_constant__ GruWideArgs wa) {
  namespace cg = cooperative_groups;
  constexpr int kGI = wide_gate_items(kC), kCI = wide_cand_items(kC);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const GruArgs& a = wa.a;
  const GruDir& d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D;
  const WideLayout o = wide_layout(D, kC);
  const int n = o.n, n2 = 2 * o.n, Dp = o.Dp;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kC) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  const float* wg = wa.pack[blockIdx.y] + (size_t)j * 3 * Dp * n;
  const float* ws = wg + (size_t)Dp * n2;
  float* hT = smem + o.h;
  float* rhT = smem + o.rh;
  float* z = smem + o.z;
  float* stage_g = smem + o.stage;            // gate items
  float* stage_x = stage_g + kGroupRows * n2; // candidate items
  float* stage_m = stage_x + kGroupRows * n;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  WeightRing ring = ring_start(smem, o.r, RingTiles{wg, nullptr, n2, Dp,
                                                    o.kt_g, 0},
                               RingTiles{ws, nullptr, n, Dp, o.kt_c, 0}, T);

  // the initial state of the row group; r * h zero (its padding stays so)
  for (int i = tid; i < Dp * kGroupRows; i += blockDim.x) {
    const int k = i / kGroupRows, r = i % kGroupRows;
    hT[i] = k < D && r < nrows ? d.h0[(size_t)(b0 + r) * D + k] : 0.f;
    rhT[i] = 0.f;
  }

  // gate item e is (row, column cc of 2n), candidate item e (row, column
  // cc of n), each the thread's tid + e * kClusterThreads
  auto gate_item = [&](int e, int& r, int& cc, int& c) {
    const int item = tid + e * kClusterThreads;
    r = item / n2;
    cc = item % n2;
    c = c0 + (cc < n ? cc : cc - n);
    return r < nrows && c < D;
  };
  auto cand_item = [&](int e, int& r, int& cc) {
    const int item = tid + e * kClusterThreads;
    r = item / n;
    cc = item % n;
    return r < nrows && c0 + cc < D;
  };

  // the step's gate inputs and input projections of this thread's items
  // into the stage
  auto prefetch = [&](int step) {
    const int t = d.reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
#pragma unroll
    for (int e = 0; e < kGI; ++e) {
      int r, cc, c;
      if (gate_item(e, r, cc, c))
        cp_async<4>(stage_g + tid + e * kClusterThreads,
                    d.g + (row0 + r) * a.ldg + (cc < n ? c : D + c), 4);
    }
#pragma unroll
    for (int e = 0; e < kCI; ++e) {
      int r, cc;
      if (!cand_item(e, r, cc)) continue;
      const int slot = tid + e * kClusterThreads;
      cp_async<4>(stage_x + slot, d.x + (row0 + r) * a.ldx + c0 + cc, 4);
    }
    // the rows' mask, one copy a row, in the step parity's half: read
    // after the block barriers that follow this thread's wait for it, and
    // overwritten two steps on
    if (a.mask != nullptr && tid < nrows)
      cp_async<4>(stage_m + (step & 1) * kGroupRows + tid, a.mask + row0 + tid,
                  4);
    cp_async_commit();
  };
  prefetch(0);
  // state in place, every block of the cluster running
  cluster.sync();
  ring.wait_resident();

  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
    float gv[kGI];
    // ---- gates of the owned columns; own slice of r * h
    ring.product(hT, 0, o.slices_g, part);
    __syncthreads();
    cp_async_wait<0>();
#pragma unroll
    for (int e = 0; e < kGI; ++e) {
      int r, cc, c;
      gv[e] = 0.f;
      if (!gate_item(e, r, cc, c)) continue;
      gv[e] = sigmoidf(slice_sum(part, o.slices_g, n2, r, cc)
                       + stage_g[tid + e * kClusterThreads]);
      if (cc < n)
        z[r * n + cc] = gv[e];
      else
        rhT[c * kGroupRows + r] = gv[e] * hT[c * kGroupRows + r];
    }
    cluster_arrive();
    // this step's update and reset gates, for the training backward
    if (d.u != nullptr) {
#pragma unroll
      for (int e = 0; e < kGI; ++e) {
        int r, cc, c;
        if (gate_item(e, r, cc, c))
          (cc < n ? d.u : d.r)[(row0 + r) * D + c] = gv[e];
      }
    }
    // ---- wait for the cluster's r * h; pull the peers' slices
    cluster_wait();
    pull_peers<kC>(cluster, rhT, n, Dp, 1, j);
    __syncthreads();
    // ---- candidates of the owned columns; own slice of the new state
    ring.product(rhT, 1, o.slices_c, part);
    __syncthreads();
    float cand[kCI], hn[kCI];
#pragma unroll
    for (int e = 0; e < kCI; ++e) {
      int r, cc;
      cand[e] = hn[e] = 0.f;
      if (!cand_item(e, r, cc)) continue;
      const int slot = tid + e * kClusterThreads;
      const int col = c0 + cc;
      cand[e] = tanhf(slice_sum(part, o.slices_c, n, r, cc) + stage_x[slot]);
      const float hold = hT[col * kGroupRows + r];
      const float up = z[r * n + cc];
      hn[e] = up * cand[e] + (1.f - up) * hold;
      if (a.mask != nullptr) {
        const float m = stage_m[(step & 1) * kGroupRows + r];
        hn[e] = m * hn[e] + (1.f - m) * hold;
      }
      hT[col * kGroupRows + r] = hn[e];
    }
    cluster_arrive();
    // the next step's operands, then this step's stores: issued after the
    // arrive, whose release would otherwise wait for them too
    if (step + 1 < T) prefetch(step + 1);
#pragma unroll
    for (int e = 0; e < kCI; ++e) {
      int r, cc;
      if (!cand_item(e, r, cc)) continue;
      d.out[(row0 + r) * a.ldo + c0 + cc] = hn[e];
      if (d.c != nullptr) d.c[(row0 + r) * D + c0 + cc] = cand[e];
    }
    // ---- wait for the cluster's new state; pull the peers' slices
    cluster_wait();
    if (step + 1 < T) {
      pull_peers<kC>(cluster, hT, n, Dp, 1, j);
      __syncthreads();
    }
  }
}

template <int kC>
int max_clusters(int D, int* count) {
  const size_t smem = (size_t)fwd_layout(D, kC).total * sizeof(float);
  cudaError_t err = prepare_cluster_kernel(gru_fwd_kernel<kC>, kC, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(kC), kC, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(count, gru_fwd_kernel<kC>, &cfg);
}

template <int kC>
int launch(const GruArgs& args, int ndir, cudaStream_t stream) {
  const size_t smem = (size_t)fwd_layout(args.D, kC).total * sizeof(float);
  cudaError_t err = prepare_cluster_kernel(gru_fwd_kernel<kC>, kC, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args.B + kGroupRows - 1) / kGroupRows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(groups * kC, ndir), kC, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gru_fwd_kernel<kC>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the kernel covers width D with `cluster` (8 or 16) blocks on the
// current device: 1 or 0, or a negative CUDA error code.
extern "C" int gru_scan_fits(int D, int cluster) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return -err;
  return (cluster == 8 || cluster == 16) && fwd_fits(D, cluster, max_smem);
}

// The layout's dynamic shared memory in bytes, a block of `cluster`.
extern "C" int gru_scan_smem_bytes(int D, int cluster) {
  return fwd_layout(D, cluster).total * (int)sizeof(float);
}

// How many `cluster`-block clusters of the kernel at width D the current
// device holds at once (cudaOccupancyMaxActiveClusters) into *count; a
// CUDA error code.
extern "C" int gru_scan_max_clusters(int D, int cluster, int* count) {
  if (gru_scan_fits(D, cluster) != 1) return (int)cudaErrorInvalidValue;
  return cluster == 8 ? max_clusters<8>(D, count)
                      : max_clusters<16>(D, count);
}

// Launch with clusters of `cluster` (8 or 16) blocks; a CUDA error code.
extern "C" int gru_scan_f32(const GruArgs* args, int ndir, int cluster,
                            void* stream) {
  const int fits = gru_scan_fits(args->D, cluster);
  if (fits < 0) return -fits;
  if (fits == 0) return (int)cudaErrorInvalidValue;
  return cluster == 8 ? launch<8>(*args, ndir, (cudaStream_t)stream)
                      : launch<16>(*args, ndir, (cudaStream_t)stream);
}

// ---- the wide instance (gru_wide.cuh) -------------------------------------

namespace {

template <int kC>
int wide_max_clusters(int D, int* count) {
  const size_t smem = (size_t)wide_layout(D, kC).r.total * sizeof(float);
  cudaError_t err = prepare_cluster_kernel(gru_wide_kernel<kC>, kC, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(kC), kC, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(count, gru_wide_kernel<kC>,
                                             &cfg);
}

template <int kC>
int wide_launch(const GruWideArgs& args, int ndir, cudaStream_t stream) {
  const size_t smem =
      (size_t)wide_layout(args.a.D, kC).r.total * sizeof(float);
  cudaError_t err = prepare_cluster_kernel(gru_wide_kernel<kC>, kC, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args.a.B + kGroupRows - 1) / kGroupRows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(groups * kC, ndir), kC, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gru_wide_kernel<kC>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the wide instance covers width D with `cluster` (8 or 16) blocks
// on the current device: 1 or 0, or a negative CUDA error code.
extern "C" int gru_scan_wide_fits(int D, int cluster) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return -err;
  return wide_fits(D, cluster, max_smem) ? 1 : 0;
}

// The wide layout's dynamic shared memory in bytes, a block of `cluster`.
extern "C" int gru_scan_wide_smem_bytes(int D, int cluster) {
  return wide_layout(D, cluster).r.total * (int)sizeof(float);
}

// How many `cluster`-block clusters of the wide instance at width D the
// current device holds at once into *count; a CUDA error code.
extern "C" int gru_scan_wide_max_clusters(int D, int cluster, int* count) {
  if (gru_scan_wide_fits(D, cluster) != 1) return (int)cudaErrorInvalidValue;
  return cluster == 8 ? wide_max_clusters<8>(D, count)
                      : wide_max_clusters<16>(D, count);
}

// Launch the wide instance with clusters of `cluster` (8 or 16) blocks, the
// weights packed for that size; a CUDA error code.
extern "C" int gru_scan_wide_f32(const GruWideArgs* args, int ndir,
                                 int cluster, void* stream) {
  const int fits = gru_scan_wide_fits(args->a.D, cluster);
  if (fits < 0) return -fits;
  if (fits == 0) return (int)cudaErrorInvalidValue;
  return cluster == 8
             ? wide_launch<8>(*args, ndir, (cudaStream_t)stream)
             : wide_launch<16>(*args, ndir, (cudaStream_t)stream);
}
