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
// (D x 4D) product per cluster, a few elementwise operations and one
// exchange of the new state between the blocks that share a row group.
// What the design does about it (gru_pull.cuh, as gru_scan.cu):
//
// * the weights stay in shared memory: a cluster of kC blocks (16, a
//   non-portable size launched with cudaLaunchKernelEx, or 8) serves
//   kGroupRows batch rows of one direction, and block j keeps the 4n
//   columns of w_state that produce the four gates of its state columns
//   [j*n, (j+1)*n) (n = ceil(D / kC) rounded up to even; Dp = kC * n, the
//   padding zero): 4*Dp*n floats, 64 KB at D=250 with 16 blocks.  The
//   launcher picks kC from the number of clusters the launch needs and
//   cudaOccupancyMaxActiveClusters (ops/lstm_scan.py): 16 unless 8 takes
//   fewer waves.  A thread finishes one (row, column) item, whose cell
//   stays in a register;
// * pull, not push: a block writes the new state of its columns once, into
//   its own k-major copy; after the cluster barrier every block pulls the
//   peers' slices with 16-byte DSMEM loads;
// * one split barrier a step: the state is double-buffered (step s reads
//   buffer s % 2 and writes the new state into the other), so nothing
//   but the new state has to be exchanged.  Between a block's arrive and
//   its wait go the step's global stores (states, cells and, in training,
//   the four gates) and the cp.async prefetch of the next step's input
//   projections and mask into a stage; each thread copies exactly the
//   items it later reads, so the stage needs no barrier;
// * short k-chains: a product thread computes 8 rows x 2 columns over one
//   of up to 8 k slices; the slices' partial sums are added in slice
//   order, so a second call repeats bit for bit.
//
// Buffer hazards (step s; S_s is its barrier):
// * state buffer (s+1) % 2, own slice: written at step s before the arrive
//   at S_s; peers pull it after S_s and before they arrive at S_{s+1}; it
//   is written again at step s+2, after this block's wait at S_{s+1}.
// * the same buffer, the peers' slices: written only by this block's pull
//   after S_s, read by its own product of step s+1 after a block barrier;
//   the pull of step s+2 into them follows that product's block barrier.
// * part: written and read inside the block, a barrier between.
// * the stage: a thread overwrites its own items after it has read them.
// * exit: the last step skips the pull, so the last remote load is the
//   pull of step T-2, before every block's arrive at S_{T-1}: no block
//   leaves while a peer can still read its shared memory.
//
// Widths whose weight slice and buffers do not fit in a block's shared
// memory (D above 384; 256 with 8 blocks) are not covered:
// lstm_scan_supported() says so before a launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gru_pull.cuh"
#include "sm90_async.cuh"

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

constexpr int kOperands = 5;   // staged per item: 4 input projections, mask

// The forward's shared memory, offsets in floats, every buffer on a
// 16-byte boundary (n is even, Dp a multiple of 16):
//   w     (Dp, 4n)  the owned gate columns [in | forget | cell | out],
//                   k-major
//   h     2 x (Dp, kGroupRows) the state, k-major, double-buffered
//   stage (kOperands, kGroupRows * n) the next step's operands, per item
//   part  the product's slice partial sums
// The slices are capped at kMaxSlices, halved while the layout does not
// fit in kMaxSmemFloats.
struct LstmLayout {
  int n, Dp, slices;
  int w, h, stage, part, total;
};

__host__ __device__ inline LstmLayout lstm_layout(int D, int cluster) {
  LstmLayout o;
  o.n = owned_columns(D, cluster);
  o.Dp = cluster * o.n;
  o.w = 0;
  o.h = o.w + o.Dp * 4 * o.n;
  o.stage = o.h + 2 * o.Dp * kGroupRows;
  o.part = o.stage + kOperands * kGroupRows * o.n;
  for (int cap = kMaxSlices;; cap /= 2) {
    o.slices = tile_slices(4 * o.n, cap);
    o.total = o.part + o.slices * kGroupRows * 4 * o.n;
    if (o.total <= kMaxSmemFloats || cap == 1) break;
  }
  return o;
}

// Each thread finishes at most one (row, column) item, and the layout fits
// in `max_smem`.
__host__ inline bool lstm_fits(int D, int cluster, int max_smem) {
  const LstmLayout o = lstm_layout(D, cluster);
  return kGroupRows * o.n <= kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

template <int kC>
__global__ void __launch_bounds__(kClusterThreads, 1)
    lstm_fwd_kernel(const __grid_constant__ LstmArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const LstmDir& d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D;
  const LstmLayout o = lstm_layout(D, kC);
  const int n = o.n, n4 = 4 * o.n, Dp = o.Dp;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kC) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* w = smem + o.w;
  float* hT = smem + o.h;
  float* stage = smem + o.stage;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int items = kGroupRows * n;           // stage stride per operand

  // gate column cc of the block: gate cc / n of state column c0 + cc % n
  // (zero past D); the initial state of the row group in buffer 0, buffer 1
  // zero (its padding stays so)
  for (int i = tid; i < Dp * n4; i += blockDim.x) {
    const int k = i / n4, cc = i % n4, c = c0 + cc % n;
    w[i] = k < D && c < D
               ? d.w_state[(size_t)k * 4 * D + (cc / n) * D + c] : 0.f;
  }
  for (int i = tid; i < Dp * kGroupRows; i += blockDim.x) {
    const int k = i / kGroupRows, r = i % kGroupRows;
    hT[i] = k < D && r < nrows ? d.h0[(size_t)(b0 + r) * D + k] : 0.f;
    hT[Dp * kGroupRows + i] = 0.f;
  }
  // this thread's item (row r, owned column cc); its cell and peepholes
  // stay in registers
  const int r = tid / n, cc = tid % n, c = c0 + cc;
  const bool ok = r < nrows && c < D;
  float cell = ok ? d.c0[(size_t)(b0 + r) * D + c] : 0.f;
  const float pi = ok ? d.pci[c] : 0.f;
  const float pf = ok ? d.pcf[c] : 0.f;
  const float po = ok ? d.pco[c] : 0.f;

  // the step's input projections and mask of this thread's item into the
  // stage
  auto prefetch = [&](int step) {
    const int t = d.reverse ? T - 1 - step : step;
    const size_t row = (size_t)t * B + b0 + r;
    if (ok) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        cp_async<4>(stage + g * items + tid, d.x + row * a.ldx + g * D + c,
                    4);
      if (a.mask != nullptr)
        cp_async<4>(stage + 4 * items + tid, a.mask + row, 4);
    }
    cp_async_commit();
  };
  prefetch(0);
  // weights and state in place, every block of the cluster running
  cluster.sync();

  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? T - 1 - step : step;
    const float* hcur = hT + (step & 1) * Dp * kGroupRows;
    float* hnext = hT + ((step & 1) ^ 1) * Dp * kGroupRows;
    // ---- gate pre-activations of the owned columns: h @ w_state
    tile_partials(hcur, w, n4, Dp, o.slices, part);
    __syncthreads();
    cp_async_wait<0>();
    // ---- cell and state update; own slice of the new state
    float h_out = 0.f, c_out = 0.f, ig = 0.f, fg = 0.f, zg = 0.f, og = 0.f;
    if (ok) {
      const float* s = stage + tid;
      const float a_i = slice_sum(part, o.slices, n4, r, cc) + s[0];
      const float a_f = slice_sum(part, o.slices, n4, r, n + cc) + s[items];
      const float a_z =
          slice_sum(part, o.slices, n4, r, 2 * n + cc) + s[2 * items];
      const float a_o =
          slice_sum(part, o.slices, n4, r, 3 * n + cc) + s[3 * items];
      const bool keep = a.mask == nullptr || s[4 * items] != 0.f;
      ig = sigmoidf(a_i + cell * pi);
      fg = sigmoidf(a_f + cell * pf);
      zg = tanhf(a_z);
      const float cn = fg * cell + ig * zg;
      og = sigmoidf(a_o + cn * po);
      const float hn = og * tanhf(cn);
      h_out = keep ? hn : hcur[c * kGroupRows + r];
      c_out = keep ? cn : cell;
      cell = c_out;
      hnext[c * kGroupRows + r] = h_out;
    }
    cluster_arrive();
    // the next step's operands, then this step's stores: issued after the
    // arrive, whose release would otherwise wait for them too
    if (step + 1 < T) prefetch(step + 1);
    if (ok) {
      const size_t idx = (size_t)t * B + b0 + r;
      d.hs[idx * a.ldo + c] = h_out;
      d.cs[idx * a.ldo + c] = c_out;
      if (d.gi != nullptr) {
        const size_t ridx = idx * D + c;
        d.gi[ridx] = ig;
        d.gf[ridx] = fg;
        d.gz[ridx] = zg;
        d.go[ridx] = og;
      }
    }
    // ---- wait for the cluster's new state; pull the peers' slices
    cluster_wait();
    if (step + 1 < T) {
      pull_peers<kC>(cluster, hnext, n, Dp, 1, j);
      __syncthreads();
    }
  }
}

template <int kC>
int max_clusters(int D, int* count) {
  const size_t smem = (size_t)lstm_layout(D, kC).total * sizeof(float);
  cudaError_t err = prepare_cluster_kernel(lstm_fwd_kernel<kC>, kC, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(kC), kC, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(count, lstm_fwd_kernel<kC>,
                                             &cfg);
}

template <int kC>
int launch(const LstmArgs& args, int ndir, cudaStream_t stream) {
  const size_t smem = (size_t)lstm_layout(args.D, kC).total * sizeof(float);
  cudaError_t err = prepare_cluster_kernel(lstm_fwd_kernel<kC>, kC, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args.B + kGroupRows - 1) / kGroupRows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(groups * kC, ndir), kC, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<kC>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the kernel covers width D with `cluster` (8 or 16) blocks on the
// current device: 1 or 0, or a negative CUDA error code.
extern "C" int lstm_scan_fits(int D, int cluster) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return -err;
  return (cluster == 8 || cluster == 16) && lstm_fits(D, cluster, max_smem);
}

// Whether the kernel covers width D on the current device (with 16-block
// clusters, the widest layout): 1 or 0, or a negative CUDA error code.
extern "C" int lstm_scan_supported(int D) { return lstm_scan_fits(D, 16); }

// The layout's dynamic shared memory in bytes, a block of `cluster`.
extern "C" int lstm_scan_smem_bytes(int D, int cluster) {
  return lstm_layout(D, cluster).total * (int)sizeof(float);
}

// How many `cluster`-block clusters of the kernel at width D the current
// device holds at once (cudaOccupancyMaxActiveClusters) into *count; a
// CUDA error code.
extern "C" int lstm_scan_max_clusters(int D, int cluster, int* count) {
  if (lstm_scan_fits(D, cluster) != 1) return (int)cudaErrorInvalidValue;
  return cluster == 8 ? max_clusters<8>(D, count)
                      : max_clusters<16>(D, count);
}

// Launch with clusters of `cluster` (8 or 16) blocks; a CUDA error code.
extern "C" int lstm_scan_f32(const LstmArgs* args, int ndir, int cluster,
                             void* stream) {
  const int fits = lstm_scan_fits(args->D, cluster);
  if (fits < 0) return -fits;
  if (fits == 0) return (int)cudaErrorInvalidValue;
  return cluster == 8 ? launch<8>(*args, ndir, (cudaStream_t)stream)
                      : launch<16>(*args, ndir, (cudaStream_t)stream);
}
