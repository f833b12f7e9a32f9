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
// (16 x 4D) x (4D x D) product a step per cluster and one exchange.  The
// design is the GRU backward's (gru_train.cu, on gru_pull.cuh): a 16-block
// cluster (a non-portable size, launched with cudaLaunchKernelEx) serves
// 16 rows of one direction; block j owns the n state columns [j*n,
// (j+1)*n) (n = ceil(D/16) rounded up to even, Dp = 16n, the padding zero)
// and the 4n gate columns that belong to them; the carried gradients and
// peephole sums of its one (row, column) item a thread stay in registers.
// What the design does about the latency:
//
// * the product split by k, not by output: block j multiplies its own gate
//   gradients (16 rows x 4n) by the rows of w_state^T they meet (4n x Dp,
//   kept in shared memory for the whole scan, 64 KB at D=250), a partial
//   sum of every state column's gradient.  Each block then needs only the
//   sixteen partials of its own n columns: 16 KB a step come over
//   distributed shared memory where gathering every block's gate
//   gradients (the da @ w_state^T split by output) moved 64 KB, and the
//   probes put that gather at half of a step;
// * pull, not push: a block writes its partial once, into its own send
//   buffer; after the cluster barrier each thread loads its item's sixteen
//   partials from the peers with DSMEM loads, all in flight at once, and
//   adds them in block order, so the sum repeats bit for bit;
// * one split barrier a step: the send buffer is double-buffered (step s
//   writes buffer s % 2), so no second barrier has to keep a partial alive
//   until every peer has read it; the step's dx stores and the cp.async
//   prefetch of the next step's four gates, c_prev, dstates, dcells and
//   mask go between the arrive and the wait (a release arrive waits for
//   the thread's outstanding reads, and these would stall it); each
//   thread copies exactly the items it later reads, so the stage needs no
//   barrier;
// * short k-chains: a product thread computes 8 rows x 2 columns over one
//   of at most 8 k slices of the 4n-long sum (32 steps at D=250); the
//   slices' partial sums are added in slice order.
//
// Buffer hazards (step s; S_s is its barrier):
// * send buffer s % 2: written at step s before the arrive at S_s; every
//   block reads it after S_s and uses the values before its arrive at
//   S_{s+1}; it is written again at step s+2, after this block's wait at
//   S_{s+1}.
// * da, part: written and read inside the block, a barrier between.
// * the stage: a thread overwrites its own items after it has read them.
// * exit: a final cluster barrier, so no block leaves while a peer can
//   still read its send buffer.
//
// Widths whose weight slice and buffers do not fit in a block's shared
// memory (D above 352) are not covered: lstm_train_supported() says so
// before a launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gru_pull.cuh"
#include "sm90_async.cuh"

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

constexpr int kBwdCluster = 16;    // blocks per cluster (non-portable)
constexpr int kBwdOperands = 8;    // staged per item: the four gates,
                                   // c_prev, dstates, dcells, mask

// The backward's shared memory, offsets in floats, every buffer on a
// 16-byte boundary:
//   wt    (4n, Dp)  w_state[c][g*D + c0 + k] at row g*n + k, column c
//   da    (4n, kGroupRows) the block's own gate gradients, k-major
//   send  2 x (kGroupRows, Dp) the block's partial of every column's
//         state gradient
//   stage (kBwdOperands, kGroupRows * n) the next step's operands
//   part  the product's slice partial sums
// The slices are capped at kMaxSlices, halved while the layout does not
// fit in kMaxSmemFloats.
struct BwdLayout {
  int n, Dp, slices;
  int wt, da, send, stage, part, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int D) {
  BwdLayout o;
  o.n = owned_columns(D, kBwdCluster);
  o.Dp = kBwdCluster * o.n;
  o.wt = 0;
  o.da = o.wt + 4 * o.n * o.Dp;
  o.send = o.da + 4 * o.n * kGroupRows;
  o.stage = o.send + 2 * kGroupRows * o.Dp;
  o.part = o.stage + kBwdOperands * kGroupRows * o.n;
  for (int cap = kMaxSlices;; cap /= 2) {
    o.slices = tile_slices(o.Dp, cap);
    o.total = o.part + o.slices * kGroupRows * o.Dp;
    if (o.total <= kMaxSmemFloats || cap == 1) break;
  }
  return o;
}

__host__ inline bool bwd_fits(int D, int max_smem) {
  const BwdLayout o = bwd_layout(D);
  return kGroupRows * o.n <= kClusterThreads
         && (size_t)o.total * sizeof(float) <= (size_t)max_smem;
}

// The arguments stay in the constant bank (__grid_constant__) and the
// direction's pointers are read from there where they are used.
__global__ void __launch_bounds__(kClusterThreads, 1)
    lstm_bwd_kernel(const __grid_constant__ LstmBwdArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const LstmBwdDir& d = a.dir[blockIdx.y];
  const int T = a.T, B = a.B, D = a.D;
  const BwdLayout o = bwd_layout(D);
  const int n = o.n, Dp = o.Dp;
  const int j = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / kBwdCluster) * kGroupRows;
  const int nrows = min(kGroupRows, B - b0);
  const int c0 = j * n;                       // first owned column
  float* wt = smem + o.wt;
  float* daT = smem + o.da;
  float* send = smem + o.send;
  float* stage = smem + o.stage;
  float* part = smem + o.part;
  const int tid = threadIdx.x;
  const int items = kGroupRows * n;           // stage stride per operand

  // the columns of w_state that the owned gate columns meet, transposed
  // (zero past D); da zero (the padding's entries stay so)
  for (int i = tid; i < 4 * n * Dp; i += blockDim.x) {
    const int k = i / Dp, col = i % Dp;
    const int g = k / n, c = c0 + k % n;
    wt[i] = col < D && c < D ? d.w_state[(size_t)col * 4 * D + g * D + c]
                             : 0.f;
  }
  for (int i = tid; i < 4 * n * kGroupRows; i += blockDim.x) daT[i] = 0.f;
  // this thread's item (row r, owned column cc); its carried gradients and
  // peephole sums stay in registers
  const int r = tid / n, cc = tid % n, c = c0 + cc;
  const bool ok = r < nrows && c < D;
  const float pi = ok ? d.pci[c] : 0.f;
  const float pf = ok ? d.pcf[c] : 0.f;
  const float po = ok ? d.pco[c] : 0.f;
  float dh = 0.f, dc = 0.f, spi = 0.f, spf = 0.f, spo = 0.f;

  // the step's operands of this thread's item into the stage
  auto prefetch = [&](int step) {
    const int t = d.reverse ? step : T - 1 - step;
    const int tp = d.reverse ? t + 1 : t - 1;     // the forward's step before
    if (ok) {
      const size_t idx = (size_t)t * B + b0 + r;
      const size_t ridx = idx * D + c;
      float* s = stage + tid;
      cp_async<4>(s, d.gi + ridx, 4);
      cp_async<4>(s + items, d.gf + ridx, 4);
      cp_async<4>(s + 2 * items, d.gz + ridx, 4);
      cp_async<4>(s + 3 * items, d.go + ridx, 4);
      cp_async<4>(s + 4 * items,
                  tp < 0 || tp >= T
                      ? d.c0 + (size_t)(b0 + r) * D + c
                      : d.cs + ((size_t)tp * B + b0 + r) * a.ld_states + c,
                  4);
      cp_async<4>(s + 5 * items, d.dh + idx * a.ld_dout + c, 4);
      if (d.dc != nullptr)
        cp_async<4>(s + 6 * items, d.dc + idx * a.ld_dout + c, 4);
      if (a.mask != nullptr) cp_async<4>(s + 7 * items, a.mask + idx, 4);
    }
    cp_async_commit();
  };
  prefetch(0);
  // weights and zeroed buffers in place, every block of the cluster running
  cluster.sync();

  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? step : T - 1 - step;
    float* mine = send + (step & 1) * kGroupRows * Dp;
    float da[4] = {0.f, 0.f, 0.f, 0.f};
    float dh_keep = 0.f;
    // ---- elementwise: cell and gate gradients of the owned columns
    cp_async_wait<0>();
    if (ok) {
      const float* s = stage + tid;
      const float ig = s[0], fg = s[items], zg = s[2 * items];
      const float og = s[3 * items], cp = s[4 * items];
      const float g_h = dh + s[5 * items];
      const float g_c = d.dc != nullptr ? dc + s[6 * items] : dc;
      if (a.mask == nullptr || s[7 * items] != 0.f) {
        const float cn = fg * cp + ig * zg;
        const float hc = tanhf(cn);
        da[3] = g_h * hc * og * (1.f - og);
        const float dcn = g_h * og * (1.f - hc * hc) + da[3] * po + g_c;
        da[1] = dcn * cp * fg * (1.f - fg);
        da[0] = dcn * zg * ig * (1.f - ig);
        da[2] = dcn * ig * (1.f - zg * zg);
        dc = dcn * fg + da[1] * pf + da[0] * pi;
        spi += da[0] * cp;
        spf += da[1] * cp;
        spo += da[3] * cn;
      } else {
        dh_keep = g_h;
        dc = g_c;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
        daT[(g * n + cc) * kGroupRows + r] = da[g];
    }
    __syncthreads();
    // ---- own partial of every column's state gradient: da @ w_state^T
    tile_partials(daT, wt, Dp, 4 * n, o.slices, part);
    __syncthreads();
    // the slices' sums, four outputs at a time, in slice order
    for (int i = tid; i < kGroupRows * Dp / 4; i += blockDim.x) {
      float4 sum = reinterpret_cast<const float4*>(part)[i];
      for (int q = 1; q < o.slices; ++q) {
        const float4 v = reinterpret_cast<const float4*>(
            part + q * kGroupRows * Dp)[i];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      reinterpret_cast<float4*>(mine)[i] = sum;
    }
    cluster_arrive();
    // the next step's operands, then this step's dx row: issued after the
    // arrive, whose release would otherwise wait for them too
    if (step + 1 < T) prefetch(step + 1);
    if (ok) {
      float* dx_row = d.dx + ((size_t)t * B + b0 + r) * a.ld_dx;
#pragma unroll
      for (int g = 0; g < 4; ++g) dx_row[g * D + c] = da[g];
    }
    // ---- wait for the cluster's partials; add the owned columns'
    cluster_wait();
    if (ok) {
      float v[kBwdCluster];
#pragma unroll
      for (int q = 0; q < kBwdCluster; ++q)
        v[q] = cluster.map_shared_rank(mine, q)[r * Dp + c];
      float sum = v[0];
#pragma unroll
      for (int q = 1; q < kBwdCluster; ++q) sum += v[q];
      dh = dh_keep + sum;
    }
  }
  if (ok) {
    const size_t row = (size_t)(b0 + r);
    d.dh0[row * D + c] = dh;
    d.dc0[row * D + c] = dc;
    d.dpeep[row * 3 * D + c] = spi;
    d.dpeep[row * 3 * D + D + c] = spf;
    d.dpeep[row * 3 * D + 2 * D + c] = spo;
  }
  // no block may leave while a peer can still read its shared memory
  cluster.sync();
}

}  // namespace

// Whether the backward kernel covers width D on the current device (the
// forward covers every width it does): 1 or 0, or a negative CUDA error
// code.
extern "C" int lstm_train_supported(int D) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return -err;
  return bwd_fits(D, max_smem) ? 1 : 0;
}

// The backward layout's dynamic shared memory in bytes, a block.
extern "C" int lstm_train_smem_bytes(int D) {
  return bwd_layout(D).total * (int)sizeof(float);
}

extern "C" int lstm_train_bwd_f32(const LstmBwdArgs* args, int ndir,
                                  void* stream) {
  const int supported = lstm_train_supported(args->D);
  if (supported < 0) return -supported;
  if (supported == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bwd_layout(args->D).total * sizeof(float);
  cudaError_t err =
      prepare_cluster_kernel(lstm_bwd_kernel, kBwdCluster, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args->B + kGroupRows - 1) / kGroupRows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(groups * kBwdCluster, ndir), kBwdCluster, smem,
                     (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_kernel, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
