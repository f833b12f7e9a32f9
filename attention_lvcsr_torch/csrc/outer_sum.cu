// Weight gradients of the training scans: sums of outer products of rows.
//
//   C[i, j] += sum_{row < rows} A[row, i] * A2[row, i] * Bm[row, j]
//
// (A2 optional), for up to kMaxJobs independent (A, A2, Bm, C) jobs in one
// launch.  The TPU training kernels (attention_lvcsr_tpu/ops/pallas/
// gru_train.py, decoder_train.py, lstm_train.py) accumulate these products
// inside their reverse-time loops, one per step; here the recurrence
// kernels write the per-step gradient rows they produce anyway (dx_in,
// dx_gate, ...) and this kernel reduces them afterwards over all T*B rows
// at once, which takes the products off the recurrence's latency chain.
//
// What bounds it on the card: float32 FMAs (2*I*J per row) on the CUDA
// cores, 19.2 GFLOP for a bidirectional encoder layer at the flagship
// shapes (0.29 ms at 67 TFLOP/s).  Design, a SIMT product for Hopper:
//
// * one 128 x 256 tile of C per block of 512 threads, an 8 x 8 register
//   tile per thread (rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3,
//   128..131}), fed by four 16-byte shared-memory loads a row for 64
//   FMAs; 16 warps an SM hide the loads' latency;
// * rows stream through three shared-memory stages of 32 rows filled with
//   cp.async; each thread's copies of chunk k+2 are spread over the k
//   steps of chunk k (issued at once, they stall the issuing warps behind
//   the memory pipeline); one barrier per chunk;
// * the operands are column slices of wider tensors whose rows are often
//   only 8-byte aligned (D=250): the launch copies in the widest unit (16,
//   8 or 4 bytes) every operand's base and row stride allow, with the
//   ragged edge zero-filled by the copy itself;
// * the A2 gate is applied on the staged chunk by the thread that copied
//   those elements, right after its copies land, not on the load path;
// * the grid is the launch plan of ops/outer_sum.py: per job, its tiles
//   times its row splits, sized so the flagship layer's four jobs fill the
//   132 SMs in one wave; no block starts only to exit.  Each block stores
//   its partial tile in the workspace, and a second launch adds a tile's
//   splits into C in split order: the sums are fixed by the shapes alone
//   and repeat bit for bit (no atomics).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

constexpr int kMaxJobs = 8;

// Must match the ctypes.Structures in ops/outer_sum.py field for field.
struct OuterJob {
  const float* a;     // (rows, I) at a[row * lda + i]
  const float* a2;    // same layout (lda2), or null
  const float* b;     // (rows, J) at b[row * ldb + j]
  float* c;           // (I, J) row-major
  int rows, I, J, lda, lda2, ldb;
  int block0;         // the job's first block in the grid
  int tile0;          // the job's first tile in the reduction's grid
  int tiles_j;        // tiles along J (the job has tiles_i * tiles_j)
  int splits;         // row splits: consecutive blocks of one tile
  int split_rows;     // rows per split, a multiple of kChunk
};

struct OuterArgs {
  OuterJob job[kMaxJobs];
  float* ws;          // (blocks, kBM, kBN) partial tiles
  int njobs, blocks, tiles;
};

namespace {

constexpr int kReduceThreads = 256;

// The block's tile: kTY x kTX threads of (4 kFM) x (4 kFN) outputs, a
// kBM x kBN tile (128 x 256), rows in kStages stages of kChunk (192 KB in
// all), one block an SM.
constexpr int kTY = 16, kTX = 32, kFM = 2, kFN = 2;
constexpr int kThreads = kTY * kTX;
constexpr int kBM = 4 * kTY * kFM, kBN = 4 * kTX * kFN;
constexpr int kChunk = 32, kStages = 3;
constexpr int kSmemBytes = kStages * kChunk * (2 * kBM + kBN) * sizeof(float);
static_assert(kTX % 8 == 0 && kTY % 4 == 0, "warps of 4 x 8 threads");

// the job of a block (or of a tile, with the tile0 offsets)
__device__ __forceinline__ int job_of(const OuterArgs& args, int index,
                                      bool by_tile) {
  int k = 0;
  while (k + 1 < args.njobs
         && index >= (by_tile ? args.job[k + 1].tile0
                              : args.job[k + 1].block0))
    ++k;
  return k;
}

// the widest copy unit, in floats, that an operand's base and row stride
// keep aligned
__host__ inline int copy_floats(const float* p, int ld) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (at % 16 == 0 && ld % 4 == 0) return 4;
  if (at % 8 == 0 && ld % 2 == 0) return 2;
  return 1;
}

// a[0:W] *= a2[0:W] in one access of each
template <int W>
__device__ __forceinline__ void gate(float* a, const float* a2) {
  if constexpr (W == 4) {
    float4 x = *reinterpret_cast<float4*>(a);
    const float4 y = *reinterpret_cast<const float4*>(a2);
    x.x *= y.x;
    x.y *= y.y;
    x.z *= y.z;
    x.w *= y.w;
    *reinterpret_cast<float4*>(a) = x;
  } else if constexpr (W == 2) {
    float2 x = *reinterpret_cast<float2*>(a);
    const float2 y = *reinterpret_cast<const float2*>(a2);
    x.x *= y.x;
    x.y *= y.y;
    *reinterpret_cast<float2*>(a) = x;
  } else {
    a[0] *= a2[0];
  }
}

// The products.  The copy unit W (4, 2 or 1 floats) is the widest that
// every operand of the launch allows, so each thread's copies of a chunk
// are kSlots cp.asyncs known at compile time, spread over the k steps of
// the chunk before it: issued all at once, they stall the warps that
// issue them behind the memory pipeline's queue.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    outer_sum_kernel(const __grid_constant__ OuterArgs args) {
  constexpr int kPerRowA = kBM / W, kPerRowB = kBN / W;
  constexpr int kStepA = kThreads / kPerRowA, kStepB = kThreads / kPerRowB;
  constexpr int kSlotsA = kChunk / kStepA, kSlotsB = kChunk / kStepB;
  constexpr int kSlots = kSlotsA + kSlotsB;
  static_assert(kThreads % kPerRowA == 0 && kThreads % kPerRowB == 0
                    && kChunk % kStepA == 0 && kChunk % kStepB == 0,
                "whole rows per pass of the threads");
  extern __shared__ __align__(16) float smem[];
  const OuterJob& jb = args.job[job_of(args, blockIdx.x, false)];
  const int local = (int)blockIdx.x - jb.block0;
  const int tile = local / jb.splits, split = local % jb.splits;
  const int i0 = (tile / jb.tiles_j) * kBM, j0 = (tile % jb.tiles_j) * kBN;
  const int r0 = split * jb.split_rows;
  const int r1 = min(jb.rows, r0 + jb.split_rows);
  const int chunks = r1 > r0 ? (r1 - r0 + kChunk - 1) / kChunk : 0;
  const bool gated = jb.a2 != nullptr;
  float* As = smem;
  float* A2s = smem + kStages * kChunk * kBM;
  float* Bs = smem + 2 * kStages * kChunk * kBM;
  const int tid = threadIdx.x;
  const int ra = tid / kPerRowA, ca = (tid % kPerRowA) * W;
  const int rb = tid / kPerRowB, cb = (tid % kPerRowB) * W;
  const int va = max(0, min(W, jb.I - (i0 + ca))) * 4;   // bytes in range
  const int vb = max(0, min(W, jb.J - (j0 + cb))) * 4;

  auto copy_slot = [&](int ch, int sl) {
    const int st = ch % kStages;
    if (sl < kSlotsA) {
      const int rr = ra + sl * kStepA, row = r0 + ch * kChunk + rr;
      const int valid = row < r1 ? va : 0;
      const int at = (st * kChunk + rr) * kBM + ca;
      cp_async<W * 4>(As + at,
                      valid ? jb.a + (size_t)row * jb.lda + i0 + ca : jb.a,
                      valid);
      if (gated)
        cp_async<W * 4>(A2s + at,
                        valid ? jb.a2 + (size_t)row * jb.lda2 + i0 + ca
                              : jb.a2,
                        valid);
    } else {
      const int rr = rb + (sl - kSlotsA) * kStepB, row = r0 + ch * kChunk + rr;
      const int valid = row < r1 ? vb : 0;
      cp_async<W * 4>(Bs + (st * kChunk + rr) * kBN + cb,
                      valid ? jb.b + (size_t)row * jb.ldb + j0 + cb : jb.b,
                      valid);
    }
  };
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks)
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) copy_slot(c, sl);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarpsX = kTX / 8;
  const int ty = (warp / kWarpsX) * 4 + lane / 8;
  const int tx = (warp % kWarpsX) * 8 + lane % 8;
  float acc[4 * kFM][4 * kFN];
#pragma unroll
  for (int p = 0; p < 4 * kFM; ++p)
#pragma unroll
    for (int q = 0; q < 4 * kFN; ++q) acc[p][q] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();          // chunk c's copies have landed
    const int st = c % kStages;
    if (gated)                             // the A elements this thread copied
#pragma unroll
      for (int sl = 0; sl < kSlotsA; ++sl)
        gate<W>(As + (st * kChunk + ra + sl * kStepA) * kBM + ca,
                A2s + (st * kChunk + ra + sl * kStepA) * kBM + ca);
    __syncthreads();       // chunk c visible; stage (c - 1) % kStages free
    const int next = c + kStages - 1;
    const bool more = next < chunks;
    const float* as = As + st * kChunk * kBM + ty * 4;
    const float* bs = Bs + st * kChunk * kBN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      if (more)
#pragma unroll
        for (int sl = kk * kSlots / kChunk; sl < (kk + 1) * kSlots / kChunk;
             ++sl)
          copy_slot(next, sl);
      float av[4 * kFM], bv[4 * kFN];
#pragma unroll
      for (int g = 0; g < kFM; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + kk * kBM + g * 4 * kTY);
        av[4 * g] = v.x;
        av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z;
        av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < kFN; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + kk * kBN + g * 4 * kTX);
        bv[4 * g] = v.x;
        bv[4 * g + 1] = v.y;
        bv[4 * g + 2] = v.z;
        bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int p = 0; p < 4 * kFM; ++p)
#pragma unroll
        for (int q = 0; q < 4 * kFN; ++q)
          acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* out = args.ws + (size_t)blockIdx.x * kBM * kBN;
#pragma unroll
  for (int p = 0; p < 4 * kFM; ++p) {
    const int li = (p / 4) * 4 * kTY + ty * 4 + p % 4;
#pragma unroll
    for (int g = 0; g < kFN; ++g)
      *reinterpret_cast<float4*>(out + li * kBN + g * 4 * kTX + tx * 4) =
          make_float4(acc[p][4 * g], acc[p][4 * g + 1], acc[p][4 * g + 2],
                      acc[p][4 * g + 3]);
  }
}

// C += the sum of a tile's partial tiles, split 0 first.  Block (tile, y)
// takes kReduceThreads float4s of the tile.
__global__ void __launch_bounds__(kReduceThreads)
    outer_sum_reduce_kernel(const __grid_constant__ OuterArgs args) {
  const OuterJob& jb = args.job[job_of(args, blockIdx.x, true)];
  const int tile = (int)blockIdx.x - jb.tile0;
  const int e = (blockIdx.y * kReduceThreads + threadIdx.x) * 4;
  const int i = (tile / jb.tiles_j) * kBM + e / kBN;
  const int j = (tile % jb.tiles_j) * kBN + e % kBN;
  if (i >= jb.I || j >= jb.J) return;
  const float4* part = reinterpret_cast<const float4*>(
      args.ws + (size_t)(jb.block0 + tile * jb.splits) * kBM * kBN + e);
  float4 s = part[0];
#pragma unroll 4
  for (int k = 1; k < jb.splits; ++k) {
    const float4 v = part[(size_t)k * kBM * kBN / 4];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  float* c = jb.c + (size_t)i * jb.J + j;
  c[0] += s.x;
  if (j + 1 < jb.J) c[1] += s.y;
  if (j + 2 < jb.J) c[2] += s.z;
  if (j + 3 < jb.J) c[3] += s.w;
}

template <int W>
int launch(const OuterArgs* args, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      outer_sum_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  outer_sum_kernel<W><<<args->blocks, kThreads, kSmemBytes,
                        (cudaStream_t)stream>>>(*args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid(args->tiles, kBM * kBN / 4 / kReduceThreads);
  outer_sum_reduce_kernel<<<rgrid, kReduceThreads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's blocks, then the fixed-order sum of the splits: two launches,
// with the widest copy unit every operand's base and row stride allow.
extern "C" int outer_sum_f32(const OuterArgs* args, void* stream) {
  if (args->njobs < 1 || args->njobs > kMaxJobs || args->blocks < 1
      || args->tiles < 1)
    return (int)cudaErrorInvalidValue;
  int w = 4;
  for (int k = 0; k < args->njobs; ++k) {
    const OuterJob& jb = args->job[k];
    w = min(w, min(copy_floats(jb.a, jb.lda), copy_floats(jb.b, jb.ldb)));
    if (jb.a2 != nullptr) w = min(w, copy_floats(jb.a2, jb.lda2));
  }
  if (w == 4) return launch<4>(args, stream);
  if (w == 2) return launch<2>(args, stream);
  return launch<1>(args, stream);
}
