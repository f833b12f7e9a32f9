// Weight gradients of the training scans: sums of outer products of rows.
//
//   C[i, j] += sum_{row < rows} A[row, i] * A2[row, i] * Bm[row, j]
//
// (A2 optional), for up to kMaxJobs independent (A, A2, Bm, C) jobs in one
// launch.  The TPU training kernels (attention_lvcsr_tpu/ops/pallas/
// gru_train.py, decoder_train.py) accumulate these products inside their
// reverse-time loops, one per step; here the recurrence kernels write the
// per-step gradient rows they produce anyway (dx_in, dx_gate, ...) and this
// kernel reduces them afterwards over all T*B rows at once, which takes the
// products off the recurrence's latency chain.
//
// What bounds it on the card: float32 FMAs (2*I*J per row) on the CUDA
// cores, about 10 GFLOP per bidirectional encoder layer at the flagship
// shapes.  Design: one 64x64 tile of C per block, 256 threads with a 4x4
// register tile each, rows streamed through shared memory 16 at a time; the
// rows are split over gridDim.y blocks, each of which stores its partial
// tile in the job's (splits, I, J) workspace, and a second launch adds the
// splits into C in a fixed order, so a gradient is the same bit for bit
// from run to run.
#include <cuda_runtime.h>

constexpr int kMaxJobs = 8;

// Must match the ctypes.Structures in ops/outer_sum.py field for field.
struct OuterJob {
  const float* a;     // (rows, I) at a[row * lda + i]
  const float* a2;    // same layout (lda2), or null
  const float* b;     // (rows, J) at b[row * ldb + j]
  float* c;           // (I, J) row-major
  float* ws;          // (splits, I, J) partial sums
  int rows, I, J, lda, lda2, ldb;
};

struct OuterArgs {
  OuterJob job[kMaxJobs];
  int njobs;
};

namespace {

constexpr int kTile = 64, kChunk = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    outer_sum_kernel(OuterArgs args) {
  const OuterJob jb = args.job[blockIdx.z];
  const int tiles_j = (jb.J + kTile - 1) / kTile;
  const int tiles = tiles_j * ((jb.I + kTile - 1) / kTile);
  if ((int)blockIdx.x >= tiles) return;
  const int i0 = (blockIdx.x / tiles_j) * kTile;
  const int j0 = (blockIdx.x % tiles_j) * kTile;
  const int per = (jb.rows + gridDim.y - 1) / gridDim.y;
  const int r0 = blockIdx.y * per, r1 = min(jb.rows, r0 + per);
  __shared__ float as[kChunk][kTile], bs[kChunk][kTile];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  for (int base = r0; base < r1; base += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      const int rr = e / kTile, cc = e % kTile, row = base + rr;
      float av = 0.f, bv = 0.f;
      if (row < r1) {
        if (i0 + cc < jb.I) {
          av = jb.a[(size_t)row * jb.lda + i0 + cc];
          if (jb.a2 != nullptr) av *= jb.a2[(size_t)row * jb.lda2 + i0 + cc];
        }
        if (j0 + cc < jb.J) bv = jb.b[(size_t)row * jb.ldb + j0 + cc];
      }
      as[rr][cc] = av;
      bs[rr][cc] = bv;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      float a4[4], b4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a4[q] = as[rr][ty * 4 + q];
        b4[q] = bs[rr][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a4[p], b4[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (i < jb.I && j < jb.J)
        jb.ws[((size_t)blockIdx.y * jb.I + i) * jb.J + j] = acc[p][q];
    }
  }
}

// C += the sum of the splits' partial tiles, split 0 first.
__global__ void __launch_bounds__(kThreads)
    outer_sum_reduce_kernel(OuterArgs args, int splits) {
  const OuterJob jb = args.job[blockIdx.y];
  const size_t n = (size_t)jb.I * jb.J;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += jb.ws[k * n + e];
    jb.c[e] += s;
  }
}

}  // namespace

// ``splits`` blocks share each job's rows; two launches.
extern "C" int outer_sum_f32(const OuterArgs* args, int splits, void* stream) {
  if (args->njobs < 1 || args->njobs > kMaxJobs || splits < 1)
    return (int)cudaErrorInvalidValue;
  int tiles = 1, size = 1;
  for (int k = 0; k < args->njobs; ++k) {
    const OuterJob& jb = args->job[k];
    tiles = max(tiles, ((jb.I + kTile - 1) / kTile)
                           * ((jb.J + kTile - 1) / kTile));
    size = max(size, jb.I * jb.J);
  }
  const dim3 grid(tiles, splits, args->njobs);
  outer_sum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid(min((size + kThreads - 1) / kThreads, 256), args->njobs);
  outer_sum_reduce_kernel<<<rgrid, kThreads, 0, (cudaStream_t)stream>>>(
      *args, splits);
  return (int)cudaGetLastError();
}
