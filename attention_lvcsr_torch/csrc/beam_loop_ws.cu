// The whole-loop decode kernel's workspace instances (beam_loop_body.cuh,
// kWorkspace): the K-row buffers of an utterance in its rows of a global
// workspace of U x ws_stride floats that the wrapper allocates, the
// per-row scalars, mask, taps, handler and energy vector in shared memory,
// beside the products' ring (beam_products_ws.cuh, 104 KB) and the
// selection area (select_k: at most 4.3 KB); at K=512, L=2000 and 16
// filters about 190 KB.  They take the decodes whose resident layout
// passes a block's shared memory: beams 18-512 at the flagship widths,
// long inputs, wsj_pyramide.yaml's D=2000 glimpses (ops/beam_loop.py::
// route).  The same instances as beam_loop.cu's, so no config routes
// differently by beam width alone.  Their products stream each table and
// the K input rows through the ring (the resident instances' split read
// the workspace rows one cache line a lane), and their selection finds
// the K rounds' picks in one pass.
#include "beam_loop_body.cuh"

// Shared-memory bytes a block of the workspace instance takes.
extern "C" int beam_loop_ws_smem_bytes(const BeamLoopArgs* args) {
  return layout_of<true>(*args).total * (int)sizeof(float);
}

// Workspace floats an utterance (Layout::stride).
extern "C" int beam_loop_ws_stride(const BeamLoopArgs* args) {
  return layout_of<true>(*args).stride;
}

// Refuses a beam past kMaxBeam and a workspace narrower than the layout
// or whose rows are not 16-byte aligned.
extern "C" int beam_loop_ws_f32(const BeamLoopArgs* args, void* stream) {
  if (args->K < 1 || args->K > kMaxBeam || args->ws == nullptr
      || args->ws_stride < beam_loop_ws_stride(args) || args->ws_stride % 4
      || reinterpret_cast<uintptr_t>(args->ws) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = beam_loop_ws_smem_bytes(args);
  return ring_phases(*args)
             ? launch_instance<2>(args, smem, (cudaStream_t)stream)
             : launch_instance<1>(args, smem, (cudaStream_t)stream);
}

// The arguments of the selection's test entry; must match the
// ctypes.Structure in ops/beam_loop.py field for field.
struct BeamSelectArgs {
  const float* costs;   // (G, K, V) candidate costs
  float* work;          // (G, K, V) the rounds' copy
  int* out;             // (G, 6, K) the picks
  int G, K, V;
};

namespace {

// The selection alone on G grids of K x V candidates, one block a grid:
// select_k's picks, then the resident instances' K rounds of block_argmin
// on a copy of the grid in `work` (the rounds mark their picks there).
// out (G, 6, K): select_k's source rows, symbols and cost bits, then the
// rounds'.
__global__ void __launch_bounds__(kThreads, 1)
select_test_kernel(const float* costs, float* work, int K, int V, int* out) {
  extern __shared__ float sm[];
  const int n = K * V, tid = threadIdx.x;
  const float* grid = costs + (size_t)blockIdx.x * n;
  float* copy = work + (size_t)blockIdx.x * n;
  int* o = out + (size_t)blockIdx.x * 6 * K;
  int* SRC = reinterpret_cast<int*>(sm);
  int* SYM = SRC + align4(K);
  float* CHOSEN = sm + 2 * align4(K);
  float* RED_V = sm + 3 * align4(K);
  int* RED_I = reinterpret_cast<int*>(RED_V + align4(kWarps + 1));
  float* SEL = RED_V + 2 * align4(kWarps + 1);
  select_k(grid, K, V, reinterpret_cast<unsigned long long*>(SEL),
           reinterpret_cast<int*>(SEL + sel_floats(K) - 4 * kWarps), SRC,
           SYM, CHOSEN);
  for (int s = tid; s < K; s += blockDim.x) {
    o[s] = SRC[s];
    o[K + s] = SYM[s];
    o[2 * K + s] = __float_as_int(CHOSEN[s]);
  }
  for (int j = tid; j < n; j += blockDim.x) copy[j] = grid[j];
  __syncthreads();
  for (int slot = 0; slot < K; ++slot) {
    float mv;
    int mi;
    block_argmin(copy, n, RED_V, RED_I, mv, mi);
    if (tid == 0) {
      SRC[slot] = mi / V;
      SYM[slot] = mi % V;
      CHOSEN[slot] = mv;
      copy[mi] = kBig;
    }
    __syncthreads();
  }
  for (int s = tid; s < K; s += blockDim.x) {
    o[3 * K + s] = SRC[s];
    o[4 * K + s] = SYM[s];
    o[5 * K + s] = __float_as_int(CHOSEN[s]);
  }
}

}  // namespace

// chip_smoke.py phase 25f's entry (ops/beam_loop.py::beam_select).
extern "C" int beam_select_ws_test(const BeamSelectArgs* args,
                                   void* stream) {
  const int K = args->K;
  if (args->G < 1 || K < 1 || K > kMaxBeam || args->V < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (3 * align4(K) + 2 * align4(kWarps + 1) + sel_floats(K))
                   * (int)sizeof(float);
  select_test_kernel<<<args->G, kThreads, smem, (cudaStream_t)stream>>>(
      args->costs, args->work, K, args->V, args->out);
  return (int)cudaGetLastError();
}
