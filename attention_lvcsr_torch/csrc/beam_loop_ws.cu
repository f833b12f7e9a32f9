// The whole-loop decode kernel's workspace instances (beam_loop_body.cuh,
// kWorkspace): the K-row buffers of an utterance in its rows of a global
// workspace of U x ws_stride floats that the wrapper allocates, the
// per-row scalars, mask, taps, handler and energy vector in shared memory
// (at K=512, L=2000 and 16 filters about 66 KB).  They take the decodes
// whose resident layout passes a block's shared memory: beams 18-512 at
// the flagship widths, long inputs, wsj_pyramide.yaml's D=2000 glimpses
// (ops/beam_loop.py::route).  The same instances as beam_loop.cu's, so no
// config routes differently by beam width alone.
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
  return launch_instance<true>(args, beam_loop_ws_smem_bytes(args),
                               (cudaStream_t)stream);
}
