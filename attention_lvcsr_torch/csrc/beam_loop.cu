// The whole-loop decode kernel's resident instances: every buffer of an
// utterance in its block's shared memory (beam_loop_body.cuh, which holds
// the body, the design and its bound).  They take every decode whose
// layout fits a block's 227 KB (ops/beam_loop.py::route); the workspace
// instances (beam_loop_ws.cu) take the rest.
#include "beam_loop_body.cuh"

extern "C" int beam_loop_smem_bytes(const BeamLoopArgs* args) {
  return layout_of<false>(*args).total * (int)sizeof(float);
}

extern "C" int beam_loop_f32(const BeamLoopArgs* args, void* stream) {
  return launch_instance<false>(args, beam_loop_smem_bytes(args),
                                (cudaStream_t)stream);
}
