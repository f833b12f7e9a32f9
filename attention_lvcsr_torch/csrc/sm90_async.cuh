// Asynchronous global-to-shared copies and split cluster barriers (sm_90),
// as inline PTX: the pipelines of outer_sum.cu and gru_train.cu.
//
// cp_async<bytes>(dst, src, valid) copies 4, 8 or 16 bytes from global
// memory into shared memory without passing through registers; only the
// first `valid` bytes are read and the rest of the destination is
// zero-filled, so a ragged edge needs no branch around the copy.  A thread
// sees its own copies after cp_async_wait; other threads see them only
// after a barrier that follows that wait.
//
// cluster_arrive() / cluster_wait() split cluster.sync() in two: a thread
// arrives (release: its shared-memory writes are published to the
// cluster), may do work that touches no cluster-shared data, and waits
// (acquire) until every thread of the cluster has arrived.
#pragma once
#include <cuda_runtime.h>

namespace {

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int valid) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "4, 8 or 16");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(kBytes), "r"(valid) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's committed groups are open
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace
