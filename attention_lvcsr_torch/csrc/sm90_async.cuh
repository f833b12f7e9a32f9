// Asynchronous global-to-shared copies, split cluster barriers and
// mbarriers (sm_90), as inline PTX: the pipelines of outer_sum.cu,
// gru_train.cu and gru_wide.cuh.
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
//
// The mbarrier helpers and bulk_copy() are the pieces of a TMA ring
// (gru_wide.cuh): one thread copies a whole contiguous chunk from global
// into shared memory with one cp.async.bulk, whose bytes complete the
// transaction count of a "full" barrier (mbar_arrive_expect_tx); the
// readers wait on its phase (mbar_wait) and release the slot by arriving
// on an "empty" barrier (mbar_arrive_last tells the last arrival).  The
// addresses and size of a bulk copy are multiples of 16 bytes.  mbar_wait
// traps after 2^26 polls (seconds), so that a lost phase ends the launch
// with an error instead of hanging the card.
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// one thread: a barrier expecting `count` arrivals a phase
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// after the inits, before a block barrier: the barriers visible to the
// block and to the bulk copies
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive (release); whether this arrival completed the phase, read from
// the pending count the arrival saw (unique to the last arrival)
__device__ __forceinline__ bool mbar_arrive_last(unsigned long long* bar) {
  unsigned pending;
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%1];\n\t"
               "mbarrier.pending_count.b64 %0, st;\n\t}\n"
               : "=r"(pending) : "r"(smem_addr(bar)) : "memory");
  return pending == 1;
}

// arrive, and expect `bytes` more of the phase's bulk copies
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;"
               "\n\t}\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed (acquire)
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  const unsigned a = smem_addr(bar);
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                 "\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// one thread: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing `bar`'s transactions
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

}  // namespace
