// The launch helper that lets a kernel take more than 48 KB of dynamic
// shared memory, once per device: attention_energy.cu, decode_score.cu
// (through energy_tile.cuh) and frontend.cu.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kMaxDevices = 64;

// The dynamic shared memory one kernel instance may take on each device:
// cudaFuncSetAttribute belongs to a device's context.
struct SmemAllowance {
  int bytes[kMaxDevices] = {};
};

std::mutex g_allowance_lock;

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device: cudaFuncSetAttribute once per device and larger size, recorded
// in `allowed` (one per kernel instance).
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, SmemAllowance& allowed,
                               int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(g_allowance_lock);
  const bool known = dev < kMaxDevices;
  if (known && smem <= allowed.bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && known) allowed.bytes[dev] = smem;
  return err;
}

}  // namespace
