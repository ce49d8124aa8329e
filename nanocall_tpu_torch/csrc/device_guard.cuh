// The device guard of the plain C entries.
//
// An entry makes the launch's card current with cudaSetDevice.  PyTorch
// reads its current device back from the CUDA runtime, so an entry that
// left another card current would move the caller's next allocations on an
// unindexed "cuda" device to that card.  The guard restores the caller's
// device when the entry returns.

#pragma once

#include <cuda_runtime.h>

namespace nc {

struct DeviceGuard {
  int prev = 0;
  bool changed = false;
  cudaError_t err;

  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      changed = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (changed) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

}  // namespace nc
