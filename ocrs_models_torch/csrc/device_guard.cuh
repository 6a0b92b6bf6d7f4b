// The calling thread's current CUDA device, saved where a C entry starts
// and restored when it returns, on every path: an entry selects the device
// of its tensors with cudaSetDevice, and a caller that serves several cards
// from one thread (PyTorch's current device) must find its own device
// selected again afterwards.

#pragma once

#include <cuda_runtime.h>

class RestoreDevice {
  public:
    RestoreDevice() {
        if (cudaGetDevice(&saved_) != cudaSuccess) saved_ = -1;
    }
    ~RestoreDevice() {
        if (saved_ >= 0) cudaSetDevice(saved_);
    }
    RestoreDevice(const RestoreDevice&) = delete;
    RestoreDevice& operator=(const RestoreDevice&) = delete;

  private:
    int saved_;
};
