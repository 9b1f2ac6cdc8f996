// The device's primary context, bound to the calling host thread: shared by
// every launcher that calls libcuda's API (flash_prefill's forward and
// backward, ssd_scan's bf16 forward) or that PyTorch's autograd engine calls
// on its device thread (ssd_scan's backward).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

// libcuda's tensor-map encoder (cuTensorMapEncodeTiled) needs a current
// context, which a host thread that has made no runtime call yet lacks
// (PyTorch runs a backward, and remat's recomputed forward, on its autograd
// engine's device thread, where it returned CUDA_ERROR_INVALID_CONTEXT):
// cudaSetDevice binds the current device's primary context to the thread.
// Called once at the top of a launch, before any map is encoded.
CUresult bind_context() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || cudaSetDevice(device) != cudaSuccess)
    return CUDA_ERROR_INVALID_CONTEXT;
  return CUDA_SUCCESS;
}

}  // namespace
