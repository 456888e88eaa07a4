// The error text of every library built from csrc/: each kernel source
// includes this header once, so each shared library exports the same
// kernel_error_string, which ops/cuda/_build.py::Library reads after a call
// that returned non-zero. Every entry point returns 0, -1 for arguments
// outside what the kernel takes, or a cudaError_t code.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return code == -1 ? "arguments outside what the kernel takes"
                    : cudaGetErrorString(static_cast<cudaError_t>(code));
}
