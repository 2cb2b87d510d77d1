// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// Every library exports its own copy, so each ctypes handle can name errors.
extern "C" const char* bx_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Squared distance in the fixed order (dx*dx + dy*dy) + dz*dz with every
// product and sum rounded on its own (no FMA contraction), so the kernel and
// its plain PyTorch version agree to the bit.
__device__ __forceinline__ float bx_sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
