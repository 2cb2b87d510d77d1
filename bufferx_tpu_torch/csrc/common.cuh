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

__device__ __forceinline__ uint32_t bx_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Returns once the mbarrier's phase of this parity has completed. A wait that
// outlasts kBxWaitLimitCycles (seconds) is a lost signal: it traps, so the
// launch fails with an error instead of hanging the card.
constexpr long long kBxWaitLimitCycles = 1ll << 33;

__device__ __forceinline__ void bx_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  long long since = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++spins > 1024u) {
      const long long now = clock64();
      if (since == 0) since = now;
      else if (now - since > kBxWaitLimitCycles) __trap();
    }
  } while (!done);
}
