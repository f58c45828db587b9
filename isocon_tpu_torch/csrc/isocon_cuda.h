// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ISOCON_API extern "C" __attribute__((visibility("default")))

// Every C entry point returns the launch's cudaError_t (0 = success): a
// refused launch never runs, and a later synchronize would not report it.
static inline int isocon_launch_status() {
  return static_cast<int>(cudaGetLastError());
}

// c ? a : b, opaque to the compiler: a chain of plain selects between
// slots may be folded into one load at a computed address, and the slots
// then move from registers to local memory.
__device__ __forceinline__ int pick(bool c, int a, int b) {
  int r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %3, 0;\n\t"
      "selp.b32 %0, %1, %2, p;\n\t}"
      : "=r"(r) : "r"(a), "r"(b), "r"(static_cast<int>(c)));
  return r;
}
