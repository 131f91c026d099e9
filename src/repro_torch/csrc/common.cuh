// Shared helpers of the port's Hopper kernels (plain C interface, loaded
// with ctypes by repro_torch/kernels/_lib.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SAC_API extern "C" __attribute__((visibility("default")))

// Largest power-of-two vector width (16, 8, 4, 2 or 1 bytes) that divides
// the row length and the alignment of every base address.
static inline int sac_vec_bytes(long long row_bytes, const void* a,
                                const void* b) {
  uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)row_bytes;
  for (int w = 16; w > 1; w >>= 1)
    if ((bits & (uintptr_t)(w - 1)) == 0) return w;
  return 1;
}
