// Shared helpers for the port's Hopper kernels (sm_90a): bf16 types and
// conversions, small index and vector helpers, and the dynamic
// shared-memory cap. The TMA and wgmma machinery is in sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// round an f32 value through bf16 and back (a cast to bf16 storage)
__device__ __forceinline__ float bfround(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 8 consecutive bf16 values (16 bytes) as one vector load
__device__ __forceinline__ uint4 ld8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 zero8() { return make_uint4(0, 0, 0, 0); }

// Raise the dynamic shared-memory cap of a kernel once per process.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
