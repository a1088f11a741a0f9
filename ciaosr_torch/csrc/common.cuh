// Shared helpers for the port's Hopper kernels (sm_90a): bf16 types and
// conversions, small index and vector helpers, the dynamic shared-memory
// cap, and the nvcuda::wmma 16x16x16 bf16 fragment types that the kernels
// still on their first design use (row 5's csa_stencil.cu and row 8's
// csa_attention.cu, through csa_tiles.cuh); the others are on wgmma and
// TMA (sm90.cuh). Row-major matrices everywhere; a wmma fragment pointer
// must be 32-byte aligned, so shared-memory row strides there are chosen
// so that every 16-row fragment start lands on a 32-byte boundary.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace wm = nvcuda::wmma;

typedef __nv_bfloat16 bf16;
typedef wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> FragA;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> FragB;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> FragBt;
typedef wm::fragment<wm::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// round an f32 value through bf16 and back (a cast to bf16 storage)
__device__ __forceinline__ float bfround(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 8 consecutive bf16 values (16 bytes) as one vector load / store
__device__ __forceinline__ uint4 ld8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st8(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ uint4 zero8() { return make_uint4(0, 0, 0, 0); }

// Raise the dynamic shared-memory cap of a kernel once per process.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
