// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel here takes bf16 operands, multiplies them on the tensor
// cores through nvcuda::wmma 16x16x16 bf16 fragments and accumulates in
// f32. Row-major matrices everywhere; a fragment pointer must be 32-byte
// aligned, so shared-memory row strides below are chosen so that every
// 16-row fragment start lands on a 32-byte boundary.
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Store one 16x16 f32 accumulator as bf16 rows of a row-major global
// matrix (row stride ld elements). scratch: 256 floats private to the
// warp. Rows at or past n_rows are skipped.
__device__ __forceinline__ void store_frag_bf16(const FragC& acc,
                                                float* scratch, bf16* dst,
                                                int ld, int row0, int n_rows,
                                                int col0) {
  wm::store_matrix_sync(scratch, acc, 16, wm::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c = (lane & 1) * 8;
  if (row0 + r < n_rows) {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = f2bf(scratch[r * 16 + c + i]);
    st8(dst + (size_t)(row0 + r) * ld + col0 + c,
        *reinterpret_cast<uint4*>(v));
  }
  __syncwarp();
}

// Raise the dynamic shared-memory cap of a kernel once per process.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
