// What the CSA kernels share (csa_stencil.cu: K4 and row 5; csa_attention.cu:
// rows 6 and 8): the flagship constants they are compiled for, the query and
// key tile loads, the 64 x 64 score tile and pass (a), the per-query
// softmax stats m_i = max_l scale q_i . k_l and l_i = sum_l exp(scale
// q_i . k_l - m_i).
//
// q_i is the 3x3 zero-padded match neighbourhood of query pixel i (9Cr,
// tap-major): read from an explicit bank (B, P, 9Cr), or assembled from
// the match map (B, Hp, Wp, Cr). k_l is the normalized 3x3 key patch l,
// from (B, L, 9Cr).
#pragma once

#include "common.cuh"

namespace {

constexpr int CR = 32;          // match channels
constexpr int QK = 9 * CR;      // 288
constexpr int C = 64;           // embedding channels
constexpr int S = 2;            // CSA scale
constexpr int SC2 = S * S * C;  // 256: the s^2 phase planes of one key
constexpr int LDQ = QK + 16;    // 304 bf16: 16-row starts 32B-aligned
constexpr int THREADS = 256;
constexpr int TQ = 64;          // query rows of a score tile
constexpr int TK = 64;          // keys of a score tile
constexpr int LDS = TK + 4;     // 68 f32 score row stride

// q_i into row dst (QK bf16): tap t, 8-vector v of the 3x3 zero-padded
// match taps around (iy, ix)
__device__ __forceinline__ void load_query(const bf16* match, int b, int Hp,
                                           int Wp, int iy, int ix, bool ok,
                                           int t, int v, bf16* dst) {
  uint4 val = zero8();
  const int yy = iy + t / 3 - 1, xx = ix + t % 3 - 1;
  if (ok && yy >= 0 && yy < Hp && xx >= 0 && xx < Wp)
    val = ld8(match + ((size_t)(b * Hp + yy) * Wp + xx) * CR + v * 8);
  st8(dst + t * CR + v * 8, val);
}

// query rows i0 .. i0 + TQ into qs (zero past P), from the bank q
// (B, P, QK) or, without BANKS, from the match map q (B, Hp, Wp, CR)
template <bool BANKS>
__device__ __forceinline__ void load_q_tile(const bf16* q, int b, int P,
                                            int Hp, int Wp, int i0,
                                            bf16* qs) {
  for (int idx = threadIdx.x; idx < TQ * (QK / 8); idx += THREADS) {
    const int r = idx / (QK / 8), v = idx % (QK / 8);
    const int i = i0 + r;
    if (BANKS)
      st8(qs + r * LDQ + v * 8,
          i < P ? ld8(q + ((size_t)b * P + i) * QK + v * 8) : zero8());
    else
      load_query(q, b, Hp, Wp, i / Wp, i % Wp, i < P, v / (CR / 8),
                 v % (CR / 8), qs + r * LDQ);
  }
}

// keys l0 .. l0 + TK into ks (zero past L)
__device__ __forceinline__ void load_k_tile(const bf16* k, int b, int L,
                                            int l0, bf16* ks) {
  for (int idx = threadIdx.x; idx < TK * (QK / 8); idx += THREADS) {
    const int r = idx / (QK / 8), v = idx % (QK / 8);
    const int l = l0 + r;
    st8(ks + r * LDQ + v * 8,
        l < L ? ld8(k + ((size_t)b * L + l) * QK + v * 8) : zero8());
  }
}

// raw scores q . k of the TQ x TK tile into ss (row stride LDS); warp w
// holds fragments (w / 2, 2 (w % 2) + j)
__device__ __forceinline__ void score_tile(const bf16* qs, const bf16* ks,
                                           float* ss) {
  const int warp = threadIdx.x >> 5;
  const int rf = warp >> 1, cf0 = (warp & 1) * 2;
  FragC acc[2];
  wm::fill_fragment(acc[0], 0.f);
  wm::fill_fragment(acc[1], 0.f);
  FragA fa;
  FragBt fb;
  for (int k = 0; k < QK; k += 16) {
    wm::load_matrix_sync(fa, qs + (16 * rf) * LDQ + k, LDQ);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wm::load_matrix_sync(fb, ks + (16 * (cf0 + j)) * LDQ + k, LDQ);
      wm::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wm::store_matrix_sync(ss + (16 * rf) * LDS + 16 * (cf0 + j), acc[j], LDS,
                          wm::mem_row_major);
}

// ---------------------------------------------------------------- pass (a)
// One block per TQ query rows; online max and sum over key tiles. Keys past
// L are masked. m_out, l_out: (B, P) f32.
constexpr int SMEM_STATS = (TQ + TK) * LDQ * 2 + TQ * LDS * 4;

template <bool BANKS>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             float* __restrict__ m_out, float* __restrict__ l_out, int P,
             int L, int Hp, int Wp, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TQ * LDQ;
  float* ss = reinterpret_cast<float*>(ks + TK * LDQ);
  const int b = blockIdx.y, i0 = blockIdx.x * TQ;
  load_q_tile<BANKS>(q, b, P, Hp, Wp, i0, qs);
  const int r = threadIdx.x >> 2, sub = threadIdx.x & 3;  // 4 threads a row
  float m_run = -INFINITY, l_run = 0.f;
  for (int l0 = 0; l0 < L; l0 += TK) {
    load_k_tile(k, b, L, l0, ks);
    __syncthreads();
    score_tile(qs, ks, ss);
    __syncthreads();
    float mloc = -INFINITY;
    for (int c = sub * 16; c < sub * 16 + 16; ++c)
      if (l0 + c < L) mloc = fmaxf(mloc, ss[r * LDS + c] * scale);
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m_run, mloc);
    float sloc = 0.f;
    for (int c = sub * 16; c < sub * 16 + 16; ++c)
      if (l0 + c < L) sloc += __expf(ss[r * LDS + c] * scale - m_new);
    sloc += __shfl_xor_sync(0xffffffffu, sloc, 1);
    sloc += __shfl_xor_sync(0xffffffffu, sloc, 2);
    l_run = l_run * __expf(m_run - m_new) + sloc;
    m_run = m_new;
    __syncthreads();
  }
  if (sub == 0 && i0 + r < P) {
    m_out[(size_t)b * P + i0 + r] = m_run;
    l_out[(size_t)b * P + i0 + r] = l_run;
  }
}

}  // namespace
