// K4 csa_stencil: the middle of cross-scale attention (average=True).
//
// Replaces ciaosr_tpu/ops/pallas/csa_attention.py::csa_stencil_fused
// (kernel _csa_stencil_fused_kernel). With q_i the 3x3 zero-padded match
// neighbourhood of query pixel i (9Cr wide, tap-major), k_l the normalized
// 3x3 key patch l of the s-downsampled match map and P_l the s^2 phase
// planes of the embedding at key l (P_l[(a,b), c] = embed[s*ly+a, s*lx+b, c]):
//   A   = softmax_l(scale * q_i . k_l)
//   M[i, l] = sum_{d in {-1,0,1}^2} A[i + d, l + d]   (2-D shifts: d moves
//             the query in the Hp x Wp grid and the key in the Hq x Wq grid;
//             out-of-grid terms are zero)
//   out[s*iy + a, s*ix + b, c] = sum_l M[i, l] P_l[(a,b), c]
// (derivation: csa_attention.py:562-591). Output (B, s*Hp, s*Wp, C) f32,
// before the down conv and the /6.
//
// The TPU keeps a (TP+2HR) x (L+2HC) block of A in VMEM (~29 MB at the
// 192 tile); an SM has 227 KB, so this runs in two passes:
//   (a) stats_kernel: per query, the max m_i and the sum l_i of
//       exp(scale q_i . k_l - m_i) over all L keys, online over key tiles;
//   (b) pv_kernel: per 8x8 query tile, for each 8x8 key tile, recompute
//       the scores of the 10x10 query halo against the 10x10 key halo,
//       normalize with (m, l), apply the 9-point stencil in shared memory
//       and accumulate M @ P on the tensor cores into a 64 x s^2C f32 tile.
// Tiling both grids in 2-D keeps the stencil halo at one pixel per side
// (a flat query tile would need +-(Wp+1) rows: 6x the recompute at
// Wp = 192).
//
// Bound on the H100 at the 192 tile (Hp = Wp = 192, L = 96^2, Cr = 32,
// C = 64, s = 2): 2*P*L*(9Cr + s^2C) = 370 GFLOP -> 0.37 ms at the bf16
// dense peak; the 340 M exps are not the limit. The two passes run
// 195 + 2.44*195 + 174 = 845 GFLOP of tensor-core work (the halo
// recompute is the price of not writing A).
#include "common.cuh"

namespace {

constexpr int CR = 32;          // match channels
constexpr int QK = 9 * CR;      // 288
constexpr int C = 64;           // embedding channels
constexpr int S = 2;            // CSA scale
constexpr int SC2 = S * S * C;  // 256
constexpr int LDQ = QK + 16;    // 304 bf16: 16-row starts 32B-aligned
constexpr int THREADS = 256;

// q_i into row dst (QK bf16): 3x3 zero-padded match taps around (iy, ix)
__device__ __forceinline__ void load_query(const bf16* match, int b, int Hp,
                                           int Wp, int iy, int ix, bool ok,
                                           int t, int v, bf16* dst) {
  uint4 val = zero8();
  const int yy = iy + t / 3 - 1, xx = ix + t % 3 - 1;
  if (ok && yy >= 0 && yy < Hp && xx >= 0 && xx < Wp)
    val = ld8(match + ((size_t)(b * Hp + yy) * Wp + xx) * CR + v * 8);
  st8(dst + t * CR + v * 8, val);
}

// ---------------------------------------------------------------- pass (a)
constexpr int A_ROWS = 64, A_KEYS = 64, LDSA = A_KEYS + 4;
constexpr int SMEM_A = 2 * A_ROWS * LDQ * 2 + A_ROWS * LDSA * 4;

__global__ void __launch_bounds__(THREADS)
stats_kernel(const bf16* __restrict__ match, const bf16* __restrict__ keys,
             float* __restrict__ m_out, float* __restrict__ l_out, int Hp,
             int Wp, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + A_ROWS * LDQ;
  float* ss = reinterpret_cast<float*>(ks + A_KEYS * LDQ);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y, P = Hp * Wp;
  const int i0 = blockIdx.x * A_ROWS;

  for (int idx = tid; idx < A_ROWS * 9 * (CR / 8); idx += THREADS) {
    const int r = idx / (9 * CR / 8), j = idx % (9 * CR / 8);
    const int i = i0 + r;
    load_query(match, b, Hp, Wp, i / Wp, i % Wp, i < P, j / (CR / 8),
               j % (CR / 8), qs + r * LDQ);
  }
  const int r = tid >> 2, sub = tid & 3;  // 4 threads per query row
  float m_run = -INFINITY, l_run = 0.f;
  const int rf = warp >> 1, cf0 = (warp & 1) * 2;
  for (int l0 = 0; l0 < L; l0 += A_KEYS) {
    for (int idx = tid; idx < A_KEYS * (QK / 8); idx += THREADS) {
      const int kr = idx / (QK / 8), v = idx % (QK / 8);
      const int l = l0 + kr;
      st8(ks + kr * LDQ + v * 8,
          l < L ? ld8(keys + ((size_t)b * L + l) * QK + v * 8) : zero8());
    }
    __syncthreads();
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
      wm::store_matrix_sync(ss + (16 * rf) * LDSA + 16 * (cf0 + j), acc[j],
                            LDSA, wm::mem_row_major);
    __syncthreads();
    float mloc = -INFINITY;
    for (int c = sub * 16; c < sub * 16 + 16; ++c)
      if (l0 + c < L) mloc = fmaxf(mloc, ss[r * LDSA + c] * scale);
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m_run, mloc);
    float sloc = 0.f;
    for (int c = sub * 16; c < sub * 16 + 16; ++c)
      if (l0 + c < L) sloc += __expf(ss[r * LDSA + c] * scale - m_new);
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

// ---------------------------------------------------------------- pass (b)
constexpr int T = 8;                  // query / key tile side
constexpr int TH = T + 2;             // halo side
constexpr int NH = TH * TH;           // 100 halo rows
constexpr int NHP = 112;              // padded to the 16-row fragment grid
constexpr int LDSB = NHP + 4;         // 116 f32 score row stride
constexpr int LDM = T * T + 8;        // 72 bf16
constexpr int LDP = SC2 + 8;          // 264 bf16
constexpr int OFF_K = NHP * LDQ * 2;                 // key halo / P tile
constexpr int OFF_S = OFF_K + NHP * LDQ * 2;         // scores / A
constexpr int OFF_M = OFF_S + NHP * LDSB * 4;        // stencil result M
constexpr int OFF_ML = OFF_M + T * T * LDM * 2;      // m, 1/l, flags
constexpr int SMEM_B = OFF_ML + 4 * NHP * 4;

__global__ void __launch_bounds__(THREADS)
pv_kernel(const bf16* __restrict__ match, const bf16* __restrict__ keys,
          const bf16* __restrict__ embed, const float* __restrict__ m_in,
          const float* __restrict__ l_in, float* __restrict__ out, int Hp,
          int Wp, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qh = reinterpret_cast<bf16*>(smem);
  bf16* kh = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* pt = kh;  // the phase tile reuses the key halo once scores exist
  float* sa = reinterpret_cast<float*>(smem + OFF_S);
  bf16* mb = reinterpret_cast<bf16*>(smem + OFF_M);
  float* mq = reinterpret_cast<float*>(smem + OFF_ML);
  float* linv = mq + NHP;
  float* qok = linv + NHP;
  float* kok = qok + NHP;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y;
  const int Hq = Hp / S, Wq = Wp / S, P = Hp * Wp, L = Hq * Wq;
  const int ntx = (Wp + T - 1) / T;
  const int ty0 = (blockIdx.x / ntx) * T, tx0 = (blockIdx.x % ntx) * T;

  // query halo rows, their softmax stats and validity
  for (int idx = tid; idx < NHP * 9 * (CR / 8); idx += THREADS) {
    const int h = idx / (9 * CR / 8), j = idx % (9 * CR / 8);
    const int iy = ty0 + h / TH - 1, ix = tx0 + h % TH - 1;
    const bool ok = h < NH && iy >= 0 && iy < Hp && ix >= 0 && ix < Wp;
    load_query(match, b, Hp, Wp, iy, ix, ok, j / (CR / 8), j % (CR / 8),
               qh + h * LDQ);
  }
  for (int h = tid; h < NHP; h += THREADS) {
    const int iy = ty0 + h / TH - 1, ix = tx0 + h % TH - 1;
    const bool ok = h < NH && iy >= 0 && iy < Hp && ix >= 0 && ix < Wp;
    const size_t gi = (size_t)b * P + (ok ? iy * Wp + ix : 0);
    qok[h] = ok ? 1.f : 0.f;
    mq[h] = ok ? m_in[gi] : 0.f;
    linv[h] = ok ? 1.f / l_in[gi] : 0.f;
  }

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

  for (int ky0 = 0; ky0 < Hq; ky0 += T) {
    for (int kx0 = 0; kx0 < Wq; kx0 += T) {
      // key halo
      for (int idx = tid; idx < NHP * (QK / 8); idx += THREADS) {
        const int h = idx / (QK / 8), v = idx % (QK / 8);
        const int ly = ky0 + h / TH - 1, lx = kx0 + h % TH - 1;
        const bool ok = h < NH && ly >= 0 && ly < Hq && lx >= 0 && lx < Wq;
        st8(kh + h * LDQ + v * 8,
            ok ? ld8(keys + ((size_t)b * L + ly * Wq + lx) * QK + v * 8)
               : zero8());
        if (v == 0) kok[h] = ok ? 1.f : 0.f;
      }
      __syncthreads();
      // scores of the 112 x 112 halo block: 49 fragments over 8 warps
      for (int f = warp; f < (NHP / 16) * (NHP / 16); f += 8) {
        const int rf = f / (NHP / 16), cf = f % (NHP / 16);
        FragC s;
        wm::fill_fragment(s, 0.f);
        FragA fa;
        FragBt fb;
        for (int k = 0; k < QK; k += 16) {
          wm::load_matrix_sync(fa, qh + (16 * rf) * LDQ + k, LDQ);
          wm::load_matrix_sync(fb, kh + (16 * cf) * LDQ + k, LDQ);
          wm::mma_sync(s, fa, fb, s);
        }
        wm::store_matrix_sync(sa + (16 * rf) * LDSB + 16 * cf, s, LDSB,
                              wm::mem_row_major);
      }
      __syncthreads();
      // normalized attention in place; the phase tile into the key halo
      for (int idx = tid; idx < NH * NH; idx += THREADS) {
        const int h = idx / NH, c = idx % NH;
        const float v = sa[h * LDSB + c];
        sa[h * LDSB + c] = qok[h] * kok[c] *
                           __expf(fminf(v * scale - mq[h], 0.f)) * linv[h];
      }
      for (int idx = tid; idx < T * T * (SC2 / 8); idx += THREADS) {
        const int kr = idx / (SC2 / 8), v = idx % (SC2 / 8);
        const int ph = v / (C / 8), cv = v % (C / 8);
        const int ly = ky0 + kr / T, lx = kx0 + kr % T;
        uint4 val = zero8();
        if (ly < Hq && lx < Wq)
          val = ld8(embed + ((size_t)(b * Hp + S * ly + ph / S) * Wp +
                             S * lx + ph % S) * C + cv * 8);
        st8(pt + kr * LDP + v * 8, val);
      }
      __syncthreads();
      // 9-point diagonal stencil: M[i, l] = sum_d A[i + d, l + d]
      for (int idx = tid; idx < T * T * T * T; idx += THREADS) {
        const int i = idx / (T * T), l = idx % (T * T);
        const int hi = (i / T + 1) * TH + i % T + 1;
        const int hl = (l / T + 1) * TH + l % T + 1;
        float m = 0.f;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx)
            m += sa[(hi + dy * TH + dx) * LDSB + hl + dy * TH + dx];
        mb[i * LDM + l] = f2bf(m);
      }
      __syncthreads();
      // acc (64 x 256) += M (64 x 64) @ P (64 x 256); warp w: cols 32w..
      FragA fa;
      FragB fb;
#pragma unroll
      for (int k = 0; k < T * T; k += 16) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wm::load_matrix_sync(fb, pt + k * LDP + 32 * warp + 16 * j, LDP);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            wm::load_matrix_sync(fa, mb + (16 * i) * LDM + k, LDM);
            wm::mma_sync(acc[i][j], fa, fb, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  // scatter the 64 x (s^2 C) tile to the (B, s*Hp, s*Wp, C) output
  float* st = reinterpret_cast<float*>(smem);  // reuses the query halo
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(st + (16 * i) * SC2 + 32 * warp + 16 * j,
                            acc[i][j], SC2, wm::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < T * T * SC2; idx += THREADS) {
    const int i = idx / SC2, n = idx % SC2;
    const int iy = ty0 + i / T, ix = tx0 + i % T;
    if (iy >= Hp || ix >= Wp) continue;
    const int ph = n / C, c = n % C;
    out[((size_t)(b * S * Hp + S * iy + ph / S) * (S * Wp) + S * ix +
         ph % S) * C + c] = st[idx];
  }
}

}  // namespace

extern "C" int csa_stencil(const void* match, const void* keys,
                           const void* embed, void* m_buf, void* l_buf,
                           void* out, int B, int Hp, int Wp, float scale,
                           void* stream) {
  static cudaError_t attr_a = allow_smem(stats_kernel, SMEM_A);
  static cudaError_t attr_b = allow_smem(pv_kernel, SMEM_B);
  if (attr_a != cudaSuccess) return (int)attr_a;
  if (attr_b != cudaSuccess) return (int)attr_b;
  if (Hp % S || Wp % S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int P = Hp * Wp, L = (Hp / S) * (Wp / S);
  stats_kernel<<<dim3((P + A_ROWS - 1) / A_ROWS, B), THREADS, SMEM_A, st>>>(
      (const bf16*)match, (const bf16*)keys, (float*)m_buf, (float*)l_buf,
      Hp, Wp, L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hp + T - 1) / T) * ((Wp + T - 1) / T);
  pv_kernel<<<dim3(tiles, B), THREADS, SMEM_B, st>>>(
      (const bf16*)match, (const bf16*)keys, (const bf16*)embed,
      (const float*)m_buf, (const float*)l_buf, (float*)out, Hp, Wp, scale);
  return (int)cudaGetLastError();
}
