// Row 5 of the kernel table, csa_stencil: the middle of cross-scale
// attention (average=True) in the stencil form, with the normalized
// attention through device memory. (K4 csa_stencil_fused, the same
// function with the attention's stencil halo recomputed, and row 6 are
// the wgmma kernel of csa_stencil_sm90.cu.)
//
// Replaces ciaosr_tpu/ops/pallas/csa_attention.py::csa_stencil (kernels
// _csa_scores_kernel and _csa_stencil_pv_kernel). With q_i the 3x3
// zero-padded match neighbourhood of query pixel i (9Cr wide, tap-major),
// k_l the normalized 3x3 key patch l of the s-downsampled match map and
// P_l the s^2 phase planes of the embedding at key l (P_l[(a,b), c] =
// embed[s*ly+a, s*lx+b, c]):
//   A   = softmax_l(scale * q_i . k_l)
//   M[i, l] = sum_{d in {-1,0,1}^2} A[i + d, l + d]   (2-D shifts: d moves
//             the query in the Hp x Wp grid and the key in the Hq x Wq grid;
//             out-of-grid terms are zero)
//   out[s*iy + a, s*ix + b, c] = sum_l M[i, l] P_l[(a,b), c]
// (derivation: csa_attention.py:562-591). Output (B, s*Hp, s*Wp, C) f32,
// before the down conv and the /6.
#include "csa_tiles.cuh"

namespace {

// The normalized attention A goes through device memory, as bf16
// (B, P, ldA) with ldA = L rounded up to 64 (pad columns written as 0):
//   sweep 1: stats_kernel (csa_tiles.cuh): per query, the max m_i and the
//            sum l_i of exp(scale q_i . k_l - m_i) over all L keys;
//   sweep 2: abar_kernel, one block per (64-query, 64-key) tile: recompute
//            the scores and write A = exp(scale s - m) / l;
//   stencil_pv_kernel: per 8x8 query tile, for each 8x8 key tile, the
//            10x10 query halo x 10x10 key halo of A (zero off either grid,
//            masked here, not read from a padded copy), the 9-point
//            stencil in shared memory and M @ P on the tensor cores into a
//            64 x s^2C f32 tile. Tiling both grids in 2-D keeps the
//            stencil halo at one pixel per side.
// Bound: the function's, as K4's (operations, 2PL(9Cr + s^2C)). The kernels
// also move the A round trip, 2 * 2PL bytes (2.4 GB at Hp x Wp = 48 x 1024,
// 0.72 ms at 3.35 TB/s), and run 2 * 2PL * 9Cr score FLOPs (two sweeps).
constexpr int T = 8;                  // query / key tile side
constexpr int TH = T + 2;             // halo side
constexpr int NH = TH * TH;           // 100 halo rows
constexpr int NHP = 112;              // padded to the 16-row fragment grid
constexpr int LDSB = NHP + 4;         // 116 f32 score row stride
constexpr int LDM = T * T + 8;        // 72 bf16
constexpr int LDP = SC2 + 8;          // 264 bf16

constexpr int LDA_ALIGN = 64;

__global__ void __launch_bounds__(THREADS)
abar_kernel(const bf16* __restrict__ match, const bf16* __restrict__ keys,
            const float* __restrict__ m_in, const float* __restrict__ l_in,
            bf16* __restrict__ abar, int Hp, int Wp, int L, int ldA,
            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TQ * LDQ;
  float* ss = reinterpret_cast<float*>(ks + TK * LDQ);
  const int tid = threadIdx.x;
  const int b = blockIdx.z, P = Hp * Wp;
  const int i0 = blockIdx.x * TQ, l0 = blockIdx.y * TK;

  load_q_tile<false>(match, b, P, Hp, Wp, i0, qs);
  load_k_tile(keys, b, L, l0, ks);
  __syncthreads();
  score_tile(qs, ks, ss);
  __syncthreads();
  const int r = tid >> 2, sub = tid & 3;  // 16 columns a thread
  const int i = i0 + r;
  if (i >= P) return;
  const float mi = m_in[(size_t)b * P + i], li = 1.f / l_in[(size_t)b * P + i];
  __align__(16) bf16 vals[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int cc = sub * 16 + c;
    vals[c] = f2bf(l0 + cc < L
                       ? __expf(fminf(ss[r * LDS + cc] * scale - mi, 0.f)) * li
                       : 0.f);
  }
  bf16* dst = abar + ((size_t)b * P + i) * ldA + l0 + sub * 16;
  st8(dst, *reinterpret_cast<const uint4*>(vals));
  st8(dst + 8, *reinterpret_cast<const uint4*>(vals + 8));
}

constexpr int OFF_SP_P = NHP * LDSB * 4;             // phase tile
constexpr int OFF_SP_M = OFF_SP_P + T * T * LDP * 2;  // stencil result M
constexpr int SMEM_SP = OFF_SP_M + T * T * LDM * 2;
static_assert(T * T * SC2 * 4 <= OFF_SP_M, "epilogue tile overlays A, P");

__global__ void __launch_bounds__(THREADS)
stencil_pv_kernel(const bf16* __restrict__ abar,
                  const bf16* __restrict__ embed, float* __restrict__ out,
                  int Hp, int Wp, int ldA) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);
  bf16* pt = reinterpret_cast<bf16*>(smem + OFF_SP_P);
  bf16* mb = reinterpret_cast<bf16*>(smem + OFF_SP_M);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y;
  const int Hq = Hp / S, Wq = Wp / S, P = Hp * Wp;
  const int ntx = (Wp + T - 1) / T;
  const int ty0 = (blockIdx.x / ntx) * T, tx0 = (blockIdx.x % ntx) * T;

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

  for (int ky0 = 0; ky0 < Hq; ky0 += T) {
    for (int kx0 = 0; kx0 < Wq; kx0 += T) {
      // A over the query halo x key halo
      for (int idx = tid; idx < NH * NH; idx += THREADS) {
        const int h = idx / NH, c = idx % NH;
        const int iy = ty0 + h / TH - 1, ix = tx0 + h % TH - 1;
        const int ly = ky0 + c / TH - 1, lx = kx0 + c % TH - 1;
        float v = 0.f;
        if (iy >= 0 && iy < Hp && ix >= 0 && ix < Wp && ly >= 0 &&
            ly < Hq && lx >= 0 && lx < Wq)
          v = bf2f(abar[((size_t)b * P + iy * Wp + ix) * ldA + ly * Wq + lx]);
        sa[h * LDSB + c] = v;
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

  float* st = reinterpret_cast<float*>(smem);  // over A and the phase tile
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

// row 5: match (B, Hp, Wp, 32), keys (B, Hp/2 * Wp/2, 288), embed
// (B, Hp, Wp, 64) -> (B, 2Hp, 2Wp, 64) f32, with abar (B, Hp*Wp, ldA) bf16 scratch, ldA = L rounded up
// to 64
extern "C" int csa_stencil(const void* match, const void* keys,
                           const void* embed, void* m_buf, void* l_buf,
                           void* abar, void* out, int B, int Hp, int Wp,
                           int ldA, float scale, void* stream) {
  static cudaError_t attr_a = allow_smem(stats_kernel<false>, SMEM_STATS);
  static cudaError_t attr_w = allow_smem(abar_kernel, SMEM_STATS);
  static cudaError_t attr_b = allow_smem(stencil_pv_kernel, SMEM_SP);
  if (attr_a != cudaSuccess) return (int)attr_a;
  if (attr_w != cudaSuccess) return (int)attr_w;
  if (attr_b != cudaSuccess) return (int)attr_b;
  const int P = Hp * Wp, L = (Hp / S) * (Wp / S);
  if (Hp % S || Wp % S || ldA % LDA_ALIGN || ldA < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int q_tiles = (P + TQ - 1) / TQ;
  stats_kernel<false><<<dim3(q_tiles, B), THREADS, SMEM_STATS, st>>>(
      (const bf16*)match, (const bf16*)keys, (float*)m_buf, (float*)l_buf, P,
      L, Hp, Wp, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  abar_kernel<<<dim3(q_tiles, ldA / TK, B), THREADS, SMEM_STATS, st>>>(
      (const bf16*)match, (const bf16*)keys, (const float*)m_buf,
      (const float*)l_buf, (bf16*)abar, Hp, Wp, L, ldA, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hp + T - 1) / T) * ((Wp + T - 1) / T);
  stencil_pv_kernel<<<dim3(tiles, B), THREADS, SMEM_SP, st>>>(
      (const bf16*)abar, (const bf16*)embed, (float*)out, Hp, Wp, ldA);
  return (int)cudaGetLastError();
}
