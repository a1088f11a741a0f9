// Row 8 of the kernel table, csa_attention_overlap_add: the CSA middle as
// attention over an explicit plane-major (3s)^2 C value bank, pasted by
// the overlap-add. (Row 7, the same attention with the bank-shaped
// output, is the one-launch kernel of csa_flash.cu; row 6, the same
// function from the match map and the embedding, is K4's stencil-form
// kernel of csa_stencil_sm90.cu.)
//
// Replaces ciaosr_tpu/ops/pallas/csa_attention.py::
// csa_attention_overlap_add (_attn_oa_kernel). For query pixel i and key l,
//   A = softmax_l(scale * q_i . k_l),   K_i = sum_l A[i, l] v_l
// with q_i the 3x3 zero-padded match neighbourhood (9Cr = 288, tap-major)
// from the bank q (B, P, 288), k_l the normalized 3x3 key patch and v_l
// the (3s)x(3s) stride-s patch of the embedding ((3s)^2 C = 2304) from the
// bank v (B, L, 2304), pasted with the (3s, 3s) stride-s overlap-add
// (conv_transpose2d, ciaosr_tpu/models/csa.py::_overlap_add) into
// (B, s*Hp, s*Wp, C) f32, before the down conv and the /6. The value
// columns come in nine tap planes (t, r) of s^2 C = 256, with columns
// (a, b, c): v_l[(t, r), (a, b), c] = embed[s(ly + t - 1) + a,
// s(lx + r - 1) + b, c] (the plane-major bank).
//
// The TPU keeps a (TP, 2304) f32 accumulator in VMEM and runs one online
// softmax over L. A 64-row f32 accumulator 2304 wide is 590 KB; an SM has
// 227 KB of shared memory. So this runs in two passes:
//   (a) stats_kernel (csa_tiles.cuh): per query, the max m_i and the sum
//       l_i of exp(scale q_i . k_l - m_i) over all L keys, online over key
//       tiles;
//   (b) pv_kernel: one block per (64-query tile, tap plane). For each
//       64-key tile it recomputes the scores, forms the normalized
//       p = exp(scale s - m) / l in bf16 (no online rescale) and
//       accumulates p @ V_plane into a 64 x 256 f32 tile on the tensor
//       cores.
// Keys past L are masked (p = 0); L is not padded.
//
// Bound on the H100: operations at the bf16 dense peak. Row 8 takes
// explicit, unstructured banks and needs 2PL(9Cr + (3s)^2 C) = 2PL * 2592
// FLOPs. The two passes run 2PL(288 + 9 * 288 + 2304) = 2PL * 5184 FLOPs
// of tensor-core work: each of the nine planes recomputes the scores, the
// price of a 256-wide accumulator.
//
// Overlap-add epilogue: plane (t, r) of query pixel (iy, ix) lands on
// output block (iy + t - 1, ix + r - 1); blocks off the Hp x Wp grid are
// dropped (the TPU masks the same column wrap with iota masks). Nine planes
// of nine blocks meet in one output element, so the epilogue adds with f32
// atomicAdd into an output the wrapper zeroes: the order of those nine
// additions changes from run to run, so results agree to f32 rounding,
// not bit for bit.
#include "csa_tiles.cuh"

namespace {

constexpr int NPL = 9;              // tap planes of SC2 = 256 columns
constexpr int DV = NPL * SC2;       // 2304
constexpr int LDPB = TK + 8;        // 72 bf16
constexpr int LDV = SC2 + 8;        // 264 bf16

struct Args {
  const bf16* q;  // query bank (B, P, QK)
  const bf16* k;  // keys (B, L, QK)
  const bf16* v;  // plane-major value bank (B, L, DV)
  float* m;       // (B, P) row max
  float* l;       // (B, P) row sum
  float* out;     // (B, S*Hp, S*Wp, C), zeroed
  int P, L, Hp, Wp;
  float scale;
};

// tap plane pl of the values of keys l0 .. l0 + TK into vs (zero past L)
__device__ __forceinline__ void load_v_tile(const Args& a, int b, int l0,
                                            int pl, bf16* vs) {
  for (int idx = threadIdx.x; idx < TK * (SC2 / 8); idx += THREADS) {
    const int r = idx / (SC2 / 8), v = idx % (SC2 / 8);
    const int l = l0 + r;
    st8(vs + r * LDV + v * 8,
        l < a.L ? ld8(a.v + ((size_t)b * a.L + l) * DV + pl * SC2 + v * 8)
                : zero8());
  }
}

// ---------------------------------------------------------------- pass (b)
constexpr int OFF_K = TQ * LDQ * 2;              // key tile
constexpr int OFF_S = OFF_K + TK * LDQ * 2;      // scores
constexpr int OFF_P = OFF_S + TQ * LDS * 4;      // normalized p (bf16)
constexpr int OFF_V = OFF_P + TQ * LDPB * 2;     // value plane tile
constexpr int OFF_ML = OFF_V + TK * LDV * 2;     // m, 1/l
constexpr int SMEM_B = OFF_ML + 2 * TQ * 4;
static_assert(TQ * SC2 * 4 <= OFF_S, "epilogue tile overlays q and k");

__global__ void __launch_bounds__(THREADS) pv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + OFF_K);
  float* ss = reinterpret_cast<float*>(smem + OFF_S);
  bf16* pb = reinterpret_cast<bf16*>(smem + OFF_P);
  bf16* vs = reinterpret_cast<bf16*>(smem + OFF_V);
  float* mq = reinterpret_cast<float*>(smem + OFF_ML);
  float* linv = mq + TQ;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int i0 = blockIdx.x * TQ, pl = blockIdx.y, b = blockIdx.z;

  load_q_tile<true>(a.q, b, a.P, a.Hp, a.Wp, i0, qs);
  for (int r = tid; r < TQ; r += THREADS) {
    const bool ok = i0 + r < a.P;
    const size_t gi = (size_t)b * a.P + (ok ? i0 + r : 0);
    mq[r] = ok ? a.m[gi] : 0.f;
    linv[r] = ok ? 1.f / a.l[gi] : 0.f;
  }
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

  for (int l0 = 0; l0 < a.L; l0 += TK) {
    load_k_tile(a.k, b, a.L, l0, ks);
    load_v_tile(a, b, l0, pl, vs);
    __syncthreads();
    score_tile(qs, ks, ss);
    __syncthreads();
    for (int idx = tid; idx < TQ * TK; idx += THREADS) {
      const int r = idx / TK, c = idx % TK;
      const float p =
          l0 + c < a.L
              ? __expf(fminf(ss[r * LDS + c] * a.scale - mq[r], 0.f)) * linv[r]
              : 0.f;
      pb[r * LDPB + c] = f2bf(p);
    }
    __syncthreads();
    // acc (64 x 256) += p (64 x 64) @ V (64 x 256); warp w: columns 32w..
    FragA fa;
    FragB fb;
#pragma unroll
    for (int k = 0; k < TK; k += 16) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wm::load_matrix_sync(fb, vs + k * LDV + 32 * warp + 16 * j, LDV);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wm::load_matrix_sync(fa, pb + (16 * i) * LDPB + k, LDPB);
          wm::mma_sync(acc[i][j], fa, fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* st = reinterpret_cast<float*>(smem);  // over the q and k tiles
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(st + (16 * i) * SC2 + 32 * warp + 16 * j,
                            acc[i][j], SC2, wm::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < TQ * SC2; idx += THREADS) {
    const int r = idx / SC2, n = idx % SC2;
    const int i = i0 + r;
    if (i >= a.P) continue;
    const int oy = i / a.Wp + pl / 3 - 1, ox = i % a.Wp + pl % 3 - 1;
    if (oy < 0 || oy >= a.Hp || ox < 0 || ox >= a.Wp) continue;
    const int ph = n / C, c = n % C;
    atomicAdd(a.out + ((size_t)(b * S * a.Hp + S * oy + ph / S) * (S * a.Wp) +
                       S * ox + ph % S) * C + c,
              st[idx]);
  }
}

int launch(const Args& a, int B, void* stream) {
  static cudaError_t attr_a = allow_smem(stats_kernel<true>, SMEM_STATS);
  static cudaError_t attr_b = allow_smem(pv_kernel, SMEM_B);
  if (attr_a != cudaSuccess) return (int)attr_a;
  if (attr_b != cudaSuccess) return (int)attr_b;
  if (a.P <= 0 || a.L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (a.P + TQ - 1) / TQ;
  stats_kernel<true><<<dim3(tiles, B), THREADS, SMEM_STATS, st>>>(
      a.q, a.k, a.m, a.l, a.P, a.L, a.Hp, a.Wp, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pv_kernel<<<dim3(tiles, NPL, B), THREADS, SMEM_B, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// row 8: q (B, Hp*Wp, 288), k (B, L, 288), v_pm (B, L, 2304) plane-major ->
// out (B, 2Hp, 2Wp, 64) f32, zeroed by the caller
extern "C" int csa_attention_overlap_add(const void* q, const void* k,
                                         const void* v_pm, void* m_buf,
                                         void* l_buf, void* out, int B,
                                         int Hp, int Wp, int L, float scale,
                                         void* stream) {
  const Args a{(const bf16*)q, (const bf16*)k, (const bf16*)v_pm,
               (float*)m_buf, (float*)l_buf, (float*)out, Hp * Wp, L, Hp,
               Wp, scale};
  return launch(a, B, stream);
}
