// Row 12 swin_block_bwd: the backward of one whole Swin transformer block.
//
// Replaces ciaosr_tpu/ops/pallas/swin_block.py::_swin_block_bwd_call
// (kernel _block_bwd_kernel), the custom VJP of swin_block_fused. Given the
// rolled token map x (B, H, W, C) f32 and the output's cotangent dy (same
// shape, f32), it recomputes the block forward (row 11's function,
// csrc/swin_block_sm90.cu) and returns dx and every packed parameter gradient in f32, with
// the TPU kernel's casts: matmul operands bf16 (dq, dk, dv, dl, dz1, dx1,
// dy and do rounded to bf16 before their products), sums, LayerNorm,
// softmax, GELU and GELU' (exact erf) in f32. One difference: the packed
// q bias is b_q * scale, and its gradient here is the sum of dL/dq before
// the scale (the true gradient); the TPU kernel sums dq after the scale, so
// its q-bias gradient is head_dim^-0.5 times the true one.
//
// Layout: row 11's packed one (C -> 192, head h in columns [32h, 32h + 32)
// of each of q, k, v, MLP hidden -> 384); LayerNorm statistics and their
// backward average over the C real channels only; padded channels, head
// columns, hidden columns and window rows come out as exact zeros.
//
// Design, a simple first kernel in three launches:
//  (1) swin_bwd_kernel, one block per window (<= 64 tokens), 8 warps, 215 KB
//      of shared memory. It recomputes x1, both LayerNorms, q, k, v, each
//      head's P and the MLP hidden, and back-propagates: dy -> dhdn -> dz1
//      -> dyn -> LN2' -> dx1 -> do -> per head dv = P^T do, dP, dl, dq, dk
//      -> dxn -> LN1' -> dx. q, k, v are recomputed after the MLP backward
//      instead of being kept (shared memory holds x1, the LN output, the
//      MLP gradients or q/k/v, one head's scores and a score gradient). It
//      writes dx, the per-token operand pairs of the weight gradients in
//      bf16 ((xn, [dq|dk|dv]), (o, dx1), (yn, dz1), (hdn, dy)) and one row
//      of f32 per-window partials (LayerNorm gamma/beta, every bias, and the
//      (heads, N, N) bias-table gradient).
//  (2) swin_wgrad_kernel: dW = A^T B over the tokens for Wqkv (192 x 576),
//      Wp (192 x 192), W1 (192 x 384) and W2 (384 x 192), one block per
//      64 x 64 output tile and token chunk (a fixed number of chunks),
//      f32 partials.
//  (3) swin_gsum_kernel: sums the window partials and the chunk partials in
//      a fixed order. No atomics anywhere, so the gradients are
//      reproducible run to run.
// The TPU kernel keeps its parameter gradients resident across a
// sequential grid; on Hopper blocks run in no order and dWqkv alone (442 KB
// f32) does not fit in shared memory, hence (2) and (3).
//
// Bound on the H100 (SwinIR-CiaoSR, C = 180, hidden 360, N = 64): about 3x
// the forward's 2*T*C*(4C + 2*360) + 4*T*N*C FLOPs (recompute + 2x for the
// backward products), 41.6 GFLOP at the 002 batch's T = 24576 tokens, 42 us
// at the bf16 dense peak; x, dy and dx in f32 move 53 MB (16 us). This
// design also writes and reads the ~113 MB of bf16 pairs and 38 MB of f32
// bias-table partials.
#include <type_traits>

#include "common.cuh"

namespace {

typedef wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major> FragAt;

constexpr int CP = 192;     // packed residual width
constexpr int HD = 32;      // head slot
constexpr int HIDP = 384;   // packed MLP hidden width
constexpr int QKV = 3 * CP;
constexpr int NT = 64;      // tokens per window, at most
constexpr int THREADS = 256;
constexpr int LDA = CP + 8;      // 200: bf16 rows
constexpr int LDH = HIDP + 8;    // 392: bf16 rows of the MLP gradient
constexpr int LDS = NT + 4;      // 68: f32 score rows
constexpr int LDP = NT + 8;      // 72: bf16 probability rows
constexpr float LN_EPS = 1e-5f;

// shared memory regions (bytes); later phases reuse earlier ones
constexpr int OFF_R1 = NT * CP * 4;              // R0: x, x1, xhat2, dx1 (f32)
constexpr int OFF_R2 = OFF_R1 + NT * LDA * 2;    // R1: xn, yn, dx1 bf16, dP
constexpr int OFF_R3 = OFF_R2 + NT * LDA * 2;    // R2: q | R2+R3: dz1, dxn
constexpr int OFF_R4 = OFF_R3 + NT * LDA * 2;    // R3: k
constexpr int OFF_R5 = OFF_R4 + NT * LDA * 2;    // R4: v | R4+R5: dyn, xhat1
constexpr int OFF_S = OFF_R5 + NT * LDA * 2;     // R5: o, dy bf16, do
constexpr int OFF_P = OFF_S + NT * LDS * 4;      // scores, then P (f32)
constexpr int OFF_SCR = OFF_P + NT * LDP * 2;    // P, then dl (bf16)
constexpr int SMEM = OFF_SCR + 8 * 512 * 4;      // 220160 B
static_assert(NT * LDH * 2 <= 2 * NT * LDA * 2, "dz1 must fit in R2+R3");
static_assert(NT * CP * 4 <= 2 * NT * LDA * 2, "f32 maps must fit in 2 regions");
static_assert(NT * LDS * 4 <= NT * LDA * 2, "dP must fit in R1");

// per-window partial row: vectors, then the (heads, n, n) bias gradient
constexpr int PV_G1 = 0, PV_B1 = CP, PV_BQKV = 2 * CP, PV_BP = 5 * CP,
              PV_G2 = 6 * CP, PV_B2 = 7 * CP, PV_B1M = 8 * CP,
              PV_B2M = 8 * CP + HIDP, PV_BIAS = 9 * CP + HIDP;   // 2112

struct Params {
  const float *x, *dy;
  const float *g1, *b1;
  const bf16* wqkv;    // (CP, 3CP)
  const float* bqkv;   // (3CP), the q part pre-scaled
  const bf16* wp;      // (CP, CP)
  const float* bp;
  const float *g2, *b2;
  const bf16* w1;      // (CP, HIDP)
  const float* b1m;
  const bf16* w2;      // (HIDP, CP)
  const float* b2m;
  const float* bias;   // (heads, N, N)
  float* dx;
  // per-token pairs, NT rows a window: (T, width) bf16
  bf16 *xn, *dqkv, *o, *dx1, *yn, *dz1, *hdn, *dyb;
  float* part;         // (windows, PV_BIAS + heads*N*N) f32
  int H, W, C, heads, ws, shift;
  float scale;
};

// C = A[64 x K] @ B[K x ncols] in 64 x 32 units, unit u = warp, warp + 8,
// ...; A bf16 row-major (shared or global memory), B bf16 in global memory,
// row-major (BT false: B[k * ldb + n]) or transposed (BT true: B[n * ldb +
// k]). epi(row, col, v) gets 8 consecutive f32 results v[0..7] of row
// `row`, columns col..col+7. No barrier inside.
template <bool BT, typename Epi>
__device__ __forceinline__ void gemm64(const bf16* A, int lda, int K,
                                       const bf16* B, int ldb, int ncols,
                                       float* scr, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws = scr + warp * 512;
  const int r = lane >> 1, c = (lane & 1) * 8;
  for (int col0 = warp * 32; col0 < ncols; col0 += 8 * 32) {
    FragC acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);
    for (int k = 0; k < K; k += 16) {
      typename std::conditional<BT, FragBt, FragB>::type fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n0 = col0 + 16 * j;
        wm::load_matrix_sync(fb[j], BT ? B + (size_t)n0 * ldb + k
                                       : B + (size_t)k * ldb + n0, ldb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA fa;
        wm::load_matrix_sync(fa, A + (size_t)16 * i * lda + k, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) wm::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wm::store_matrix_sync(ws, acc[i][j], 16, wm::mem_row_major);
        __syncwarp();
        epi(16 * i + r, col0 + 16 * j + c, ws + r * 16 + c);
        __syncwarp();
      }
  }
}

// LayerNorm of the f32 rows x[0..NT) over the first C channels into bf16
// rows of `out` (LDA wide; padded channels and rows past n are 0), keeping
// each row's mean and 1/std. A warp a row, 8 rows a warp.
__device__ __forceinline__ void layer_norm(const float* x, const float* g,
                                           const float* b, bf16* out, int n,
                                           int C, float* mu_out,
                                           float* rs_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_c = 1.f / (float)C;
  for (int rr = 0; rr < NT / 8; ++rr) {
    const int r = warp * (NT / 8) + rr;
    const float* xr = x + r * CP;
    if (r >= n) {
      for (int c = lane; c < CP; c += 32) out[r * LDA + c] = f2bf(0.f);
      continue;
    }
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += xr[c];
    const float mu = warp_sum(s) * inv_c;
    float s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mu;
      s2 += d * d;
    }
    const float rs = rsqrtf(warp_sum(s2) * inv_c + LN_EPS);
    if (lane == 0) {
      mu_out[r] = mu;
      rs_out[r] = rs;
    }
    for (int c = lane; c < CP; c += 32)
      out[r * LDA + c] = f2bf(c < C ? (xr[c] - mu) * rs * g[c] + b[c] : 0.f);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int region(int y, int n, int ws, int shift) {
  return y < n - ws ? 0 : (y < n - shift ? 1 : 2);
}

// 64 bf16 rows of `width` columns (a multiple of 8) from src to dst
__device__ __forceinline__ void copy_rows(bf16* dst, int ld_dst,
                                          const bf16* src, int ld_src,
                                          int width) {
  const int per = width / 8;
  for (int i = threadIdx.x; i < NT * per; i += THREADS) {
    const int r = i / per, c = (i % per) * 8;
    st8(dst + (size_t)r * ld_dst + c, ld8(src + (size_t)r * ld_src + c));
  }
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_grad(float z) {
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * 0.3989422804014327f * expf(-0.5f * z * z);
}

// The 16 x 16 f32 tile `t` (ld 16) of a warp: lanes 0..15 return the sum
// of their column over the 16 rows (in row order); other lanes 0.
__device__ __forceinline__ float tile_colsum(const float* t) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  if (lane < 16)
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) s += t[rr * 16 + lane];
  return s;
}

__global__ void __launch_bounds__(THREADS) swin_bwd_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  bf16* r1 = reinterpret_cast<bf16*>(smem + OFF_R1);
  float* dPs = reinterpret_cast<float*>(smem + OFF_R1);
  bf16* qs = reinterpret_cast<bf16*>(smem + OFF_R2);
  bf16* dz1s = qs;
  float* f2 = reinterpret_cast<float*>(smem + OFF_R2);   // dxn
  bf16* ks = reinterpret_cast<bf16*>(smem + OFF_R3);
  bf16* vs = reinterpret_cast<bf16*>(smem + OFF_R4);
  float* f4 = reinterpret_cast<float*>(smem + OFF_R4);   // dyn, xhat1
  bf16* os = reinterpret_cast<bf16*>(smem + OFF_R5);
  float* S = reinterpret_cast<float*>(smem + OFF_S);
  bf16* Pm = reinterpret_cast<bf16*>(smem + OFF_P);
  float* scr = reinterpret_cast<float*>(smem + OFF_SCR);
  __shared__ size_t tok[NT];
  __shared__ int reg[NT];
  __shared__ float mu1[NT], rs1[NT], mu2[NT], rs2[NT], lm1[NT], lm2[NT];
  __shared__ float csum[3][4][HD];
  __shared__ float bsum[QKV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ws = P.ws, n = ws * ws, C = P.C, heads = P.heads;
  const int nwx = P.W / ws, nwin = (P.H / ws) * nwx;
  const int bimg = blockIdx.x / nwin, win = blockIdx.x % nwin;
  const int wy = win / nwx, wx = win % nwx;
  const size_t t0 = (size_t)blockIdx.x * NT;
  float* part = P.part + (size_t)blockIdx.x * (PV_BIAS + heads * n * n);
  const float inv_c = 1.f / (float)C;
  const int lr = lane >> 1, lc = (lane & 1) * 8;   // a lane's 8 of a tile

  if (tid < NT) {
    const int ty = tid / ws, tx = tid % ws;
    const int y = wy * ws + ty, x = wx * ws + tx;
    tok[tid] = tid < n ? ((size_t)bimg * P.H + y) * P.W + x : 0;
    reg[tid] = P.shift > 0 ? region(y, P.H, ws, P.shift) * 3 +
                                 region(x, P.W, ws, P.shift)
                           : 0;
  }
  for (int i = tid; i < QKV; i += THREADS) bsum[i] = 0.f;
  __syncthreads();
  for (int idx = tid; idx < NT * CP; idx += THREADS) {
    const int r = idx / CP, c = idx % CP;
    xs[idx] = (r < n && c < C) ? P.x[tok[r] * C + c] : 0.f;
    os[r * LDA + c] = f2bf(0.f);
  }
  __syncthreads();

  // ================= forward recompute =================
  // LN1 -> xn (R1), kept as the dWqkv pair
  layer_norm(xs, P.g1, P.b1, r1, n, C, mu1, rs1);
  __syncthreads();
  copy_rows(P.xn + t0 * CP, CP, r1, LDA, CP);
  auto qkv_epi = [&](int r, int col, const float* v) {
    const int part_ = col / CP, cc = col % CP;
    bf16* dst = (part_ == 0 ? qs : part_ == 1 ? ks : vs) + r * LDA + cc;
    const float sc = part_ == 0 ? P.scale : 1.f;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = f2bf(v[e] * sc + P.bqkv[col + e]);
    st8(dst, *reinterpret_cast<uint4*>(o));
  };
  gemm64<false>(r1, LDA, CP, P.wqkv, QKV, QKV, scr, qkv_epi);
  __syncthreads();

  // scores of head h into S (f32), then softmax: P f32 in S (if keep) and
  // bf16 in Pm; rows and keys past n get probability 0
  auto scores = [&](int h) {
    const int ti = warp / 2, tj0 = (warp % 2) * 2;
    FragC acc[2];
    wm::fill_fragment(acc[0], 0.f);
    wm::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      FragA fa;
      wm::load_matrix_sync(fa, qs + 16 * ti * LDA + HD * h + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBt fb;
        wm::load_matrix_sync(fb, ks + 16 * (tj0 + j) * LDA + HD * h + kk, LDA);
        wm::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(S + 16 * ti * LDS + 16 * (tj0 + j), acc[j], LDS,
                            wm::mem_row_major);
  };
  auto softmax = [&](int h, bool keep) {
    const float* bias = P.bias + (size_t)h * n * n;
    for (int rr = 0; rr < NT / 8; ++rr) {
      const int r = warp * (NT / 8) + rr;
      float l[2];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        l[t] = -INFINITY;
        if (r < n && c < n) {
          l[t] = S[r * LDS + c] + bias[r * n + c];
          if (P.shift > 0 && reg[r] != reg[c]) l[t] += -100.f;
        }
        mx = fmaxf(mx, l[t]);
      }
      mx = warp_max(mx);
      float e[2], s = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        e[t] = l[t] == -INFINITY ? 0.f : expf(l[t] - mx);
        s += e[t];
      }
      s = warp_sum(s);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = r < n ? e[t] / s : 0.f;
        Pm[r * LDP + lane + 32 * t] = f2bf(p);
        if (keep) S[r * LDS + lane + 32 * t] = p;
      }
    }
  };

  // attention, head by head: o_h = bf16(P) v_h into os (R5)
  for (int h = 0; h < heads; ++h) {
    scores(h);
    __syncthreads();
    softmax(h, false);
    __syncthreads();
    {
      const int ti = warp / 2, tj = warp % 2;
      FragC acc;
      wm::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < NT; kk += 16) {
        FragA fa;
        FragB fb;
        wm::load_matrix_sync(fa, Pm + 16 * ti * LDP + kk, LDP);
        wm::load_matrix_sync(fb, vs + kk * LDA + HD * h + 16 * tj, LDA);
        wm::mma_sync(acc, fa, fb, acc);
      }
      float* wsc = scr + warp * 512;
      wm::store_matrix_sync(wsc, acc, 16, wm::mem_row_major);
      __syncwarp();
      __align__(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = f2bf(wsc[lr * 16 + lc + e]);
      st8(os + (16 * ti + lr) * LDA + HD * h + 16 * tj + lc,
          *reinterpret_cast<uint4*>(o));
    }
    __syncthreads();
  }

  // x1 = x + o @ Wp + bp (in place); o is the dWp pair
  copy_rows(P.o + t0 * CP, CP, os, LDA, CP);
  gemm64<false>(os, LDA, CP, P.wp, CP, CP, scr,
                [&](int r, int col, const float* v) {
#pragma unroll
                  for (int e = 0; e < 8; ++e)
                    xs[r * CP + col + e] += v[e] + P.bp[col + e];
                });
  __syncthreads();
  // LN2 -> yn (R1), the dW1 pair; dy -> bf16 in R5, the dW2 pair
  layer_norm(xs, P.g2, P.b2, r1, n, C, mu2, rs2);
  for (int idx = tid; idx < NT * CP; idx += THREADS) {
    const int r = idx / CP, c = idx % CP;
    os[r * LDA + c] = f2bf((r < n && c < C) ? P.dy[tok[r] * C + c] : 0.f);
  }
  __syncthreads();
  copy_rows(P.yn + t0 * CP, CP, r1, LDA, CP);
  copy_rows(P.dyb + t0 * CP, CP, os, LDA, CP);

  // ================= backward =================
  // z1 = yn @ W1 + b1 and dhdn = bf16(dy) @ W2^T side by side, in 64 x 16
  // units: hdn = GELU(z1) (the dW2 pair), dz1 = dhdn * GELU'(z1) (f32 column
  // sums -> db1; bf16 into R2+R3 and the dW1 pair)
  {
    float* w1s = scr + warp * 512;
    float* w2s = w1s + 256;
    for (int col0 = warp * 16; col0 < HIDP; col0 += 8 * 16) {
      FragC a1[4], a2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wm::fill_fragment(a1[i], 0.f);
        wm::fill_fragment(a2[i], 0.f);
      }
      for (int k = 0; k < CP; k += 16) {
        FragB fb;
        FragBt fbt;
        wm::load_matrix_sync(fb, P.w1 + (size_t)k * HIDP + col0, HIDP);
        wm::load_matrix_sync(fbt, P.w2 + (size_t)col0 * CP + k, CP);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          FragA fa;
          wm::load_matrix_sync(fa, r1 + 16 * i * LDA + k, LDA);
          wm::mma_sync(a1[i], fa, fb, a1[i]);
          wm::load_matrix_sync(fa, os + 16 * i * LDA + k, LDA);
          wm::mma_sync(a2[i], fa, fbt, a2[i]);
        }
      }
      float colsum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wm::store_matrix_sync(w1s, a1[i], 16, wm::mem_row_major);
        wm::store_matrix_sync(w2s, a2[i], 16, wm::mem_row_major);
        __syncwarp();
        const int r = 16 * i + lr;
        __align__(16) bf16 hv[8], dv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int cc = col0 + lc + e;
          const float z = w1s[lr * 16 + lc + e] + P.b1m[cc];
          const float dz = r < n ? w2s[lr * 16 + lc + e] * gelu_grad(z) : 0.f;
          hv[e] = f2bf(r < n ? gelu(z) : 0.f);
          dv[e] = f2bf(dz);
          w1s[lr * 16 + lc + e] = dz;
        }
        st8(P.hdn + (t0 + r) * HIDP + col0 + lc, *reinterpret_cast<uint4*>(hv));
        st8(P.dz1 + (t0 + r) * HIDP + col0 + lc, *reinterpret_cast<uint4*>(dv));
        st8(dz1s + r * LDH + col0 + lc, *reinterpret_cast<uint4*>(dv));
        __syncwarp();
        colsum += tile_colsum(w1s);
        __syncwarp();
      }
      if (lane < 16) part[PV_B1M + col0 + lane] = colsum;
    }
  }
  __syncthreads();
  // dyn = bf16(dz1) @ W1^T (f32, R4+R5)
  gemm64<true>(dz1s, LDH, HIDP, P.w1, HIDP, CP, scr,
               [&](int r, int col, const float* v) {
#pragma unroll
                 for (int e = 0; e < 8; ++e) f4[r * CP + col + e] = v[e];
               });
  __syncthreads();
  // LN2 backward: xhat2 in place of x1, and each row's two means
  for (int rr = 0; rr < NT / 8; ++rr) {
    const int r = warp * (NT / 8) + rr;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < CP; c += 32) {
      float xh = 0.f;
      if (r < n && c < C) {
        xh = (xs[r * CP + c] - mu2[r]) * rs2[r];
        const float dxh = f4[r * CP + c] * P.g2[c];
        s1 += dxh;
        s2 += dxh * xh;
      }
      xs[r * CP + c] = xh;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      lm1[r] = s1 * inv_c;
      lm2[r] = s2 * inv_c;
    }
  }
  __syncthreads();
  if (tid < CP) {   // dgamma2, dbeta2, d(fc2 bias)
    const int c = tid;
    float sg = 0.f, sb = 0.f, sy = 0.f;
    for (int r = 0; r < NT; ++r) {
      const float d = f4[r * CP + c];
      sg += d * xs[r * CP + c];
      sb += d;
      if (r < n && c < C) sy += P.dy[tok[r] * C + c];
    }
    part[PV_G2 + c] = sg;
    part[PV_B2 + c] = sb;
    part[PV_B2M + c] = sy;
  }
  __syncthreads();
  // dx1 = dy + LN2'(dyn): f32 in R0, bf16 in R1 (the dWp pair)
  for (int idx = tid; idx < NT * CP; idx += THREADS) {
    const int r = idx / CP, c = idx % CP;
    float v = 0.f;
    if (r < n && c < C)
      v = P.dy[tok[r] * C + c] +
          rs2[r] * (f4[idx] * P.g2[c] - lm1[r] - xs[idx] * lm2[r]);
    xs[idx] = v;
    r1[r * LDA + c] = f2bf(v);
  }
  __syncthreads();
  if (tid < CP) {
    float s = 0.f;
    for (int r = 0; r < NT; ++r) s += xs[r * CP + tid];
    part[PV_BP + tid] = s;
  }
  copy_rows(P.dx1 + t0 * CP, CP, r1, LDA, CP);
  // do = bf16(bf16(dx1) @ Wp^T) into R5
  gemm64<true>(r1, LDA, CP, P.wp, CP, CP, scr,
               [&](int r, int col, const float* v) {
                 __align__(16) bf16 o[8];
#pragma unroll
                 for (int e = 0; e < 8; ++e) o[e] = f2bf(v[e]);
                 st8(os + r * LDA + col, *reinterpret_cast<uint4*>(o));
               });
  __syncthreads();
  // q, k, v again, from the xn written above
  copy_rows(r1, LDA, P.xn + t0 * CP, CP, CP);
  __syncthreads();
  gemm64<false>(r1, LDA, CP, P.wqkv, QKV, QKV, scr, qkv_epi);
  // head slots past `heads` get zero gradients
  for (int i = tid; i < NT * 3 * (CP / HD - heads) * (HD / 8); i += THREADS) {
    const int per = HD / 8, slots = CP / HD - heads;
    const int r = i / (3 * slots * per), rem = i % (3 * slots * per);
    const int p = rem / (slots * per), s = (rem / per) % slots, c8 = rem % per;
    st8(P.dqkv + (t0 + r) * QKV + p * CP + HD * (heads + s) + 8 * c8, zero8());
  }
  __syncthreads();

  // attention backward, head by head
  for (int h = 0; h < heads; ++h) {
    scores(h);
    __syncthreads();
    softmax(h, true);
    __syncthreads();
    {
      const int ti = warp / 2, tj0 = (warp % 2) * 2;
      // dP = do_h @ v_h^T (f32, R1)
      FragC acc[2];
      wm::fill_fragment(acc[0], 0.f);
      wm::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        FragA fa;
        wm::load_matrix_sync(fa, os + 16 * ti * LDA + HD * h + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBt fb;
          wm::load_matrix_sync(fb, vs + 16 * (tj0 + j) * LDA + HD * h + kk,
                               LDA);
          wm::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wm::store_matrix_sync(dPs + 16 * ti * LDS + 16 * (tj0 + j), acc[j],
                              LDS, wm::mem_row_major);
      // dv_h = bf16(P)^T @ do_h
      const int tj = warp % 2;
      FragC dv;
      wm::fill_fragment(dv, 0.f);
#pragma unroll
      for (int kk = 0; kk < NT; kk += 16) {
        FragAt fa;
        FragB fb;
        wm::load_matrix_sync(fa, Pm + kk * LDP + 16 * ti, LDP);
        wm::load_matrix_sync(fb, os + kk * LDA + HD * h + 16 * tj, LDA);
        wm::mma_sync(dv, fa, fb, dv);
      }
      float* wsc = scr + warp * 512;
      wm::store_matrix_sync(wsc, dv, 16, wm::mem_row_major);
      __syncwarp();
      const float cs = tile_colsum(wsc);
      if (lane < 16) csum[2][ti][16 * tj + lane] = cs;
      __align__(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = f2bf(wsc[lr * 16 + lc + e]);
      st8(P.dqkv + (t0 + 16 * ti + lr) * QKV + 2 * CP + HD * h + 16 * tj + lc,
          *reinterpret_cast<uint4*>(o));
    }
    __syncthreads();
    // dl = P * (dP - rowsum(P * dP)): the bias-table partial (f32) and
    // bf16 into Pm
    for (int rr = 0; rr < NT / 8; ++rr) {
      const int r = warp * (NT / 8) + rr;
      float p[2], d[2], s = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        p[t] = S[r * LDS + c];
        d[t] = dPs[r * LDS + c];
        s += p[t] * d[t];
      }
      s = warp_sum(s);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const float dl = p[t] * (d[t] - s);
        Pm[r * LDP + c] = f2bf(dl);
        if (r < n && c < n) part[PV_BIAS + ((size_t)h * n + r) * n + c] = dl;
      }
    }
    if (tid < HD)
      bsum[2 * CP + HD * h + tid] =
          csum[2][0][tid] + csum[2][1][tid] + csum[2][2][tid] + csum[2][3][tid];
    __syncthreads();
    {
      // dq_h = dl @ k_h (bias sum unscaled; the pair and dxn take dq *
      // scale) and dk_h = dl^T @ q_h
      const int ti = warp / 2, tj = warp % 2;
      FragC dq, dk;
      wm::fill_fragment(dq, 0.f);
      wm::fill_fragment(dk, 0.f);
#pragma unroll
      for (int kk = 0; kk < NT; kk += 16) {
        FragA fa;
        FragAt fat;
        FragB fb;
        wm::load_matrix_sync(fa, Pm + 16 * ti * LDP + kk, LDP);
        wm::load_matrix_sync(fb, ks + kk * LDA + HD * h + 16 * tj, LDA);
        wm::mma_sync(dq, fa, fb, dq);
        wm::load_matrix_sync(fat, Pm + kk * LDP + 16 * ti, LDP);
        wm::load_matrix_sync(fb, qs + kk * LDA + HD * h + 16 * tj, LDA);
        wm::mma_sync(dk, fat, fb, dk);
      }
      float* wsc = scr + warp * 512;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        wm::store_matrix_sync(wsc, p == 0 ? dq : dk, 16, wm::mem_row_major);
        __syncwarp();
        const float cs = tile_colsum(wsc);
        if (lane < 16) csum[p][ti][16 * tj + lane] = cs;
        const float sc = p == 0 ? P.scale : 1.f;
        __align__(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = f2bf(wsc[lr * 16 + lc + e] * sc);
        st8(P.dqkv + (t0 + 16 * ti + lr) * QKV + p * CP + HD * h + 16 * tj + lc,
            *reinterpret_cast<uint4*>(o));
        __syncwarp();
      }
    }
    __syncthreads();
    if (tid < 2 * HD) {
      const int p = tid / HD, d = tid % HD;
      bsum[p * CP + HD * h + d] =
          csum[p][0][d] + csum[p][1][d] + csum[p][2][d] + csum[p][3][d];
    }
  }
  __syncthreads();
  for (int i = tid; i < QKV; i += THREADS) part[PV_BQKV + i] = bsum[i];

  // dxn = bf16([dq*scale | dk | dv]) @ Wqkv^T (f32, R2+R3), A read back
  // from this window's rows of the pair buffer
  gemm64<true>(P.dqkv + t0 * QKV, QKV, QKV, P.wqkv, QKV, CP, scr,
               [&](int r, int col, const float* v) {
#pragma unroll
                 for (int e = 0; e < 8; ++e) f2[r * CP + col + e] = v[e];
               });
  __syncthreads();
  // LN1 backward: dx = dx1 + LN1'(dxn); xhat1 kept (R4+R5) for dgamma1
  for (int rr = 0; rr < NT / 8; ++rr) {
    const int r = warp * (NT / 8) + rr;
    float xh[CP / 32];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < CP / 32; ++t) {
      const int c = lane + 32 * t;
      xh[t] = 0.f;
      if (r < n && c < C) {
        xh[t] = (P.x[tok[r] * C + c] - mu1[r]) * rs1[r];
        const float dxh = f2[r * CP + c] * P.g1[c];
        s1 += dxh;
        s2 += dxh * xh[t];
      }
      f4[r * CP + c] = xh[t];
    }
    const float m1 = warp_sum(s1) * inv_c, m2 = warp_sum(s2) * inv_c;
    if (r < n)
#pragma unroll
      for (int t = 0; t < CP / 32; ++t) {
        const int c = lane + 32 * t;
        if (c < C)
          P.dx[tok[r] * C + c] =
              xs[r * CP + c] +
              rs1[r] * (f2[r * CP + c] * P.g1[c] - m1 - xh[t] * m2);
      }
  }
  __syncthreads();
  if (tid < CP) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < NT; ++r) {
      const float d = f2[r * CP + tid];
      sg += d * f4[r * CP + tid];
      sb += d;
    }
    part[PV_G1 + tid] = sg;
    part[PV_B1 + tid] = sb;
  }
}

// dW = A^T B over the tokens for the four products, one block per 64 x 64
// output tile and token chunk (blockIdx.y); f32 partials (chunks, LD).
struct WParams {
  const bf16* a[4];
  const bf16* b[4];
  int m[4], n[4], off[4], tile0[5];
  float* part;
  int LD, T, chunk;
};

__global__ void __launch_bounds__(THREADS) swin_wgrad_kernel(WParams P) {
  const int t = blockIdx.x;
  int p = 0;
  while (p < 3 && t >= P.tile0[p + 1]) ++p;
  const int M = P.m[p], N = P.n[p], local = t - P.tile0[p];
  const int tm = local / (N / 64), tn = local % (N / 64);
  const int warp = threadIdx.x >> 5;
  const int ti = warp / 2, tj0 = (warp % 2) * 2;
  const int k0 = blockIdx.y * P.chunk;
  const int k1 = min(P.T, k0 + P.chunk);
  const bf16* A = P.a[p] + tm * 64 + 16 * ti;
  const bf16* B = P.b[p] + tn * 64 + 16 * tj0;
  FragC acc[2];
  wm::fill_fragment(acc[0], 0.f);
  wm::fill_fragment(acc[1], 0.f);
  for (int k = k0; k < k1; k += 16) {
    FragAt fa;
    wm::load_matrix_sync(fa, A + (size_t)k * M, M);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragB fb;
      wm::load_matrix_sync(fb, B + (size_t)k * N + 16 * j, N);
      wm::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
  float* out = P.part + (size_t)blockIdx.y * P.LD + P.off[p] +
               (size_t)(tm * 64 + 16 * ti) * N + tn * 64 + 16 * tj0;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wm::store_matrix_sync(out + 16 * j, acc[j], N, wm::mem_row_major);
}

// out[e] = the sum over windows of the window partials (e < lw), then the
// sum over chunks of the weight partials; fixed order
__global__ void swin_gsum_kernel(const float* pw, int nw, int lw,
                                 const float* pd, int ns, int ld,
                                 float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (e < lw) {
    for (int w = 0; w < nw; ++w) s += pw[(size_t)w * lw + e];
  } else if (e < lw + ld) {
    for (int i = 0; i < ns; ++i) s += pd[(size_t)i * ld + e - lw];
  } else {
    return;
  }
  out[e] = s;
}

}  // namespace

// ptrs: x, dy, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m, bias,
// dx, xn, dqkv, o, dx1, yn, dz1, hdn, dyb, part
extern "C" int swin_block_bwd(void* const* ptrs, int B, int H, int W, int C,
                              int heads, int ws, int shift, float scale,
                              void* stream) {
  static cudaError_t attr = allow_smem(swin_bwd_kernel, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (C < 1 || C > CP || heads < 1 || heads * HD > CP || C / heads > HD ||
      ws < 1 || ws * ws > NT || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  Params P;
  int k = 0;
  P.x = (const float*)ptrs[k++];
  P.dy = (const float*)ptrs[k++];
  P.g1 = (const float*)ptrs[k++];
  P.b1 = (const float*)ptrs[k++];
  P.wqkv = (const bf16*)ptrs[k++];
  P.bqkv = (const float*)ptrs[k++];
  P.wp = (const bf16*)ptrs[k++];
  P.bp = (const float*)ptrs[k++];
  P.g2 = (const float*)ptrs[k++];
  P.b2 = (const float*)ptrs[k++];
  P.w1 = (const bf16*)ptrs[k++];
  P.b1m = (const float*)ptrs[k++];
  P.w2 = (const bf16*)ptrs[k++];
  P.b2m = (const float*)ptrs[k++];
  P.bias = (const float*)ptrs[k++];
  P.dx = (float*)ptrs[k++];
  P.xn = (bf16*)ptrs[k++];
  P.dqkv = (bf16*)ptrs[k++];
  P.o = (bf16*)ptrs[k++];
  P.dx1 = (bf16*)ptrs[k++];
  P.yn = (bf16*)ptrs[k++];
  P.dz1 = (bf16*)ptrs[k++];
  P.hdn = (bf16*)ptrs[k++];
  P.dyb = (bf16*)ptrs[k++];
  P.part = (float*)ptrs[k++];
  P.H = H;
  P.W = W;
  P.C = C;
  P.heads = heads;
  P.ws = ws;
  P.shift = shift;
  P.scale = scale;
  const long long blocks = (long long)B * (H / ws) * (W / ws);
  if (blocks < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  swin_bwd_kernel<<<(unsigned)blocks, THREADS, SMEM, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// ptrs: xn, dqkv, o, dx1, yn, dz1, hdn, dyb (T rows each), part (splits, LD)
extern "C" int swin_block_wgrad(void* const* ptrs, int T, int splits,
                                void* stream) {
  if (T < 16 || T % 16 || splits < 1) return (int)cudaErrorInvalidValue;
  WParams P;
  const int m[4] = {CP, CP, CP, HIDP}, n[4] = {QKV, CP, HIDP, CP};
  int off = 0, tiles = 0;
  for (int p = 0; p < 4; ++p) {
    P.a[p] = (const bf16*)ptrs[2 * p];
    P.b[p] = (const bf16*)ptrs[2 * p + 1];
    P.m[p] = m[p];
    P.n[p] = n[p];
    P.off[p] = off;
    P.tile0[p] = tiles;
    off += m[p] * n[p];
    tiles += (m[p] / 64) * (n[p] / 64);
  }
  P.tile0[4] = tiles;
  P.part = (float*)ptrs[8];
  P.LD = off;
  P.T = T;
  P.chunk = ((T + splits - 1) / splits + 15) / 16 * 16;
  swin_wgrad_kernel<<<dim3(tiles, splits), THREADS, 0,
                      (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int swin_block_gsum(const float* pw, int nw, int lw,
                               const float* pd, int ns, int ld, float* out,
                               void* stream) {
  if (nw < 1 || lw < 1 || ns < 1 || ld < 1) return (int)cudaErrorInvalidValue;
  const int total = lw + ld;
  swin_gsum_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      pw, nw, lw, pd, ns, ld, out);
  return (int)cudaGetLastError();
}
