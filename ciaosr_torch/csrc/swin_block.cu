// Row 11 swin_block: one whole Swin transformer block, one window a block.
//
// Replaces ciaosr_tpu/ops/pallas/swin_block.py::_swin_block_call (kernel
// _block_kernel, the forward of swin_block_fused). On a token map x
// (B, H, W, C) f32 that is already rolled by the block's shift, for each
// ws x ws window (N = ws^2 <= 64 tokens):
//   xn = LN1(x) (bf16); q = xn@Wq*scale + bq*scale, k = xn@Wk + bk,
//   v = xn@Wv + bv (f32, then bf16)
//   per head h: P = softmax(q_h k_h^T + bias_h [+ shift mask]) (f32),
//               o_h = bf16(P) v_h (f32, then bf16)
//   x1 = x + o@Wp + bp;  y = x1 + bf16(GELU(bf16(LN2(x1))@W1 + b1))@W2 + b2
// with every matmul operand bf16 and every sum, softmax, LayerNorm and the
// exact-erf GELU in f32, as the TPU kernel casts; y is f32.
//
// Layout (ops/kernels/swin_block.py::pack_swin_block): C <= 192 is padded
// to CP = 192 and the MLP hidden width to HIDP = 384 with zero weights,
// and head h of q/k/v owns columns [32h, 32h + head_dim) of its 192-wide
// part, so each head's scores are a 64 x 64 x 32 product. LayerNorm
// averages over the C real channels only. The TPU kernel's full-C lane
// masks per head, its window-row grid and its deduplicated mask kinds are
// TPU layout and are gone: the shift mask is recomputed from the window's
// position (three regions per axis), and the roll stays outside.
//
// Bound on the H100 (SwinIR-CiaoSR, C = 180, 6 heads, hidden 360, one
// 256 x 256 map): 2*T*C*(3C + C + 2*360) + 4*T*64*C = 37.0 GFLOP at
// T = 65536, 37 us at the bf16 dense peak; x in and y out (f32, 94 MB)
// take 28 us. Design, a simple first kernel: one block per window, 8 warps.
// The window's x (f32), LN output, q, k and v (bf16) and one head's 64 x 64
// scores stay in shared memory (182 KB, one block per SM); each product is
// wmma bf16 16x16x16 with f32 accumulate, A from shared memory, the weight
// fragments straight from global memory (0.6 MB of bf16 weights, L2-
// resident across the 1024 windows), a warp owning 64 x 32 output tiles.
// The MLP hidden activations reuse the k and v buffers.
#include "common.cuh"

namespace {

constexpr int CP = 192;     // packed residual width
constexpr int HD = 32;      // head slot
constexpr int HIDP = 384;   // packed MLP hidden width
constexpr int NT = 64;      // tokens per window, at most
constexpr int THREADS = 256;
constexpr int LDA = CP + 8;      // 200: bf16 rows of xn, q, k, v
constexpr int LDH = HIDP + 8;    // 392: bf16 rows of the MLP hidden
constexpr int LDS = NT + 4;      // 68: f32 score rows
constexpr int LDP = NT + 8;      // 72: bf16 probability rows
constexpr float LN_EPS = 1e-5f;

constexpr int OFF_XN = NT * CP * 4;               // x / x1: 49152 B
constexpr int OFF_Q = OFF_XN + NT * LDA * 2;      // xn / LN2 out: 25600 B
constexpr int OFF_K = OFF_Q + NT * LDA * 2;       // q, then attention out
constexpr int OFF_V = OFF_K + NT * LDA * 2;
constexpr int OFF_S = OFF_V + NT * LDA * 2;
constexpr int OFF_P = OFF_S + NT * LDS * 4;       // scores: 17408 B
constexpr int OFF_SCR = OFF_P + NT * LDP * 2;     // probabilities: 9216 B
constexpr int SMEM = OFF_SCR + 8 * 256 * 4;       // 186368 B
static_assert(NT * LDH * 2 <= 2 * NT * LDA * 2, "hidden must fit in k, v");

struct Params {
  const float* x;
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
  float* out;
  int H, W, C, heads, ws, shift;
  float scale;
};

// C = A[64 x K] @ B[K x ncols] in 64 x 32 units, unit u = warp, warp + 8,
// ...; A is bf16 in shared memory, B bf16 in global memory (row-major, ld
// ldb). epi(row, col, v) gets 8 consecutive f32 results v[0..7] of row
// `row`, columns col..col+7. No barrier inside.
template <typename Epi>
__device__ __forceinline__ void gemm64(const bf16* A, int lda, int K,
                                       const bf16* B, int ldb, int ncols,
                                       float* scr, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws = scr + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
  for (int col0 = warp * 32; col0 < ncols; col0 += 8 * 32) {
    FragC acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);
    for (int k = 0; k < K; k += 16) {
      FragB fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wm::load_matrix_sync(fb[j], B + (size_t)k * ldb + col0 + 16 * j, ldb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA fa;
        wm::load_matrix_sync(fa, A + 16 * i * lda + k, lda);
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
// rows of `out` (CP wide; padded channels and rows past n are 0). A warp
// a row, 8 rows a warp.
__device__ __forceinline__ void layer_norm(const float* x, const float* g,
                                           const float* b, bf16* out, int n,
                                           int C) {
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
    for (int c = lane; c < CP; c += 32)
      out[r * LDA + c] = f2bf(c < C ? (xr[c] - mu) * rs * g[c] + b[c] : 0.f);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shift-mask region of a rolled coordinate (the JAX package's _attn_mask:
// [0, n - ws), [n - ws, n - shift), [n - shift, n))
__device__ __forceinline__ int region(int y, int n, int ws, int shift) {
  return y < n - ws ? 0 : (y < n - shift ? 1 : 2);
}

__global__ void __launch_bounds__(THREADS) swin_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  bf16* xn = reinterpret_cast<bf16*>(smem + OFF_XN);
  bf16* qs = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + OFF_V);
  bf16* hs = ks;  // the MLP hidden, once attention is done
  float* S = reinterpret_cast<float*>(smem + OFF_S);
  bf16* Pm = reinterpret_cast<bf16*>(smem + OFF_P);
  float* scr = reinterpret_cast<float*>(smem + OFF_SCR);
  __shared__ size_t tok[NT];   // pixel of each token (rows past n: 0)
  __shared__ int reg[NT];      // its shift-mask region

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ws = P.ws, n = ws * ws, C = P.C;
  const int nwx = P.W / ws, nwin = (P.H / ws) * nwx;
  const int bimg = blockIdx.x / nwin, win = blockIdx.x % nwin;
  const int wy = win / nwx, wx = win % nwx;

  if (tid < NT) {
    const int ty = tid / ws, tx = tid % ws;
    const int y = wy * ws + ty, x = wx * ws + tx;
    tok[tid] = tid < n ? ((size_t)bimg * P.H + y) * P.W + x : 0;
    reg[tid] = P.shift > 0 ? region(y, P.H, ws, P.shift) * 3 +
                                 region(x, P.W, ws, P.shift)
                           : 0;
  }
  __syncthreads();
  for (int idx = tid; idx < NT * CP; idx += THREADS) {
    const int r = idx / CP, c = idx % CP;
    xs[idx] = (r < n && c < C) ? P.x[tok[r] * C + c] : 0.f;
  }
  __syncthreads();

  // ---- LN1, then q | k | v = xn @ Wqkv (+ biases, q scaled) in bf16
  layer_norm(xs, P.g1, P.b1, xn, n, C);
  __syncthreads();
  gemm64(xn, LDA, CP, P.wqkv, 3 * CP, 3 * CP, scr,
         [&](int r, int col, const float* v) {
           const int part = col / CP, cc = col % CP;
           bf16* dst = (part == 0 ? qs : part == 1 ? ks : vs) + r * LDA + cc;
           const float sc = part == 0 ? P.scale : 1.f;
           __align__(16) bf16 o[8];
#pragma unroll
           for (int e = 0; e < 8; ++e) o[e] = f2bf(v[e] * sc + P.bqkv[col + e]);
           st8(dst, *reinterpret_cast<uint4*>(o));
         });
  __syncthreads();

  // ---- attention, head by head; o_h overwrites q_h
  for (int h = 0; h < P.heads; ++h) {
    {  // S = q_h k_h^T: 16 tiles of 16 x 16, two a warp, K = 32
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
          FragBt fb;  // k_h^T: column n of the tile is row n of k
          wm::load_matrix_sync(fb, ks + 16 * (tj0 + j) * LDA + HD * h + kk,
                               LDA);
          wm::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wm::store_matrix_sync(S + 16 * ti * LDS + 16 * (tj0 + j), acc[j], LDS,
                              wm::mem_row_major);
    }
    __syncthreads();
    // softmax over the keys of each row (+ bias, + mask), f32; keys past n
    // get probability 0
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
      for (int t = 0; t < 2; ++t)
        Pm[r * LDP + lane + 32 * t] = f2bf(r < n ? e[t] / s : 0.f);
    }
    __syncthreads();
    {  // o_h = P v_h: 8 tiles of 16 x 16, one a warp, K = 64
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
      float* wsc = scr + warp * 256;
      wm::store_matrix_sync(wsc, acc, 16, wm::mem_row_major);
      __syncwarp();
      const int r = lane >> 1, c = (lane & 1) * 8;
      __align__(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = f2bf(wsc[r * 16 + c + e]);
      st8(qs + (16 * ti + r) * LDA + HD * h + 16 * tj + c,
          *reinterpret_cast<uint4*>(o));
    }
    __syncthreads();
  }

  // ---- x1 = x + o @ Wp + bp (in place in xs)
  gemm64(qs, LDA, CP, P.wp, CP, CP, scr, [&](int r, int col, const float* v) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      xs[r * CP + col + e] = xs[r * CP + col + e] + v[e] + P.bp[col + e];
  });
  __syncthreads();

  // ---- LN2, hidden = bf16(GELU(yn @ W1 + b1)), y = x1 + hidden @ W2 + b2
  layer_norm(xs, P.g2, P.b2, xn, n, C);
  __syncthreads();
  gemm64(xn, LDA, CP, P.w1, HIDP, HIDP, scr,
         [&](int r, int col, const float* v) {
           __align__(16) bf16 o[8];
#pragma unroll
           for (int e = 0; e < 8; ++e) {
             const float z = v[e] + P.b1m[col + e];
             o[e] = f2bf(0.5f * z * (1.f + erff(z * 0.70710678118654752f)));
           }
           st8(hs + r * LDH + col, *reinterpret_cast<uint4*>(o));
         });
  __syncthreads();
  gemm64(hs, LDH, HIDP, P.w2, CP, CP, scr,
         [&](int r, int col, const float* v) {
           if (r >= n) return;
           float* dst = P.out + tok[r] * C;
#pragma unroll
           for (int e = 0; e < 8; ++e)
             if (col + e < C)
               dst[col + e] = xs[r * CP + col + e] + v[e] + P.b2m[col + e];
         });
}

}  // namespace

// ptrs: x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m, bias, out
extern "C" int swin_block(void* const* ptrs, int B, int H, int W, int C,
                          int heads, int ws, int shift, float scale,
                          void* stream) {
  static cudaError_t attr = allow_smem(swin_kernel, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (C < 1 || C > CP || heads < 1 || heads * HD > CP || C / heads > HD ||
      ws < 1 || ws * ws > NT || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  Params P;
  int k = 0;
  P.x = (const float*)ptrs[k++];
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
  P.out = (float*)ptrs[k++];
  P.H = H;
  P.W = W;
  P.C = C;
  P.heads = heads;
  P.ws = ws;
  P.shift = shift;
  P.scale = scale;
  const long long blocks = (long long)B * (H / ws) * (W / ws);
  if (blocks < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  swin_kernel<<<(unsigned)blocks, THREADS, SMEM, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
