// K2 wt_hoist: the hoisted output layer of imnet_k, for the nine shifts.
//
// Replaces ciaosr_tpu/ops/pallas/decoder_kernel.py::_wt_hoist_planes
// (kernel _wt_kernel). For each LR pixel p and each d in {-1,0,1}^2:
//   qk_d  = u[p] (.) u[clamp(p + d)]            (bf16 product, 9C wide)
//   wt_d  = qk_d @ W_kout^T                     (9C -> 256, bf16 out)
//   ck_d  = qk_d . b_kout                       (one f32 per (d, p))
// u is the 3x3 zero-padded unfold of the raw feature; the shift clamps at
// the image edge AFTER the unfold (u is not the unfold of a clamped map).
// The decode kernel then computes each logit as wt_d . h_k + ck_d and
// skips the 256 -> 9C matmul. The TPU's 8-lane bmat for ck is layout only.
//
// Bound on the H100: 2*9*M*9C*256 = 97.8 GFLOP (+0.4 for ck) at
// M = 192*192, C = 64: 99 us at the bf16 dense peak. Bytes: the 170 MB of
// bf16 wt written (+1.3 MB ck, 4.7 MB feature read) take 52 us, so it is
// compute-bound. SwinIR-CiaoSR (C = 180 padded to 192 with zero weight
// rows) on a 256 x 256 map: 489 GFLOP of the function's, 0.49 ms.
// Without the unfold (feat_unfold=False, TAPS = 1) u is the feature
// itself, DK = C: the TPU kernel still forms the nine shifted planes, of
// the feature, so the same kernel runs with one tap; 10.9 GFLOP at
// M = 192*192, C = 64, where the 170 MB of wt written set the bound.
// Design: implicit GEMM as in f3p_build.cu. A block takes
// 32 pixels and one shift, builds the 32 x DK qk rows in shared memory
// from two gathers of the feature, and 8 warps run the DK -> 256 product
// on the tensor cores; ck is a warp-reduced dot product of the same rows.
// Compiled for C = 64 (the flagship) and C = 192 with the unfold, and for
// C = 64 without it.
#include "common.cuh"

namespace {

constexpr int HID = 256;
constexpr int ROWS = 32;
constexpr int THREADS = 256;

template <int C, int TAPS>
struct Wt {
  static constexpr int DK = TAPS * C;
  static constexpr int LDA = DK + 16;  // 16-row starts stay 32B-aligned
  static constexpr int SMEM = ROWS * LDA * 2 + 8 * 256 * 4;
};

template <int C, int TAPS>
__global__ void __launch_bounds__(THREADS)
wt_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ wkt,
          const float* __restrict__ bk, bf16* __restrict__ wt,
          float* __restrict__ ck, int H, int W, int M) {
  constexpr int DK = Wt<C, TAPS>::DK, LDA = Wt<C, TAPS>::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + ROWS * LDA * 2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * ROWS;
  const int d = blockIdx.y;
  const int dy = d / 3 - 1, dx = d % 3 - 1;

  constexpr int VPR = DK / 8;  // vectors per row
  for (int idx = tid; idx < ROWS * VPR; idx += THREADS) {
    const int r = idx / VPR, j = idx % VPR;
    const int p = p0 + r;
    __align__(16) bf16 v[8];
    *reinterpret_cast<uint4*>(v) = zero8();
    if (p < M) {
      const int t = j / (C / 8), cv = j % (C / 8);
      const int x = p % W, y = (p / W) % H, b = p / (W * H);
      // the tap's offset; none at one tap (u is the feature)
      const int ty = TAPS == 9 ? t / 3 - 1 : 0;
      const int tx = TAPS == 9 ? t % 3 - 1 : 0;
      const int ys = clampi(y + dy, 0, H - 1), xs = clampi(x + dx, 0, W - 1);
      const int y0 = y + ty, x0 = x + tx, y1 = ys + ty, x1 = xs + tx;
      if (y0 >= 0 && y0 < H && x0 >= 0 && x0 < W && y1 >= 0 && y1 < H &&
          x1 >= 0 && x1 < W) {
        __align__(16) bf16 q[8], k[8];
        *reinterpret_cast<uint4*>(q) =
            ld8(feat + ((size_t)(b * H + y0) * W + x0) * C + cv * 8);
        *reinterpret_cast<uint4*>(k) =
            ld8(feat + ((size_t)(b * H + y1) * W + x1) * C + cv * 8);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = f2bf(bf2f(q[i]) * bf2f(k[i]));
      }
    }
    st8(a + r * LDA + j * 8, *reinterpret_cast<uint4*>(v));
  }
  __syncthreads();

  // ck: warp w reduces rows 4w .. 4w+3
  for (int rr = 0; rr < 4; ++rr) {
    const int r = warp * 4 + rr;
    float s = 0.f;
    for (int j = lane; j < DK; j += 32) s += bf2f(a[r * LDA + j]) * bk[j];
    s = warp_sum(s);
    if (lane == 0 && p0 + r < M) ck[(size_t)d * M + p0 + r] = s;
  }

  // wt: warp w owns output columns [32w, 32w+32)
  const int col0 = warp * 32;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);
  FragA fa[2];
  FragB fb;
  for (int k = 0; k < DK; k += 16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wm::load_matrix_sync(fa[i], a + (16 * i) * LDA + k, LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wm::load_matrix_sync(fb, wkt + (size_t)k * HID + col0 + 16 * j, HID);
#pragma unroll
      for (int i = 0; i < 2; ++i) wm::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
  }
  bf16* out = wt + (size_t)d * M * HID;
  float* ws = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      store_frag_bf16(acc[i][j], ws, out, HID, p0 + 16 * i, M,
                      col0 + 16 * j);
}

template <int C, int TAPS>
int launch(const void* feat, const void* wkt, const void* bk, void* wt,
           void* ck, int B, int H, int W, void* stream) {
  constexpr int SMEM = Wt<C, TAPS>::SMEM;
  static cudaError_t attr = allow_smem(wt_kernel<C, TAPS>, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int M = B * H * W;
  dim3 grid((M + ROWS - 1) / ROWS, 9);
  wt_kernel<C, TAPS><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)feat, (const bf16*)wkt, (const float*)bk, (bf16*)wt,
      (float*)ck, H, W, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wt_hoist(const void* feat, const void* wkt, const void* bk,
                        void* wt, void* ck, int B, int H, int W, int C,
                        int taps, void* stream) {
  if (C == 64 && taps == 9)
    return launch<64, 9>(feat, wkt, bk, wt, ck, B, H, W, stream);
  if (C == 192 && taps == 9)
    return launch<192, 9>(feat, wkt, bk, wt, ck, B, H, W, stream);
  if (C == 64 && taps == 1)
    return launch<64, 1>(feat, wkt, bk, wt, ck, B, H, W, stream);
  return (int)cudaErrorInvalidValue;
}
