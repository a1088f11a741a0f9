// K1 f3p_build: first-layer feature products of the decoder MLPs.
//
// Replaces ciaosr_tpu/ops/pallas/decoder_kernel.py::_build_f3p (kernel
// _f3p_kernel, from_feature mode). Per LR pixel p:
//   u[p]  = 3x3 zero-padded unfold of the raw feature, tap-major (9C)
//   g_k   = u @ W_k0[:9C]
//   g_v   = u @ W_v0[:9C] + csa @ W_v0[9C:9C+DC]
// The TPU kernel also wrote three column-shifted copies, edge rows and
// 128-lane pads of one merged map; all of that is TPU layout and is gone:
// the decode kernel (grid_decode.cu) reads g_k / g_v at edge-clamped
// shifted pixels directly, and rebuilds u from the raw feature itself, so
// u (42 MB of bf16 at a 192x192 tile) is never written.
//
// Bound on the H100: 2*M*(9C*2H + DC*H) = 23.0 GFLOP at M = 192*192,
// C = DC = 64, H = 256, i.e. 23 us at the bf16 dense peak; bytes (feature
// + csa in, g_k + g_v out, ~47 MB) take 14 us, so it is compute-bound.
// SwinIR-CiaoSR (C = 180 padded to 192 with zero weight rows, no CSA) on
// a 256 x 256 map: 109 GFLOP of the function's, 0.11 ms.
// Design: an implicit-im2col GEMM. A block builds the unfolded rows of 32
// pixels (plus their CSA row) in shared memory once, straight from the
// feature, and 8 warps multiply them by the weights on the tensor cores
// (wmma bf16, f32 accumulate); weight fragments stream from L2. Compiled
// for (C, DC) = (64, 64), the flagship, and (192, 0).
#include "common.cuh"

namespace {

constexpr int HID = 256;      // MLP hidden width
constexpr int ROWS = 32;      // pixels per block
constexpr int THREADS = 256;

// C feature channels, DC CSA channels (0: no CSA)
template <int C, int DC>
struct F3p {
  static constexpr int DK = 9 * C;
  static constexpr int LDA = DK + DC + 16;  // 16-row starts 32B-aligned
  static constexpr int SMEM = ROWS * LDA * 2 + 8 * 256 * 4;
};

template <int C, int DC>
__global__ void __launch_bounds__(THREADS)
f3p_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ csa,
           const bf16* __restrict__ wk, const bf16* __restrict__ wvu,
           const bf16* __restrict__ wvc, bf16* __restrict__ gk,
           bf16* __restrict__ gv, int H, int W, int M) {
  constexpr int DK = F3p<C, DC>::DK, LDA = F3p<C, DC>::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + ROWS * LDA * 2);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int p0 = blockIdx.x * ROWS;

  // A rows: [u (9 taps x C) | csa (DC)], 8 bf16 per vector
  constexpr int VPR = (DK + DC) / 8;  // vectors per row (80 at C = DC = 64)
  for (int idx = tid; idx < ROWS * VPR; idx += THREADS) {
    const int r = idx / VPR, j = idx % VPR;
    const int p = p0 + r;
    uint4 v = zero8();
    if (p < M) {
      if (j < DK / 8) {
        const int t = j / (C / 8), cv = j % (C / 8);
        const int x = p % W, y = (p / W) % H, b = p / (W * H);
        const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = ld8(feat + ((size_t)(b * H + yy) * W + xx) * C + cv * 8);
      } else {
        v = ld8(csa + (size_t)p * DC + (j - DK / 8) * 8);
      }
    }
    st8(a + r * LDA + j * 8, v);
  }
  __syncthreads();

  // warps 0-3: g_k columns [64w, 64w+64); warps 4-7: g_v columns
  const bool is_v = warp >= 4;
  const int col0 = (warp & 3) * 64;
  const bf16* wmain = is_v ? wvu : wk;
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[i][j], 0.f);
  FragA fa[2];
  FragB fb;
  const int kend = is_v ? DK + DC : DK;
  for (int k = 0; k < kend; k += 16) {
    const bf16* wrow = k < DK ? wmain + (size_t)k * HID
                              : wvc + (size_t)(k - DK) * HID;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wm::load_matrix_sync(fa[i], a + (16 * i) * LDA + k, LDA);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm::load_matrix_sync(fb, wrow + col0 + 16 * j, HID);
#pragma unroll
      for (int i = 0; i < 2; ++i) wm::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
  }
  bf16* out = is_v ? gv : gk;
  float* ws = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_frag_bf16(acc[i][j], ws, out, HID, p0 + 16 * i, M,
                      col0 + 16 * j);
}

template <int C, int DC>
int launch(const void* feat, const void* csa, const void* wk, const void* wvu,
           const void* wvc, void* gk, void* gv, int B, int H, int W,
           void* stream) {
  constexpr int SMEM = F3p<C, DC>::SMEM;
  static cudaError_t attr = allow_smem(f3p_kernel<C, DC>, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int M = B * H * W;
  dim3 grid((M + ROWS - 1) / ROWS);
  f3p_kernel<C, DC><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)feat, (const bf16*)csa, (const bf16*)wk,
      (const bf16*)wvu, (const bf16*)wvc, (bf16*)gk, (bf16*)gv, H, W, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int f3p_build(const void* feat, const void* csa, const void* wk,
                         const void* wvu, const void* wvc, void* gk, void* gv,
                         int B, int H, int W, int C, int DC, void* stream) {
  if (C == 64 && DC == 64)
    return launch<64, 64>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W, stream);
  if (C == 192 && DC == 0)
    return launch<192, 0>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W, stream);
  return (int)cudaErrorInvalidValue;
}
