// The float32 forward of a square-stencil 3x3 convolution (stride 1, zero
// padding 1, bias) on NHWC maps: the SwinIR trunk's RSTB convs and
// conv_after_body when the model computes in float32 (training). It
// replaces no TPU kernel: the JAX package leaves the convolution to XLA.
// On the H100, cuDNN's heuristics take its FFT route for these convs at
// C = 180 in f32 (TF32 off), a complex f32 GEMM that is ~400x this
// kernel's bound; at 64 channels cuDNN takes implicit GEMM itself.
//
//   out[b, y, x, n] = bias[n] + sum over (t = (dy, dx), ci) of
//     w[(t, ci), n] * x[b, y + dy - 1, x + dx - 1, ci]    (0 off the map)
//
// w is the weight re-laid tap-major, (9 * Cin, Cout) row-major
// (ops/kernels/conv3x3.py::relayout_weight).
//
// Bound on the H100: operations. An implicit GEMM of M = B*H*W pixels, N =
// Cout, K = 9 * Cin: 2 M N K FLOP (14.33 GFLOP at 6 x 64^2 x 180), 0.214 ms
// at the f32 peak of 67 TFLOP/s; the map in, the map out and the weights
// are ~37 MB, 0.011 ms at 3.35 TB/s. The precision is the model's: full
// f32 FFMA, no TF32 (nor its 3-way split), no bf16.
//
// Design. A block owns a BM x BN = 128 pixels x 96 channels output tile
// (Cout = 180 is two tiles, 6.7% of the columns padding) and walks K in
// stages of one tap and BK = 20 input channels (180 = 9 stages a tap),
// channel chunk outer and tap inner, so that the nine taps of a chunk read
// the same pixels back to back. A 4-stage shared-memory ring is filled by
// cp.async: the A tile (im2col rows, 128 x 20, pixel-major, 80 B a row)
// straight from the NHWC map, its zero halo and the tile's rows past M
// filled by cp.async's zero fill (source size 0), no padded copy; the B
// tile (20 x 96) from the re-laid weight, columns past Cout zero-filled.
// Each thread holds an 8 x 12 register tile of f32 accumulators (rows tm
// + 16 i, columns 4 tn + 32 j + e) and multiplies by outer products, A as
// float4 runs of 4 channels of a row (conflict-free at the 20-float row
// pitch) and B as float4 runs of its row. Three blocks share a
// multiprocessor (168 registers, 72 KB of shared memory each). The bias is
// added in the epilogue, which stores float4s straight to the NHWC output.
// Every output is one sum in a fixed order (stage by stage, channel by
// channel, then the bias): no split-K, no atomic, the same bits from
// launch to launch.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 96, BK = 20, STAGES = 4, THREADS = 128;
constexpr int TM = 8, TN = 12;                 // a thread's output tile
constexpr int A_FLOATS = BM * BK, B_FLOATS = BK * BN;
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int SMEM = STAGES * STAGE_FLOATS * 4;  // 71,680 bytes
constexpr int A_VECS = BM * BK / 4 / THREADS;    // 5 float4 copies a thread
constexpr int B_VEC_COUNT = BK * BN / 4;         // 480
constexpr int B_VECS = (B_VEC_COUNT + THREADS - 1) / THREADS;
static_assert(BM * BK / 4 % THREADS == 0, "A copies must split evenly");
static_assert(BM == 16 * TM && BN == 8 * TN, "thread grid 16 x 8");

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS, 3)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int Cin, int Cout, int M, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int rows[BM];  // (y << 16) | x of each tile row; -1 past M
  const int tid = threadIdx.x;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  for (int r = tid; r < BM; r += THREADS) {
    const int p = m0 + r;
    rows[r] = p < M ? (((p / W) % H) << 16) | (p % W) : -1;
  }
  __syncthreads();
  const int chunks = (Cin + BK - 1) / BK;
  const int KT = 9 * chunks;

  // stage kt: channels [c BK, c BK + BK) of tap t, into ring slot `slot`
  auto load = [&](int slot, int kt) {
    const int c = kt / 9, t = kt - 9 * c;
    const int dy = t / 3 - 1, dx = t % 3 - 1, ci0 = c * BK;
    float* As = smem + slot * STAGE_FLOATS;
    float* Bs = As + A_FLOATS;
#pragma unroll
    for (int j = 0; j < A_VECS; ++j) {
      const int s = tid + j * THREADS;
      const int r = s / (BK / 4), q = s - (BK / 4) * r;
      const int info = rows[r];
      const int yy = (info >> 16) + dy, xx = (info & 0xffff) + dx;
      const int ci = ci0 + 4 * q;
      const bool ok = info >= 0 && (unsigned)yy < (unsigned)H &&
                      (unsigned)xx < (unsigned)W && ci < Cin;
      const float* src =
          ok ? x + ((long long)(m0 + r + dy * W + dx) * Cin + ci) : x;
      cp16(As + r * BK + 4 * q, src, ok);
    }
#pragma unroll
    for (int j = 0; j < B_VECS; ++j) {
      const int s = tid + j * THREADS;
      if (s < B_VEC_COUNT) {
        const int k = s / (BN / 4), nq = s - (BN / 4) * k;
        const int ci = ci0 + k, n = n0 + 4 * nq;
        const bool ok = ci < Cin && n < Cout;
        const float* src =
            ok ? w + ((long long)(t * Cin + ci) * Cout + n) : w;
        cp16(Bs + k * BN + 4 * nq, src, ok);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int tm = 4 * warp + (lane >> 3), tn = lane & 7;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; slot (kt - 1) % STAGES is free
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_commit();
    const float* As = smem + (kt % STAGES) * STAGE_FLOATS + tm * BK;
    const float* Bs = smem + (kt % STAGES) * STAGE_FLOATS + A_FLOATS + 4 * tn;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + 16 * i * BK + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 b[TN / 4];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(Bs + (kk + e) * BN + 32 * j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = e == 0 ? a[i].x : e == 1 ? a[i].y
                         : e == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN / 4; ++j) {
            acc[i][4 * j + 0] = fmaf(av, b[j].x, acc[i][4 * j + 0]);
            acc[i][4 * j + 1] = fmaf(av, b[j].y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(av, b[j].z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(av, b[j].w, acc[i][4 * j + 3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + tm + 16 * i;
    if (p >= M) continue;
    float* o = out + (long long)p * Cout;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n = n0 + 4 * tn + 32 * j;
      if (n < Cout) {
        float4 v;
        v.x = acc[i][4 * j + 0] + __ldg(bias + n + 0);
        v.y = acc[i][4 * j + 1] + __ldg(bias + n + 1);
        v.z = acc[i][4 * j + 2] + __ldg(bias + n + 2);
        v.w = acc[i][4 * j + 3] + __ldg(bias + n + 3);
        *reinterpret_cast<float4*>(o + n) = v;
      }
    }
  }
}

}  // namespace

// x (B, H, W, Cin) f32 NHWC, w (9 Cin, Cout) f32 tap-major, bias (Cout)
// f32 -> out (B, H, W, Cout) f32, every element written. Cin and Cout
// multiples of 4, H and W under 32768, B H W under 2^31; pointers 16-byte
// aligned (the wrapper checks).
extern "C" int conv3x3_f32(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int Cin, int Cout,
                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 4 ||
      Cout % 4 || H >= 32768 || W >= 32768)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL - BM) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = allow_smem(conv3x3_kernel, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int n_tiles = (Cout + BN - 1) / BN;
  const long long blocks = (M + BM - 1) / BM * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  conv3x3_kernel<<<(unsigned)blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)out, H, W,
      Cin, Cout, (int)M, n_tiles);
  return (int)cudaGetLastError();
}
