// K1 f3p_build: first-layer feature products of the decoder MLPs.
//
// Replaces ciaosr_tpu/ops/pallas/decoder_kernel.py::_build_f3p (kernel
// _f3p_kernel, from_feature mode). Per LR pixel p:
//   u[p]  = 3x3 zero-padded unfold of the raw feature, tap-major (9C)
//   g_k   = u @ W_k0[:9C]
//   g_v   = u @ W_v0[:9C] + csa @ W_v0[9C:9C+DC]
// The TPU kernel also wrote three column-shifted copies, edge rows and
// 128-lane pads of one merged map; all of that is TPU layout and is gone:
// the decode kernel (grid_decode_sm90.cu, both modes) reads g_k / g_v at
// edge-clamped shifted pixels or the rational tables' keys directly, and
// rebuilds u from the raw feature itself, so u (42 MB of bf16 at a
// 192x192 tile) is never written.
//
// Bound on the H100: 2*M*(9C*2H + DC*H) = 23.0 GFLOP at M = 192*192,
// C = DC = 64, H = 256, i.e. 23 us at the bf16 dense peak; bytes (feature
// + csa in, g_k + g_v out, ~47 MB) take 14 us, so it is compute-bound.
// SwinIR-CiaoSR (C = 180 padded to 192 with zero weight rows, no CSA) on
// a 256 x 256 map: 109 GFLOP of the function's, 0.11 ms; with CSA (DC =
// 180) on a 192 x 192 tile: 64.6 GFLOP, 0.065 ms.
//
// Design: an implicit-im2col GEMM on wgmma, fed by TMA (csrc/sm90.cuh).
// A block owns a 16 x 8 pixel patch (M = 128 rows) and one output, g_k or
// g_v (256 columns): two consumer warpgroups hold 64 x 256 f32
// accumulators, one producer warp streams 64-deep K chunks through a
// 4-stage shared-memory ring synchronised by mbarriers. Chunk kc is one
// tap's 64-channel slice: the A tile is one 4-D TMA box (64 channels x
// 16 x 8 pixels) of the feature shifted by the tap, so the unfold is never
// formed and TMA's zero fill out of bounds is the 3x3 zero padding; the
// CSA chunk of g_v is the same box of the CSA map at the centre. The B
// tile is four TMA boxes (64 columns x 64 rows) of the (9C, 256) weight
// matrix as it is, read MN-major by wgmma. Each weight byte read from L2
// serves 128 pixels, and loads overlap products. The epilogue stages the
// bf16 tile in shared memory and stores it by TMA: 4-byte stores from the
// accumulator registers took half of the kernel's time.
// Compiled for (C, DC) = (64, 64), the flagship, (192, 0), SwinIR-CiaoSR
// without CSA, and (192, 192), SwinIR-CiaoSR with CSA (config 001 swinir:
// its 180 feature and CSA channels zero-padded to 192 on the host, so the
// CSA map's 64-channel chunks are three and TMA rows 384 bytes). Without
// the unfold (feat_unfold=False: TAPS = 1, the from_feature=False mode of
// the TPU kernel with u_map = feature) u is the feature itself: the
// unfold's nine K chunks a channel slice become one, at the centre, and
// the weight maps have C rows. Compiled so at (64, 64): g_k is one
// K = 64 product and g_v two (feature, CSA); and at (192, 0) and
// (192, 192), SwinIR-CiaoSR without the unfold: g_k is three K chunks
// (the centre's channel slices), g_v three more of the CSA map with it.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int HID = 256;           // MLP hidden width: the output columns
constexpr int BW = 16, BH = 8;     // pixel patch of a block
constexpr int BM = BW * BH;        // 128 rows
constexpr int KC = 64;             // K chunk: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * KC * 2;        // 16 KB
constexpr int SLAB = KC * 128;              // 64 weight rows x 64 columns
constexpr int B_BYTES = (HID / 64) * SLAB;  // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CONSUMERS = 2;                // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(CONSUMERS * HID * 64 * 2 <= STAGES * STAGE_BYTES,
              "the epilogue tiles overlay the ring");

template <int C, int DC, int TAPS>
__global__ void __launch_bounds__(THREADS, 1)
f3p_kernel(const __grid_constant__ CUtensorMap tm_feat,
           const __grid_constant__ CUtensorMap tm_csa,
           const __grid_constant__ CUtensorMap tm_wk,
           const __grid_constant__ CUtensorMap tm_wvu,
           const __grid_constant__ CUtensorMap tm_wvc,
           const __grid_constant__ CUtensorMap tm_gk,
           const __grid_constant__ CUtensorMap tm_gv) {
  constexpr int CS = C / KC;    // channel slices a tap
  constexpr int NKU = TAPS * CS;  // K chunks of the unfold (of u)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * BH;
  const int b = blockIdx.z >> 1;
  const bool is_v = blockIdx.z & 1;
  // g_v adds DC / KC chunks of the CSA map (one at the flagship's 64)
  const int nk = NKU + (is_v ? DC / KC : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {  // the producer warp: one thread issues
    if (lane == 0) {
      const CUtensorMap* wmap = is_v ? &tm_wvu : &tm_wk;
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % STAGES;
        if (kc >= STAGES) mbar_wait(&empty[s], (kc / STAGES - 1) & 1);
        unsigned char* a = smem + s * STAGE_BYTES;
        unsigned char* bt = a + A_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        if (kc < NKU) {
          // the tap's shifted box; at one tap the centre
          const int t = TAPS == 9 ? kc / CS : 4, cs = kc % CS;
          tma_load_4d(a, &tm_feat, &full[s], cs * KC, x0 + t % 3 - 1,
                      y0 + t / 3 - 1, b);
          for (int j = 0; j < HID / 64; ++j)
            tma_load_2d(bt + j * SLAB, wmap, &full[s], j * 64, kc * KC);
        } else {  // a CSA chunk of g_v, at the centre tap
          const int c0 = DC > KC ? (kc - NKU) * KC : 0;
          tma_load_4d(a, &tm_csa, &full[s], c0, x0, y0, b);
          for (int j = 0; j < HID / 64; ++j)
            tma_load_2d(bt + j * SLAB, &tm_wvc, &full[s], j * 64, c0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: patch rows 64 wg .. 64 wg + 63 (pixel rows
  // y0 + 4 wg .. y0 + 4 wg + 3)
  const int wg = warp >> 2;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % STAGES;
    mbar_wait(&full[s], (kc / STAGES) & 1);
    const unsigned char* a = smem + s * STAGE_BYTES + wg * (64 * 128);
    const unsigned char* bt = smem + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < KC / 16; ++k)
      wgmma_m64n256k16<1>(acc, desc_sw128(a + 32 * k, 16, 1024),
                          desc_sw128(bt + 2048 * k, SLAB, 1024), 1);
    wgmma_commit();
    fence_regs(acc);
    // the previous chunk's products are done: release its stage
    wgmma_wait<1>();
    if (kc > 0) mbar_arrive(&empty[(kc - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: both warpgroups are past their last products, so the ring
  // is free (every chunk issued has landed and been read). Warpgroup wg
  // writes its 64 x 256 tile in bf16 into 32 KB of it as four 64-column
  // slabs with the 128-byte swizzle (conflict-free: the 8 rows of a store
  // land in 8 different 16-byte chunks), then one thread stores the slabs
  // by TMA as 64 x 16 x 4 boxes of the output map; TMA drops the elements
  // past W and H.
  bar_sync(1, CONSUMERS * 128);
  unsigned char* st = smem + wg * (HID / 64) * 8192;
  const int w4 = warp & 3, q4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w4 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j = 0; j < HID / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          st + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
          4 * q4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  fence_proxy_async();
  bar_sync(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    const CUtensorMap* om = is_v ? &tm_gv : &tm_gk;
    for (int j = 0; j < HID / 64; ++j)
      tma_store_4d(om, st + j * 8192, 64 * j, x0, y0 + 4 * wg, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// tensor maps: a (B, H, W, ch) map as (ch, W, H, B) in 64 x 16 x box_h x 1
// boxes; a (rows, 256) weight matrix as (256, rows) in 64 x 64 boxes
int map_nhwc(CUtensorMap* m, const void* p, int B, int H, int W, int ch,
             int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ch * 2, (cuuint64_t)W * ch * 2,
                                 (cuuint64_t)H * W * ch * 2};
  const cuuint32_t box[4] = {KC, BW, (cuuint32_t)box_h, 1};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 4, dims, strides,
                     box);
}

int map_weights(CUtensorMap* m, const void* p, int rows) {
  const cuuint64_t dims[2] = {HID, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {HID * 2};
  const cuuint32_t box[2] = {64, KC};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, dims, strides,
                     box);
}

template <int C, int DC, int TAPS>
int launch(const void* feat, const void* csa, const void* wk, const void* wvu,
           const void* wvc, void* gk, void* gv, int B, int H, int W,
           void* stream) {
  static cudaError_t attr = allow_smem(f3p_kernel<C, DC, TAPS>, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tf, tc, tk, tv, tvc, tok, tov;
  int err = map_nhwc(&tf, feat, B, H, W, C, BH);
  if (!err) err = map_weights(&tk, wk, TAPS * C);
  if (!err) err = map_weights(&tv, wvu, TAPS * C);
  if (!err) err = map_nhwc(&tok, gk, B, H, W, HID, BH / CONSUMERS);
  if (!err) err = map_nhwc(&tov, gv, B, H, W, HID, BH / CONSUMERS);
  if (err) return err;
  if (DC > 0) {
    if ((err = map_nhwc(&tc, csa, B, H, W, DC, BH))) return err;
    if ((err = map_weights(&tvc, wvc, DC))) return err;
  } else {  // never read without CSA
    tc = tf;
    tvc = tk;
  }
  const dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH, 2 * B);
  f3p_kernel<C, DC, TAPS><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      tf, tc, tk, tv, tvc, tok, tov);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int f3p_build(const void* feat, const void* csa, const void* wk,
                         const void* wvu, const void* wvc, void* gk, void* gv,
                         int B, int H, int W, int C, int DC, int taps,
                         void* stream) {
  if (C == 64 && DC == 64 && taps == 9)
    return launch<64, 64, 9>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                             stream);
  if (C == 192 && DC == 0 && taps == 9)
    return launch<192, 0, 9>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                             stream);
  if (C == 192 && DC == 192 && taps == 9)
    return launch<192, 192, 9>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                               stream);
  if (C == 64 && DC == 64 && taps == 1)
    return launch<64, 64, 1>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                             stream);
  if (C == 192 && DC == 0 && taps == 1)
    return launch<192, 0, 1>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                             stream);
  if (C == 192 && DC == 192 && taps == 1)
    return launch<192, 192, 1>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                               stream);
  return (int)cudaErrorInvalidValue;
}
