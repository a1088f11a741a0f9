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
// CSA map's 64-channel chunks are three and TMA rows 384 bytes).
//
// One tap (feat_unfold=False: the from_feature=False mode of the TPU
// kernel with u_map = feature) has a kernel of its own, f3p_u1_kernel, at
// the same three (C, DC). u is the feature itself, so K1 is one GEMM of
// M = B*H*W pixel rows, K = C (g_k) or C + DC (g_v) and N = 2 x 256, and
// device-memory bytes bound it: the outputs are 57-80% of them, and the
// products take a quarter (C = 64) to a half (C = 192) of the bytes' time.
// The nine-tap design ran it as 1-6 K chunks a block behind barrier set-up
// and ahead of an epilogue that ended the block (one block an SM), so
// loads, products and stores ran in series. Here a persistent block an SM
// walks a contiguous run of items, an item being 128 rows of the flat
// (M, ch) maps and one output (g_k, then g_v of the same rows: the second
// read of the feature chunks comes from L2). Two producer threads stream
// the run's chunks without stopping between items: the A tiles (feature or
// CSA, from device memory) through an 8-deep ring (4 at (192, 192)), the B
// tiles (weights, from L2) through a 3-deep one; a shared 2-deep ring of
// both had measured 7-17% slower than 3-deep, so the depth of the
// device-memory reads is what the kernel was short of. The epilogue stores
// from the registers (a quad transpose gives
// each lane 16 contiguous bytes of a row), so no shared memory goes to a
// staging tile and the stores do not queue behind the loads in the TMA
// unit. Pixel rows past M load as zeros and are not stored.
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

template <int C, int DC>
__global__ void __launch_bounds__(THREADS, 1)
f3p_kernel(const __grid_constant__ CUtensorMap tm_feat,
           const __grid_constant__ CUtensorMap tm_csa,
           const __grid_constant__ CUtensorMap tm_wk,
           const __grid_constant__ CUtensorMap tm_wvu,
           const __grid_constant__ CUtensorMap tm_wvc,
           const __grid_constant__ CUtensorMap tm_gk,
           const __grid_constant__ CUtensorMap tm_gv) {
  constexpr int CS = C / KC;    // channel slices a tap
  constexpr int NKU = 9 * CS;   // K chunks of the unfold (of u)
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
          // the tap's shifted box
          const int t = kc / CS, cs = kc % CS;
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

// ------------------------------------------------------------ one tap --
// Two rings: A tiles (128 pixel rows x 64 channels, 16 KB) come from device
// memory, eight deep (four at (192, 192), where 4-5 measured fastest and 8
// 8% slower, against 8 best at the other two); B tiles (64 rows x 256
// columns of a weight matrix, 32 KB) from L2, three deep. No staging
// buffer: the outputs leave from the registers.
constexpr int U1_ASTAGES = 8, U1_ASTAGES_CSA = 4, U1_BSTAGES = 3;
constexpr int U1_THREADS = CONSUMERS * 128 + 64;  // + an A and a B producer

template <int DC>
struct U1Smem {
  static constexpr int ASTAGES = DC == 192 ? U1_ASTAGES_CSA : U1_ASTAGES;
  static constexpr int B_OFF = ASTAGES * A_BYTES;
  static constexpr int BAR_OFF = B_OFF + U1_BSTAGES * B_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * (ASTAGES + U1_BSTAGES) * 8;
};

// The 4 x 4 transpose of 32-bit words inside a quad of lanes (q = lane % 4):
// on entry v[d] is this lane's word for lane d, on exit v[s] is lane s's
// word for this lane. Two butterfly rounds of two shuffles each.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool o1 = q & 1, o2 = q & 2;
  // round 1, partner q ^ 1: keep the words for lanes of this lane's parity
  const uint32_t x0 = __shfl_xor_sync(0xffffffffu, o1 ? v[0] : v[1], 1);
  const uint32_t x1 = __shfl_xor_sync(0xffffffffu, o1 ? v[2] : v[3], 1);
  const uint32_t a0 = o1 ? v[1] : v[0], a1 = o1 ? v[3] : v[2];
  // now a0, a1: own words for lanes q & 1 and 2 + (q & 1); x0, x1: the
  // partner's. Round 2, partner q ^ 2: keep the pair for this lane
  const uint32_t y0 = __shfl_xor_sync(0xffffffffu, o2 ? a0 : a1, 2);
  const uint32_t y1 = __shfl_xor_sync(0xffffffffu, o2 ? x0 : x1, 2);
  // the words from lanes q, q ^ 1, q ^ 2, q ^ 3, put at their sources
  const uint32_t w0 = o2 ? a1 : a0, w1 = o2 ? x1 : x0;
  v[0] = o1 ? (o2 ? y1 : w1) : (o2 ? y0 : w0);
  v[1] = o1 ? (o2 ? y0 : w0) : (o2 ? y1 : w1);
  v[2] = o1 ? (o2 ? w1 : y1) : (o2 ? w0 : y0);
  v[3] = o1 ? (o2 ? w0 : y0) : (o2 ? w1 : y1);
}

// Items [i0, i1) of a block: item i is pixel rows 128 (i / 2) .. + 127 and
// output i % 2 (0: g_k from C / 64 chunks of the feature and W_k0; 1: g_v,
// the same chunks with W_vu, then DC / 64 of the CSA map with W_vc).
template <int C, int DC>
__global__ void __launch_bounds__(U1_THREADS, 1)
f3p_u1_kernel(const __grid_constant__ CUtensorMap tm_feat,
              const __grid_constant__ CUtensorMap tm_csa,
              const __grid_constant__ CUtensorMap tm_wk,
              const __grid_constant__ CUtensorMap tm_wvu,
              const __grid_constant__ CUtensorMap tm_wvc, bf16* __restrict__ gk,
              bf16* __restrict__ gv, int M, long long items) {
  constexpr int CS = C / KC;
  constexpr int AST = U1Smem<DC>::ASTAGES, B_OFF = U1Smem<DC>::B_OFF;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* fulla = reinterpret_cast<uint64_t*>(smem + U1Smem<DC>::BAR_OFF);
  uint64_t* emptya = fulla + AST;
  uint64_t* fullb = emptya + AST;
  uint64_t* emptyb = fullb + U1_BSTAGES;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < AST; ++s) {
      mbar_init(&fulla[s], 1);
      mbar_init(&emptya[s], CONSUMERS * 128);
    }
    for (int s = 0; s < U1_BSTAGES; ++s) {
      mbar_init(&fullb[s], 1);
      mbar_init(&emptyb[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // two producer warps, one thread each
    if (lane == 0) {
      const bool is_a = warp == CONSUMERS * 4;
      int g = 0;  // chunks of the block so far: the rings' position
      for (long long it = i0; it < i1; ++it) {
        const int row0 = (int)(it >> 1) * BM;
        const bool is_v = it & 1;
        const int nk = is_v ? CS + DC / KC : CS;
        for (int kc = 0; kc < nk; ++kc, ++g) {
          const bool feat = kc < CS;
          const int c0 = (feat ? kc : kc - CS) * KC;
          if (is_a) {
            const int s = g % AST;
            if (g >= AST)
              mbar_wait(&emptya[s], (g / AST - 1) & 1);
            mbar_expect_tx(&fulla[s], A_BYTES);
            tma_load_2d(smem + s * A_BYTES, feat ? &tm_feat : &tm_csa,
                        &fulla[s], c0, row0);
          } else {
            const int s = g % U1_BSTAGES;
            if (g >= U1_BSTAGES)
              mbar_wait(&emptyb[s], (g / U1_BSTAGES - 1) & 1);
            const CUtensorMap* wmap =
                !feat ? &tm_wvc : (is_v ? &tm_wvu : &tm_wk);
            unsigned char* bt = smem + B_OFF + s * B_BYTES;
            mbar_expect_tx(&fullb[s], B_BYTES);
            for (int j = 0; j < HID / 64; ++j)
              tma_load_2d(bt + j * SLAB, wmap, &fullb[s], j * 64, c0);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each item
  const int wg = warp >> 2, w4 = warp & 3, q4 = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int g = 0;
  for (long long it = i0; it < i1; ++it) {
    const int row0 = (int)(it >> 1) * BM;
    const bool is_v = it & 1;
    const int nk = is_v ? CS + DC / KC : CS;
    for (int kc = 0; kc < nk; ++kc, ++g) {
      const int sa = g % AST, sb = g % U1_BSTAGES;
      mbar_wait(&fulla[sa], (g / AST) & 1);
      mbar_wait(&fullb[sb], (g / U1_BSTAGES) & 1);
      const unsigned char* a = smem + sa * A_BYTES + wg * (64 * 128);
      const unsigned char* bt = smem + B_OFF + sb * B_BYTES;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)  // the item's first step overwrites
        wgmma_m64n256k16<1>(acc, desc_sw128(a + 32 * k, 16, 1024),
                            desc_sw128(bt + 2048 * k, SLAB, 1024),
                            kc > 0 || k > 0);
      wgmma_commit();
      fence_regs(acc);
      // the previous chunk's products are done: release its stages
      wgmma_wait<1>();
      if (kc > 0) {
        mbar_arrive(&emptya[(g - 1) % AST]);
        mbar_arrive(&emptyb[(g - 1) % U1_BSTAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&emptya[(g - 1) % AST]);
    mbar_arrive(&emptyb[(g - 1) % U1_BSTAGES]);

    // epilogue, from the registers: the lane holds columns 8j + 2 q4, + 1
    // of rows r and r + 8; a quad transpose over j = 4t .. 4t + 3 gives it
    // the 8 columns of j = 4t + q4 whole, so that each row's 512 bytes
    // leave as 16-byte stores, 64 contiguous bytes a quad
    bf16* out = is_v ? gv : gk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 64 * wg + 16 * w4 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int t = 0; t < HID / 32; ++t) {
        uint32_t v[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              acc[4 * (4 * t + d) + 2 * h], acc[4 * (4 * t + d) + 2 * h + 1]);
          v[d] = *reinterpret_cast<const uint32_t*>(&p);
        }
        quad_transpose(v, q4);
        if (r < M)
          *reinterpret_cast<uint4*>(out + (long long)r * HID +
                                    8 * (4 * t + q4)) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// tensor maps: a (B, H, W, ch) map as (ch, W, H, B) in 64 x 16 x box_h x 1
// boxes; a (rows, 256) weight matrix as (256, rows) in 64 x 64 boxes; a map
// as flat pixel rows, (M, ch) as (ch, M) in 64 x 128 boxes
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

int map_rows(CUtensorMap* m, const void* p, long long M, int ch) {
  const cuuint64_t dims[2] = {(cuuint64_t)ch, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ch * 2};
  const cuuint32_t box[2] = {KC, BM};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, dims, strides,
                     box);
}

template <int C, int DC>
int launch(const void* feat, const void* csa, const void* wk, const void* wvu,
           const void* wvc, void* gk, void* gv, int B, int H, int W,
           void* stream) {
  static cudaError_t attr = allow_smem(f3p_kernel<C, DC>, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tf, tc, tk, tv, tvc, tok, tov;
  int err = map_nhwc(&tf, feat, B, H, W, C, BH);
  if (!err) err = map_weights(&tk, wk, 9 * C);
  if (!err) err = map_weights(&tv, wvu, 9 * C);
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
  f3p_kernel<C, DC><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      tf, tc, tk, tv, tvc, tok, tov);
  return (int)cudaGetLastError();
}

template <int C, int DC>
int launch_u1(const void* feat, const void* csa, const void* wk,
              const void* wvu, const void* wvc, void* gk, void* gv, int B,
              int H, int W, void* stream) {
  static cudaError_t attr = allow_smem(f3p_u1_kernel<C, DC>, U1Smem<DC>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const long long M = (long long)B * H * W;
  if (M < 1 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  CUtensorMap tf, tc, tk, tv, tvc;
  int err = map_rows(&tf, feat, M, C);
  if (!err) err = map_weights(&tk, wk, C);
  if (!err) err = map_weights(&tv, wvu, C);
  if (err) return err;
  if (DC > 0) {
    if ((err = map_rows(&tc, csa, M, DC))) return err;
    if ((err = map_weights(&tvc, wvc, DC))) return err;
  } else {  // never read without CSA
    tc = tf;
    tvc = tk;
  }
  const long long items = 2 * ((M + BM - 1) / BM);
  const long long grid = items < sms ? items : sms;
  f3p_u1_kernel<C, DC><<<(unsigned)grid, U1_THREADS, U1Smem<DC>::BYTES,
                         (cudaStream_t)stream>>>(
      tf, tc, tk, tv, tvc, (bf16*)gk, (bf16*)gv, (int)M, items);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int f3p_build(const void* feat, const void* csa, const void* wk,
                         const void* wvu, const void* wvc, void* gk, void* gv,
                         int B, int H, int W, int C, int DC, int taps,
                         void* stream) {
  if (taps == 9) {
    if (C == 64 && DC == 64)
      return launch<64, 64>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W, stream);
    if (C == 192 && DC == 0)
      return launch<192, 0>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W, stream);
    if (C == 192 && DC == 192)
      return launch<192, 192>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                              stream);
  } else if (taps == 1) {
    if (C == 64 && DC == 64)
      return launch_u1<64, 64>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                               stream);
    if (C == 192 && DC == 0)
      return launch_u1<192, 0>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                               stream);
    if (C == 192 && DC == 192)
      return launch_u1<192, 192>(feat, csa, wk, wvu, wvc, gk, gv, B, H, W,
                                 stream);
  }
  return (int)cudaErrorInvalidValue;
}
