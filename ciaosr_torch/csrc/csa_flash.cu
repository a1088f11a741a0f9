// Row 7 of the kernel table, csa_attention: softmax(scale q k^T) v over
// explicit banks, one flash-attention launch on wgmma and TMA.
//
// Replaces ciaosr_tpu/ops/pallas/csa_attention.py::csa_attention
// (_attn_kernel): q (B, P, 288), k (B, L, 288), v (B, L, 2304) bf16 ->
// out (B, P, 2304) f32, any P and L. (Row 8 computes the same attention
// inside the overlap-add epilogue, on the two-pass kernel of
// csa_attention.cu; row 6 computes its function in the stencil form, with
// K4, in csa_stencil_sm90.cu.)
//
// Bound on the H100: 2PL(288 + 2304) FLOPs, 34.8 GFLOP at 72 x 72 (P =
// 5184, L = 1296): 35 us at the bf16 dense peak; the 47.8 MB f32 output
// takes 14 us.
//
// Design. A 64-row f32 accumulator 2304 wide (590 KB) fits no SM, and the
// old kernel recomputed the scores for each of the nine 256-column tap
// planes after a separate stats pass. Here one block owns 64 queries and
// a third of the columns (768: three tap planes) of one batch, so 243
// blocks at 72 x 72 in a single launch. Its three warpgroups each hold one
// plane's 64 x 256 f32 accumulator in registers (3/4 of the register file
// between them). Thread 0 issues the TMA copies: the query tile once
// (five 64-dim boxes; the last half zero-filled), then per 48-key tile
// the keys (five boxes) into one buffer and the values (twelve 64-column
// boxes) into a 2-stage ring, each completing on an mbarrier; it issues
// tile j + 1 as soon as every warpgroup is past tile j's scores, so the
// copies overlap tile j's softmax and products.
// Each 64 x 48 score tile is computed once a block: warpgroup w computes
// the 64 x 16 slice of keys 16w.. (wgmma m64n16k16 over the 288 dims),
// the three trade row maxima through shared memory and apply an online
// softmax (one running max, a running sum per slice, added at the end),
// write p in bf16 into a shared 64 x 48 tile, rescale their accumulators
// and multiply p by their plane of the value tile (wgmma m64n256k16, V
// read MN-major as it lies in the bank). Tensor work: 2PL(3 * 288 + 2304)
// = 2PL * 3168 against the two-pass kernel's 2PL * 5184. The epilogue
// stages the f32 tile in shared memory and stores it by TMA.
// Rows past P and keys past L arrive as TMA's zeros; keys past L are
// masked to p = 0.
//
// The wide instance (flash_wide_kernel): q (B, P, 864), k (B, L, 864), v
// (B, L, 6912), the banks of config 001 swinir's CSA (Cr = 90 and C = 180
// zero-padded to 96 and 192 on the host: zero dims change no score, zero
// value columns are cropped). Bound: 2PL(9Cr + 36C) at the real widths,
// 98 GFLOP at 72 x 72 (P = 5184, L = 1296): 0.099 ms. The flagship layout
// would need 340 KB of shared memory (q 112 KB, a whole key tile 84 KB, two
// value stages 144 KB). Here the query tile stays resident (14 chunks x 64
// rows x 128 B = 112 KB), the key tile streams through a 4-stage ring of
// 64-dim chunks (48 keys x 128 B = 6 KB each) and the value tile has one
// stage (72 KB); a block still owns 768 columns, so 9 column blocks each
// recompute the scores. Thread 0 issues the copies, as in the flagship
// kernel: after each chunk it waits until every warp has released the
// chunk before and refills that stage four chunks ahead, and at a tile's
// first chunk it waits until every warp is past the last tile's products
// and copies the tile's values, which arrive under the tile's scores. (A
// producer warpgroup with setmaxnreg does not compile here: at 512
// threads ptxas caps the kernel at 128 registers, and m64n256k16 needs
// 154.) Layout (bytes): q 114,688 | key ring 24,576 | values 73,728 | p
// 8,192 | row max / sum 768 | 11 mbarriers; 223,064 with the 1024
// alignment, of 232,448.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int QK = 288, DV = 2304;
constexpr int TQ = 64;                   // queries a block
constexpr int TKEY = 48;                 // keys a tile
constexpr int NWG = 3;                   // warpgroups: one tap plane each
constexpr int SLICE = TKEY / NWG;        // 16 keys of scores a warpgroup
constexpr int PLANE = 256;
constexpr int DVB = NWG * PLANE;         // 768 columns a block
constexpr int QCH = (QK + 63) / 64;      // 5 chunks of 64 dims
constexpr int VSLAB = TKEY * 128;        // 64 columns x 48 keys
constexpr int VSLABS = DVB / 64;         // 12
constexpr int VSTAGES = 2;
constexpr int Q_BYTES = QCH * TQ * 128;    // 40 KB
constexpr int K_BYTES = QCH * TKEY * 128;  // 30 KB
constexpr int V_BYTES = VSLABS * VSLAB;    // 72 KB
constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + K_BYTES;
constexpr int OFF_P = OFF_V + VSTAGES * V_BYTES;  // p: 64 rows x 128 B
constexpr int OFF_X = OFF_P + TQ * 128;           // row max / sum exchange
constexpr int OFF_BAR = OFF_X + NWG * TQ * 4;
constexpr int SMEM = 1024 + OFF_BAR + (2 + VSTAGES) * 8;
constexpr int THREADS = NWG * 128;
constexpr int OSLAB = TQ * 128;          // 32 f32 output columns x 64 rows
static_assert(NWG * (PLANE / 32) * OSLAB <= OFF_P,
              "the epilogue tiles overlay the q, k and v buffers");

// key tile j and its values into the key buffer and value stage j % 2
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        unsigned char* smem, uint64_t* kfull,
                                        uint64_t* vfull, int j, int c0,
                                        int b) {
  const int l0 = j * TKEY, s = j % VSTAGES;
  mbar_expect_tx(kfull, K_BYTES);
  for (int c = 0; c < QCH; ++c)
    tma_load_3d(smem + OFF_K + c * TKEY * 128, tm_k, kfull, 64 * c, l0, b);
  unsigned char* vt = smem + OFF_V + s * V_BYTES;
  mbar_expect_tx(&vfull[s], V_BYTES);
  for (int i = 0; i < VSLABS; ++i)
    tma_load_3d(vt + i * VSLAB, tm_v, &vfull[s], c0 + 64 * i, l0, b);
}

// The steps both kernels share, on this thread's fragment of the 64 x 16
// score slice (sc), the running max and sum of its rows r0 and r0 + 8
// (m_run, l_run) and its fragment of the 64 x 256 plane (acc).

// scaled scores (log2 units) of key tile l0, keys past L masked; the
// slice's row maxima into xch
__device__ __forceinline__ void slice_max(float (&sc)[8], int l0, int L,
                                          float scale_log2, int wg, int q4,
                                          int r0, float* xch) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = l0 + SLICE * wg + 8 * (i >> 2) + 2 * q4 + (i & 1);
    sc[i] = key < L ? sc[i] * scale_log2 : -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    if (q4 == 0) xch[wg * TQ + r0 + 8 * h] = mx[h];
  }
}

// once every slice's maxima are in xch: the online softmax step, p in
// bf16 into the shared tile (row r, key column 16 wg + 8 jj + 2 q4 (+1),
// K-major with the 128-byte swizzle), acc rescaled
__device__ __forceinline__ void softmax_step(const float (&sc)[8],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&acc)[128],
                                             const float* xch,
                                             unsigned char* pt, int wg,
                                             int q4, int r0) {
  float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float mn = fmaxf(
        m_run[h], fmaxf(xch[r], fmaxf(xch[TQ + r], xch[2 * TQ + r])));
    alpha[h] = exp2f(m_run[h] - mn);  // 0 on the first tile
    m_run[h] = mn;
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float p0 = exp2f(sc[4 * jj + 2 * h] - m_run[h]);
      const float p1 = exp2f(sc[4 * jj + 2 * h + 1] - m_run[h]);
      lsum[h] += p0 + p1;
      *reinterpret_cast<__nv_bfloat162*>(
          pt + r * 128 + (((2 * wg + jj) ^ (r & 7)) << 4) + 4 * q4) =
          __floats2bfloat162_rn(p0, p1);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + lsum[h];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// acc (64 x 256) += p (64 x 48) @ V (48 x this plane's 256 columns, vt)
__device__ __forceinline__ void pv_product(float (&acc)[128],
                                           const unsigned char* pt,
                                           const unsigned char* vt) {
  wgmma_fence();
  fence_regs(acc);
#pragma unroll
  for (int k = 0; k < TKEY / 16; ++k)
    wgmma_m64n256k16<1>(acc, desc_sw128(pt + 32 * k, 16, 1024),
                        desc_sw128(vt + 2048 * k, VSLAB, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// after the last tile: the row sums (the quad's, then the three slices'),
// then the epilogue. The query, key and value buffers are free: warpgroup
// wg writes its normalised 64 x 256 f32 tile into 64 KB of them as eight
// 32-column slabs with the 128-byte swizzle, then one thread stores the
// slabs by TMA as 32 x 64 boxes of the output; TMA drops rows past P.
__device__ __forceinline__ void store_out(const float (&acc)[128],
                                          float (&l_run)[2], float* xch,
                                          unsigned char* smem,
                                          const CUtensorMap* tm_out, int i0,
                                          int c0, int b, int wg, int q4,
                                          int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    if (q4 == 0) xch[wg * TQ + r0 + 8 * h] = l_run[h];
  }
  bar_sync(1, THREADS);  // also: every warpgroup is past its last products

  unsigned char* st = smem + wg * (PLANE / 32) * OSLAB;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float inv = 1.f / (xch[r] + xch[TQ + r] + xch[2 * TQ + r]);
#pragma unroll
    for (int jj = 0; jj < PLANE / 8; ++jj)
      *reinterpret_cast<float2*>(
          st + (jj >> 2) * OSLAB + r * 128 +
          (((2 * (jj & 3) + (q4 >> 1)) ^ (r & 7)) << 4) + 8 * (q4 & 1)) =
          make_float2(acc[4 * jj + 2 * h] * inv,
                      acc[4 * jj + 2 * h + 1] * inv);
  }
  fence_proxy_async();
  bar_sync(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    for (int j = 0; j < PLANE / 32; ++j)
      tma_store_3d(tm_out, st + j * OSLAB, c0 + wg * PLANE + 32 * j, i0, b);
    bulk_commit();
    bulk_wait_read();
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_out, int L,
             float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* kt = smem + OFF_K;
  unsigned char* pt = smem + OFF_P;
  float* xch = reinterpret_cast<float*>(smem + OFF_X);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = qbar + 2;
  const int i0 = blockIdx.x * TQ, c0 = blockIdx.y * DVB, b = blockIdx.z;
  const int nt = (L + TKEY - 1) / TKEY;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0 and r0 + 8
  const bool issuer = threadIdx.x == 0;

  if (issuer) {
    mbar_init(qbar, 1);
    mbar_init(kfull, 1);
    for (int s = 0; s < VSTAGES; ++s) mbar_init(&vfull[s], 1);
    fence_barrier_init();
    mbar_expect_tx(qbar, Q_BYTES);
    for (int c = 0; c < QCH; ++c)
      tma_load_3d(smem + c * TQ * 128, &tm_q, qbar, 64 * c, i0, b);
    load_kv(&tm_k, &tm_v, smem, kfull, vfull, 0, c0, b);
  }
  __syncthreads();

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int j = 0; j < nt; ++j) {
    const int l0 = j * TKEY, s = j % VSTAGES;
    // scores of this warpgroup's 16 keys: 18 steps over the 288 dims
    mbar_wait(kfull, j & 1);
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = 0.f;
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int k = 0; k < QK / 16; ++k) {
      const int c = k / 4, o = 32 * (k % 4);
      wgmma_m64n16k16(
          sc, desc_sw128(smem + c * TQ * 128 + o, 16, 1024),
          desc_sw128(kt + c * TKEY * 128 + wg * SLICE * 128 + o, 16, 1024),
          1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    slice_max(sc, l0, L, scale_log2, wg, q4, r0, xch);
    bar_sync(1, THREADS);
    // every warpgroup is past its scores of tile j and its products of
    // tile j - 1: the key buffer and value stage (j + 1) % 2 are free
    if (issuer && j + 1 < nt)
      load_kv(&tm_k, &tm_v, smem, kfull, vfull, j + 1, c0, b);

    softmax_step(sc, m_run, l_run, acc, xch, pt, wg, q4, r0);
    fence_proxy_async();
    bar_sync(1, THREADS);  // the p tile is whole

    mbar_wait(&vfull[s], (j / VSTAGES) & 1);
    pv_product(acc, pt,
               smem + OFF_V + s * V_BYTES + wg * (PLANE / 64) * VSLAB);
  }

  store_out(acc, l_run, xch, smem, &tm_out, i0, c0, b, wg, q4, r0);
}

// ------------------------------------------------------ the wide instance
constexpr int WQK = 9 * 96, WDV = 36 * 192;
constexpr int WQCH = (WQK + 63) / 64;         // 14 chunks of 64 dims
constexpr int WKSTAGES = 4;
constexpr int WKCHUNK = TKEY * 128;           // 64 dims of 48 keys: 6 KB
constexpr int WQ_BYTES = WQCH * TQ * 128;     // 112 KB
constexpr int WOFF_K = WQ_BYTES;
constexpr int WOFF_V = WOFF_K + WKSTAGES * WKCHUNK;
constexpr int WOFF_P = WOFF_V + V_BYTES;
constexpr int WOFF_X = WOFF_P + TQ * 128;
constexpr int WOFF_BAR = WOFF_X + NWG * TQ * 4;
constexpr int WNBAR = 3 + 2 * WKSTAGES;       // q, value full / empty, ring
constexpr int WSMEM = 1024 + WOFF_BAR + WNBAR * 8;
static_assert(WOFF_K % 1024 == 0 && WOFF_V % 1024 == 0 &&
                  WOFF_P % 1024 == 0 && WKCHUNK % 1024 == 0,
              "operand tiles start on swizzle atoms");
static_assert(NWG * (PLANE / 32) * OSLAB <= WOFF_P,
              "the epilogue tiles overlay the q, k and v buffers");
static_assert(WSMEM <= 232448 && WDV % DVB == 0, "shared memory, blocks");

// key chunk g (tile g / WQCH, dims 64 (g % WQCH)..) into its ring stage
__device__ __forceinline__ void load_wide_chunk(const CUtensorMap* tm_k,
                                                unsigned char* ring,
                                                uint64_t* kfull, int g,
                                                int b) {
  const int s = g % WKSTAGES;
  mbar_expect_tx(&kfull[s], WKCHUNK);
  tma_load_3d(ring + s * WKCHUNK, tm_k, &kfull[s], 64 * (g % WQCH),
              (g / WQCH) * TKEY, b);
}

// the value tile of key tile j into the one value stage
__device__ __forceinline__ void load_wide_values(const CUtensorMap* tm_v,
                                                 unsigned char* vbuf,
                                                 uint64_t* vfull, int j,
                                                 int c0, int b) {
  mbar_expect_tx(vfull, V_BYTES);
  for (int i = 0; i < VSLABS; ++i)
    tma_load_3d(vbuf + i * VSLAB, tm_v, vfull, c0 + 64 * i, j * TKEY, b);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_out, int L,
                  float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + WOFF_K;
  unsigned char* vbuf = smem + WOFF_V;
  unsigned char* pt = smem + WOFF_P;
  float* xch = reinterpret_cast<float*>(smem + WOFF_X);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + WOFF_BAR);
  uint64_t* vfull = qbar + 1;
  uint64_t* vempty = qbar + 2;
  uint64_t* kfull = qbar + 3;
  uint64_t* kempty = kfull + WKSTAGES;
  const int i0 = blockIdx.x * TQ, c0 = blockIdx.y * DVB, b = blockIdx.z;
  const int nt = (L + TKEY - 1) / TKEY, nchunks = nt * WQCH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0 and r0 + 8
  const bool issuer = threadIdx.x == 0;

  if (issuer) {
    mbar_init(qbar, 1);
    mbar_init(vfull, 1);
    mbar_init(vempty, NWG * 4);  // one arrival a warp
    for (int s = 0; s < WKSTAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], NWG * 4);
    }
    fence_barrier_init();
    mbar_expect_tx(qbar, WQ_BYTES);
    for (int c = 0; c < WQCH; ++c)
      tma_load_3d(smem + c * TQ * 128, &tm_q, qbar, 64 * c, i0, b);
    for (int g = 0; g < WKSTAGES && g < nchunks; ++g)
      load_wide_chunk(&tm_k, ring, kfull, g, b);
    load_wide_values(&tm_v, vbuf, vfull, 0, c0, b);
  }
  __syncthreads();

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  int g = 0;  // key chunks consumed

  for (int j = 0; j < nt; ++j) {
    const int l0 = j * TKEY;
    // scores of this warpgroup's 16 keys, chunk by chunk through the ring.
    // A warp releases chunk g - 1 once its products of chunk g are issued;
    // the issuer then refills that stage with chunk g - 1 + WKSTAGES.
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = 0.f;
    for (int c = 0; c < WQCH; ++c, ++g) {
      const int s = g % WKSTAGES;
      mbar_wait(&kfull[s], (g / WKSTAGES) & 1);
      const unsigned char* kt = ring + s * WKCHUNK + wg * SLICE * 128;
      wgmma_fence();
      fence_regs(sc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n16k16(sc, desc_sw128(smem + c * TQ * 128 + 32 * k, 16, 1024),
                        desc_sw128(kt + 32 * k, 16, 1024), 1);
      wgmma_commit();
      fence_regs(sc);
      wgmma_wait<1>();
      if (g > 0) {
        const int sp = (g - 1) % WKSTAGES;
        if (lane == 0) mbar_arrive(&kempty[sp]);
        if (issuer && g - 1 + WKSTAGES < nchunks) {
          mbar_wait(&kempty[sp], ((g - 1) / WKSTAGES) & 1);
          load_wide_chunk(&tm_k, ring, kfull, g - 1 + WKSTAGES, b);
        }
      }
      // the values of tile j once every warp is past tile j - 1's products
      if (issuer && j > 0 && c == 0) {
        mbar_wait(vempty, (j - 1) & 1);
        load_wide_values(&tm_v, vbuf, vfull, j, c0, b);
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);

    slice_max(sc, l0, L, scale_log2, wg, q4, r0, xch);
    bar_sync(1, THREADS);  // every warpgroup is past tile j - 1's products

    softmax_step(sc, m_run, l_run, acc, xch, pt, wg, q4, r0);
    fence_proxy_async();
    bar_sync(1, THREADS);  // the p tile is whole

    mbar_wait(vfull, j & 1);
    pv_product(acc, pt, vbuf + wg * (PLANE / 64) * VSLAB);
    if (lane == 0) mbar_arrive(vempty);
  }

  store_out(acc, l_run, xch, smem, &tm_out, i0, c0, b, wg, q4, r0);
}

// a (B, rows, width) bank as (width, rows, B) in box_w x box_rows boxes
int map_bank(CUtensorMap* m, CUtensorMapDataType dtype, int esize,
             const void* p, int B, int rows, int width, int box_w,
             int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * esize,
                                 (cuuint64_t)rows * width * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)box_rows, 1};
  return tmap_encode(m, dtype, p, 3, dims, strides, box);
}

}  // namespace

// row 7: q (B, P, Dk), k (B, L, Dk), v (B, L, Dv) tap-major ->
// out (B, P, Dv) f32; (Dk, Dv) = (288, 2304), the flagship, or (864, 6912)
extern "C" int csa_attention(const void* q, const void* k, const void* v,
                             void* out, int B, int P, int L, int Dk, int Dv,
                             float scale, void* stream) {
  const bool wide = Dk == WQK && Dv == WDV;
  if (!wide && (Dk != QK || Dv != DV)) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = allow_smem(flash_kernel, SMEM);
  static cudaError_t attr_w = allow_smem(flash_wide_kernel, WSMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (attr_w != cudaSuccess) return (int)attr_w;
  if (P <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv, to;
  int err = map_bank(&tq, BF16, 2, q, B, P, Dk, 64, TQ);
  if (!err) err = map_bank(&tk, BF16, 2, k, B, L, Dk, 64, TKEY);
  if (!err) err = map_bank(&tv, BF16, 2, v, B, L, Dv, 64, TKEY);
  if (!err)
    err = map_bank(&to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, B, P, Dv, 32,
                   TQ);
  if (err) return err;
  const dim3 grid((P + TQ - 1) / TQ, Dv / DVB, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (wide)
    flash_wide_kernel<<<grid, THREADS, WSMEM, (cudaStream_t)stream>>>(
        tq, tk, tv, to, L, scale_log2);
  else
    flash_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        tq, tk, tv, to, L, scale_log2);
  return (int)cudaGetLastError();
}
