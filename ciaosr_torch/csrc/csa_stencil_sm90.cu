// The middle of cross-scale attention (average=True) in the stencil form,
// on wgmma and TMA: the one kernel pair behind K4 csa_stencil_fused and
// row 6 csa_fused, and at config 001 swinir's widths (the wide instance,
// below) behind row 5 csa_stencil too.
//
// Replaces, in ciaosr_tpu/ops/pallas/csa_attention.py:
//   csa_stencil_fused (_csa_stencil_fused_kernel)
//   csa_fused (_csa_full_kernel, _csa_windowed_kernel)
//   csa_stencil (_csa_scores_kernel, _csa_stencil_pv_kernel), wide only
// All compute one function of the same inputs. With q_i the 3x3
// zero-padded match neighbourhood of query pixel i (9Cr = 288, tap-major),
// k_l the normalized 3x3 key patch l of the s-downsampled match map and
// P_l[(a,b), c] = embed[s*ly+a, s*lx+b, c] the s^2 phase planes at key l:
//   A   = softmax_l(scale * q_i . k_l)
//   M[i, l] = sum_{d in {-1,0,1}^2} A[i + d, l + d]   (d moves the query in
//             the Hp x Wp grid and the key in the Hq x Wq grid; off-grid
//             terms are zero)
//   out[s*iy + a, s*ix + b, c] = sum_l M[i, l] P_l[(a,b), c]
// (ciaosr_tpu/models/csa.py::_stencil_reconstruct). Inputs match
// (B, Hp, Wp, 32), keys (B, Hq*Wq, 288), embed (B, Hp, Wp, 64), bf16;
// output (B, 2Hp, 2Wp, 64) f32, before the down conv and the /6.
//
// Bound on the H100: operations, 2PL(9Cr + s^2 C) = 2PL * 544 FLOPs at
// the bf16 dense peak (0.37 ms at the 192 tile, P = 192^2, L = 96^2).
//
// Design. A (P, L) softmax needs each row's max and sum before any
// normalized A exists, and A itself (340 M values at the 192 tile) does
// not fit on chip, so there are two launches:
//   (a) stats_kernel: a CTA owns 128 queries (two consumer warpgroups of
//       64); their q rows are assembled once from the match map by
//       16-byte loads into the 128-byte swizzle (one tap is 64 bytes, half
//       a swizzle row). A producer warp streams the keys by TMA, 64 keys
//       (five 64-dim boxes, the last half zero-filled) a stage, through a
//       3-stage ring on mbarriers. Scores come from wgmma m64n64k16 over
//       the 288 dims; each thread keeps an online max and sum over its own
//       columns (no shuffles in the loop), merged across the quad at the
//       end. m is kept in log2 units.
//   (b) pv_kernel: a CTA owns an 8 x 8 query tile. Its 10 x 10 halo of q
//       rows is assembled once (as in (a), 104 rows), with m + log2 l of
//       each row. The CTA walks the 8 x 8 key tiles of the Hq x Wq grid.
//       Thread 0 keeps one copy in flight per buffer: the 10 x 10 key halo
//       (a 4-D TMA box of the keys viewed as (B, Hq, Wq, 288), 64 dims at
//       a time, zero fill off the grid) and the tile's phase planes (four
//       5-D boxes of the embed viewed as (B, Hq, 2, Wq, 128): 64 keys x 64
//       columns each, read MN-major). Per key tile j:
//         - p = exp2(scale s - m - log2 l) of the 100 x 100 halo block from
//           the halo scores in registers into f32 shared memory, zero on
//           off-grid rows and columns (a ballot bitmask per key tile);
//         - the next tile's halo scores, wgmma m64n104k16 (warpgroup 0
//           takes halo rows 0..63, warpgroup 1 rows 40..103, a
//           swizzle-atom boundary: 128 x 104 products for the 100 x 100
//           block), run on the tensor cores during
//         - the 9-point diagonal stencil in shared memory into M (64 x 64),
//           zero on off-grid keys, rounded once to bf16 into the swizzled
//           K-major A operand (lanes take (ix, ly): conflict-free loads,
//           with the key halo kept 11 columns a row and 116 a query row);
//         - M @ phases, wgmma m64n128k16: warpgroup w holds the 64 x 128
//           f32 accumulator of phase row a = w (64 registers a thread).
//       The key halo j + 2 is copied as soon as both warpgroups are past
//       the scores of j + 1, the phases j + 1 once both are past M @ P j.
//   The epilogue is the pixel shuffle: the 128 columns of phase row a of
//   query (iy, ix) are one contiguous 512-byte run of the output at
//   (s iy + a, s ix); each element is written once, by one thread, with no
//   atomics and no zeroed output, so the results are the same bits from
//   run to run.
// Tensor work: 2PL(288 + 3.25 * 288 + 256) = 2PL * 1480 (2.7x the bound):
// the stats pass once, the halo recompute at 128 x 104 / 64 x 64. What
// paces the PV kernel (tools/csa_stencil_probe.py) is the CUDA-core work
// between the products: the exp2 stage, then the stencil, with the scores
// only partly hidden behind the stencil.
//
// Shared memory (pv_kernel, one stage of each buffer):
//   q halo  5 chunks x 104 rows x 128 B   66,560
//   key halo                              66,560
//   phase tile 4 slabs x 64 rows x 128 B  32,768
//   M (64 x 64 bf16)                       8,192
//   p (100 rows x 116 f32)                46,400
//   row m + log2 l (104 f32)                 416
//   2 mbarriers + 1024 alignment           1,040   = 221,936 of 232,448.
// stats_kernel: q 81,920 + ring 3 x 40,960 + barriers = 205,872.
// Registers (ptxas): 229 for pv_kernel, 113 for stats_kernel, no spills.
//
// The wide instance (config 001 swinir's CSA: Cr = 90 and C = 180,
// zero-padded on the host to 96 and 192, so q and k are 864 wide and the
// phase planes 768): match (B, Hp, Wp, 96), keys (B, L, 864), embed
// (B, Hp, Wp, 192) -> out (B, 2Hp, 2Wp, 192) f32. K4, row 5 and row 6 all
// launch it at this width. Bound: 2PL(9Cr + s^2 C) at the real widths,
// 1.04 TFLOP at the 192 tile: 1.05 ms. The flagship pair's q and key
// halos (14 chunks x 104 rows x 128 B, 182 KB each) do not fit, so this
// instance is two kernels that keep the scores, not the halos, in device
// memory. That is row 5's own TPU design (normalized attention through
// memory, then the stencil product), with raw scores and the row's
// m and l in place of the normalized attention:
//   (a) scores_wide_kernel: a CTA owns 64 queries (q assembled once, 112
//       KB) and walks 256-key tiles: a producer warp streams the tile's 14
//       64-dim chunks (32 KB each) through a 3-stage ring, two consumer
//       warpgroups take 128 keys each (wgmma m64n128k16). Each tile's raw
//       f32 scores go to S (B, q1 - q0, ldS) in device memory (ldS = L
//       rounded up to a multiple of 4: 16-byte rows), and each thread
//       keeps an online max and sum of its columns, merged at the end
//       over the quad and the two warpgroups into m (log2 units) and l.
//   (b) pv_wide_kernel: a CTA owns an 8 x 8 query tile and walks the 8 x 8
//       key tiles. Per key tile its threads read the 100 x 100 halo block
//       of S and write p = exp2(scale S - m - log2 l) into f32 shared
//       memory (zero off either grid), run the 9-point stencil into M (64
//       x 64 bf16, as the flagship's), and three warpgroups multiply M by
//       256 columns each of the 768 phase columns (wgmma m64n256k16) from a
//       phase tile that thread 0 copies by TMA (twelve 5-D boxes, 96 KB),
//       the next tile's issued once both products are done.
// Row blocks. S holds 4PL bytes: 1.27 GiB at the 192 tile, 9.0 GiB for a
// 192 x 512 full image. So one launch of the pair computes the output
// rows y0 .. y1 - 1 only: (a) takes the query pixels q0 .. q1 - 1, which
// cover the attention rows y0 - 1 .. y1 (the stencil's halo, cut at the
// grid), and writes their scores from row 0 of a band-sized S; (b) takes
// the query tiles of rows y0 .. y1 - 1 and reads S at (pixel - q0), with
// the attention rows outside the band treated as off the grid. The host
// (ops/kernels/csa_stencil.py::wide_blocks) picks the blocks so that each
// S is at most 2 GiB, at multiples of 8 rows with q0 a multiple of 64: the
// CTAs of a block are those of one launch over the whole map, and the
// row max, sum and PV order are per query, so the blocked output has the
// same bits as one launch. The halo rows' scores are computed twice.
// Tensor work 2PL(864 + 768), the scores once (plus the halo rows);
// device memory adds S, 4PL bytes written and about 2.4 x that read (the
// halos). No atomics; each output element is written once: the same bits
// from run to run.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int CR = 32;              // match channels
constexpr int QK = 9 * CR;          // 288
constexpr int C = 64;               // embedding channels
constexpr int S = 2;                // CSA scale
constexpr int QCH = 5;              // 64-dim chunks of q and k
constexpr int QVEC = QCH * 8;       // 16-byte vectors of a swizzled row

// ---------------------------------------------------------------- pass (a)
constexpr int ST_Q = 128;                      // queries a CTA
constexpr int ST_K = 64;                       // keys a stage
constexpr int ST_STAGES = 3;
constexpr int ST_QCHUNK = ST_Q * 128;          // one 64-dim chunk of q
constexpr int ST_KCHUNK = ST_K * 128;
constexpr int ST_Q_BYTES = QCH * ST_QCHUNK;    // 80 KB
constexpr int ST_STAGE = QCH * ST_KCHUNK;      // 40 KB
constexpr int ST_CONSUMERS = 256;
constexpr int ST_THREADS = ST_CONSUMERS + 32;  // + the producer warp
constexpr int SMEM_ST =
    1024 + ST_Q_BYTES + ST_STAGES * ST_STAGE + 2 * ST_STAGES * 8;

// ---------------------------------------------------------------- pass (b)
constexpr int T = 8;                  // query / key tile side
constexpr int TH = T + 2;             // halo side
constexpr int NH = TH * TH;           // 100 halo rows
constexpr int NHR = 104;              // halo rows kept: 13 swizzle atoms
constexpr int WG1_ROW = 40;           // first halo row of warpgroup 1
constexpr int HCHUNK = NHR * 128;     // one 64-dim chunk of a halo
constexpr int H_BYTES = QCH * HCHUNK;
constexpr int K_TX = QCH * NH * 128;  // bytes of one key-halo copy
constexpr int SLAB = T * T * 128;     // 64 keys x 64 phase columns
constexpr int P_BYTES = 4 * SLAB;     // s^2 C = 256 columns
constexpr int M_BYTES = T * T * 128;
constexpr int KCOLS = TH + 1;         // p: key-halo row stride (f32)
constexpr int LDSA = 116;             // p: query row stride (f32)
constexpr int OFF_K = H_BYTES;
constexpr int OFF_P = OFF_K + H_BYTES;
constexpr int OFF_M = OFF_P + P_BYTES;
constexpr int OFF_S = OFF_M + M_BYTES;
constexpr int OFF_V = OFF_S + NH * LDSA * 4;
constexpr int OFF_BAR = OFF_V + NHR * 4;
constexpr int SMEM_PV = 1024 + OFF_BAR + 2 * 8;
constexpr int PV_THREADS = 256;
static_assert(OFF_K % 1024 == 0 && OFF_P % 1024 == 0 && OFF_M % 1024 == 0,
              "operand tiles start on swizzle atoms");
static_assert((WG1_ROW * 128) % 1024 == 0 && WG1_ROW + 64 >= NH &&
                  WG1_ROW + 64 <= NHR,
              "warpgroup 1's rows start on an atom and cover the halo");
static_assert(SMEM_PV <= 232448 && SMEM_ST <= 232448, "shared memory");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte vector v (0..39) of q for pixel (iy, ix) into row h of a K-major
// tile of 64-dim chunks (chunk stride cb bytes, 128-byte swizzle): dims
// 8v..8v+7 are channels 8(v%4).. of tap v/4 of the 3x3 neighbourhood;
// zero off the grid, for vectors 36..39 (the pad to 320) and unless ok
__device__ __forceinline__ void put_q(unsigned char* tile, int cb, int h,
                                      int v, const bf16* match, int b,
                                      int Hp, int Wp, int iy, int ix,
                                      bool ok) {
  uint4 val = zero8();
  const int t = v >> 2;
  const int yy = iy + t / 3 - 1, xx = ix + t % 3 - 1;
  if (ok && v < 36 && yy >= 0 && yy < Hp && xx >= 0 && xx < Wp)
    val = ld8(match + ((size_t)(b * Hp + yy) * Wp + xx) * CR + 8 * (v & 3));
  *reinterpret_cast<uint4*>(tile + (v >> 3) * cb + h * 128 +
                            (((v & 7) ^ (h & 7)) << 4)) = val;
}

// Per query: m (log2 units, scale included) and l = sum_l exp2(scale_log2
// q.k_l - m). m_out, l_out: (B, P) f32.
__global__ void __launch_bounds__(ST_THREADS, 1)
stats_kernel(const __grid_constant__ CUtensorMap tm_k,
             const bf16* __restrict__ match, float* __restrict__ m_out,
             float* __restrict__ l_out, int Hp, int Wp, int L,
             float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + ST_Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST_STAGES * ST_STAGE);
  uint64_t* empty = full + ST_STAGES;
  const int P = Hp * Wp, b = blockIdx.y, i0 = blockIdx.x * ST_Q;
  const int nt = (L + ST_K - 1) / ST_K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ST_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == ST_CONSUMERS / 32) {  // the producer warp: one thread issues
    if (lane == 0) {
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST_STAGES;
        if (j >= ST_STAGES) mbar_wait(&empty[s], (j / ST_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], ST_STAGE);
        for (int c = 0; c < QCH; ++c)
          tma_load_3d(ring + s * ST_STAGE + c * ST_KCHUNK, &tm_k, &full[s],
                      64 * c, j * ST_K, b);
      }
    }
    return;
  }

  for (int idx = threadIdx.x; idx < ST_Q * QVEC; idx += ST_CONSUMERS) {
    const int r = idx / QVEC, i = i0 + r;
    put_q(smem, ST_QCHUNK, r, idx % QVEC, match, b, Hp, Wp, i / Wp, i % Wp,
          i < P);
  }
  fence_proxy_async();
  bar_sync(1, ST_CONSUMERS);

  const int wg = warp >> 2, q4 = lane & 3;
  const unsigned char* qt = smem + wg * 64 * 128;
  float m_t[2] = {-INFINITY, -INFINITY}, l_t[2] = {0.f, 0.f};
  for (int j = 0; j < nt; ++j) {
    const int s = j % ST_STAGES;
    mbar_wait(&full[s], (j / ST_STAGES) & 1);
    const unsigned char* kt = ring + s * ST_STAGE;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int k = 0; k < QK / 16; ++k) {
      const int c = k / 4, o = 32 * (k % 4);
      wgmma_m64n64k16(sc, desc_sw128(qt + c * ST_QCHUNK + o, 16, 1024),
                      desc_sw128(kt + c * ST_KCHUNK + o, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&empty[s]);

    const int nvalid = L - j * ST_K;  // keys of this tile below L
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_t[h];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * jj + 2 * q4 + e < nvalid)
            mx = fmaxf(mx, sc[4 * jj + 2 * h + e] * scale_log2);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * jj + 2 * q4 + e < nvalid)
            sum += ex2(sc[4 * jj + 2 * h + e] * scale_log2 - mx);
      // a thread that has seen no key yet keeps m = -inf and l = 0
      l_t[h] = (m_t[h] == -INFINITY ? 0.f : l_t[h] * ex2(m_t[h] - mx)) + sum;
      m_t[h] = mx;
    }
  }

  // merge the quad's four column sets
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = fmaxf(m_t[h], __shfl_xor_sync(0xffffffffu, m_t[h], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = m_t[h] == -INFINITY ? 0.f : l_t[h] * ex2(m_t[h] - m);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int i = i0 + r0 + 8 * h;
    if (q4 == 0 && i < P) {
      m_out[(size_t)b * P + i] = m;
      l_out[(size_t)b * P + i] = l;
    }
  }
}

// the key halo of key tile (ky0, kx0): 10 x 10 keys from (ky0 - 1, kx0 - 1)
__device__ __forceinline__ void load_keys(unsigned char* kh,
                                          const CUtensorMap* tm,
                                          uint64_t* bar, int ky0, int kx0,
                                          int b) {
  mbar_expect_tx(bar, K_TX);
  for (int c = 0; c < QCH; ++c)
    tma_load_4d(kh + c * HCHUNK, tm, bar, 64 * c, kx0 - 1, ky0 - 1, b);
}

// the phase planes of key tile (ky0, kx0): slab 2a + b' holds, for the 64
// keys (ly, lx) of the tile, embed[s ly + a, s lx + b', 0..63]
__device__ __forceinline__ void load_phases(unsigned char* pt,
                                            const CUtensorMap* tm,
                                            uint64_t* bar, int ky0, int kx0,
                                            int b) {
  mbar_expect_tx(bar, P_BYTES);
  for (int n = 0; n < 4; ++n)
    tma_load_5d(pt + n * SLAB, tm, bar, 64 * (n & 1), kx0, n >> 1, ky0, b);
}

__global__ void __launch_bounds__(PV_THREADS, 1)
pv_kernel(const __grid_constant__ CUtensorMap tm_kh,
          const __grid_constant__ CUtensorMap tm_ph,
          const bf16* __restrict__ match, const float* __restrict__ m_in,
          const float* __restrict__ l_in, float* __restrict__ out, int Hp,
          int Wp, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qh = smem;
  unsigned char* kh = smem + OFF_K;
  unsigned char* pt = smem + OFF_P;
  unsigned char* mt = smem + OFF_M;
  float* sa = reinterpret_cast<float*>(smem + OFF_S);
  float* mrow = reinterpret_cast<float*>(smem + OFF_V);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* pbar = kbar + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, P = Hp * Wp;
  const int Hq = Hp / S, Wq = Wp / S;
  const int ntx = (Wp + T - 1) / T;
  const int ty0 = (blockIdx.x / ntx) * T, tx0 = (blockIdx.x % ntx) * T;
  const int nkx = (Wq + T - 1) / T, nt = nkx * ((Hq + T - 1) / T);

  if (tid == 0) {
    mbar_init(kbar, 1);
    mbar_init(pbar, 1);
    fence_barrier_init();
    load_keys(kh, &tm_kh, kbar, 0, 0, b);
    load_phases(pt, &tm_ph, pbar, 0, 0, b);
  }
  // the query halo (zero rows off the grid) and its m + log2 l (+inf off
  // the grid: p = 0 there)
  for (int idx = tid; idx < NHR * QVEC; idx += PV_THREADS) {
    const int h = idx / QVEC;
    const int iy = ty0 + h / TH - 1, ix = tx0 + h % TH - 1;
    put_q(qh, HCHUNK, h, idx % QVEC, match, b, Hp, Wp, iy, ix,
          h < NH && iy >= 0 && iy < Hp && ix >= 0 && ix < Wp);
  }
  for (int h = tid; h < NHR; h += PV_THREADS) {
    const int iy = ty0 + h / TH - 1, ix = tx0 + h % TH - 1;
    const bool ok = h < NH && iy >= 0 && iy < Hp && ix >= 0 && ix < Wp;
    const size_t gi = (size_t)b * P + (ok ? iy * Wp + ix : 0);
    mrow[h] = ok ? m_in[gi] + __log2f(l_in[gi]) : INFINITY;
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = warp >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0 and r0 + 8
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float sc[52];
#pragma unroll
  for (int i = 0; i < 52; ++i) sc[i] = 0.f;

  // halo scores of the key halo in kh into sc (overwritten): rows
  // 40 wg .. 40 wg + 63 x the 104 key-halo rows, issued (the caller waits)
  auto issue_scores = [&]() {
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int k = 0; k < QK / 16; ++k) {
      const int c = k / 4, o = 32 * (k % 4);
      wgmma_m64n104k16(
          sc, desc_sw128(qh + c * HCHUNK + wg * WG1_ROW * 128 + o, 16, 1024),
          desc_sw128(kh + c * HCHUNK + o, 16, 1024), k > 0);
    }
    wgmma_commit();
    fence_regs(sc);
  };
  mbar_wait(kbar, 0);
  issue_scores();
  wgmma_wait<0>();
  fence_regs(sc);
  bar_sync(1, PV_THREADS);  // both warpgroups are past key halo 0
  if (tid == 0 && nt > 1)
    load_keys(kh, &tm_kh, kbar, (1 / nkx) * T, (1 % nkx) * T, b);

  for (int j = 0; j < nt; ++j) {
    const int ky0 = (j / nkx) * T, kx0 = (j % nkx) * T;
    // normalized attention of the halo block from the scores in sc.
    // Key-halo column col = 10 cy + cx is kept at cy * KCOLS + cx =
    // col + cy; bit col % 32 of km[col / 32] says whether its key is on
    // the grid. Rows 40..63 are in both warpgroups: warpgroup 0 writes
    // 48..63 and warpgroup 1 40..47, so that each warp scheduler (warps w
    // and w + 4) writes at most 28 rows.
    uint32_t km[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int col = 32 * w + lane, cy = col / TH;
      const int ly = ky0 + cy - 1, lx = kx0 + col - TH * cy - 1;
      km[w] = __ballot_sync(0xffffffffu, col < NH && ly >= 0 && ly < Hq &&
                                             lx >= 0 && lx < Wq);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = WG1_ROW * wg + r0 + 8 * h;
      const bool mine =
          row < NH && (wg == 0 ? row < WG1_ROW || row >= WG1_ROW + 8
                               : row < WG1_ROW + 8 || row >= 64);
      if (mine) {
        const float mr = mrow[row];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 2 * q4 + e;  // the column within each group of 8
          float* dst = sa + row * LDSA + d;
#pragma unroll
          for (int jj = 0; jj < NHR / 8; ++jj) {
            // col = 8 jj + d; its cy is q0 or, past the next multiple of
            // 10, q0 + 1
            const int q0 = 8 * jj / TH, cross = TH * (q0 + 1) - 8 * jj;
            if (8 * jj + d < NH) {
              const float p = ex2(fmaf(sc[4 * jj + 2 * h + e], scale_log2,
                                       -mr));
              dst[8 * jj + q0 + (d >= cross)] =
                  (km[jj >> 2] >> (8 * (jj & 3) + d)) & 1u ? p : 0.f;
            }
          }
        }
      }
    }
    bar_sync(1, PV_THREADS);  // p is whole; sc is free

    // the next tile's scores run on the tensor cores during the stencil
    if (j + 1 < nt) {
      mbar_wait(kbar, (j + 1) & 1);
      issue_scores();
    }

    // M[i, l] = sum_d A[i + d, l + d]: a task is query i = (iy, ix) and key
    // row ly, eight keys lx; lanes take (ix, ly % 4), so the loads of a
    // warp hit 32 banks. M's row i is the A operand's row i, key ly*8 + lx.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int combo = warp + 8 * k;
      const int iy = combo & 7, ix = lane & 7;
      const int ly = (lane >> 3) + 4 * (combo >> 3), i = iy * T + ix;
      float mv[T];
#pragma unroll
      for (int lx = 0; lx < T; ++lx) mv[lx] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* src = sa + ((iy + dy) * TH + ix + dx) * LDSA +
                             (ly + dy) * KCOLS + dx;
#pragma unroll
          for (int lx = 0; lx < T; ++lx) mv[lx] += src[lx];
        }
      __align__(16) __nv_bfloat162 pk[T / 2];
      const bool row_ok = ky0 + ly < Hq;
#pragma unroll
      for (int lx = 0; lx < T; lx += 2)
        pk[lx / 2] = __floats2bfloat162_rn(
            row_ok && kx0 + lx < Wq ? mv[lx] : 0.f,
            row_ok && kx0 + lx + 1 < Wq ? mv[lx + 1] : 0.f);
      *reinterpret_cast<uint4*>(mt + i * 128 + ((ly ^ (i & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(pk);
    }
    wgmma_wait<0>();  // the next tile's scores
    fence_regs(sc);
    fence_proxy_async();
    bar_sync(1, PV_THREADS);  // M is whole; both are past p and the key halo
    if (tid == 0 && j + 2 < nt)
      load_keys(kh, &tm_kh, kbar, ((j + 2) / nkx) * T, ((j + 2) % nkx) * T,
                b);

    // acc (64 x 128) += M (64 x 64) @ phase row a = wg (64 x 128)
    mbar_wait(pbar, j & 1);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < T * T / 16; ++k)
      wgmma_m64n128k16<1>(acc, desc_sw128(mt + 32 * k, 16, 1024),
                          desc_sw128(pt + 2 * wg * SLAB + 2048 * k, SLAB,
                                     1024),
                          1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    bar_sync(1, PV_THREADS);  // both are past M and the phase tile
    if (tid == 0 && j + 1 < nt)
      load_phases(pt, &tm_ph, pbar, ((j + 1) / nkx) * T,
                  ((j + 1) % nkx) * T, b);
  }

  // pixel shuffle: columns (b', c) of phase row a = wg of query (iy, ix)
  // are out[s iy + a, s ix + b', c], 128 contiguous floats
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const int iy = ty0 + row / T, ix = tx0 + row % T;
    if (iy >= Hp || ix >= Wp) continue;
    float* dst = out + ((size_t)(b * S * Hp + S * iy + wg) * (S * Wp) +
                        S * ix) * C;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      *reinterpret_cast<float2*>(dst + 8 * jj + 2 * q4) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
  }
}

// ------------------------------------------------------ the wide instance
constexpr int WCR = 96;                 // match channels, padded
constexpr int WQK = 9 * WCR;            // 864
constexpr int WC = 192;                 // embedding channels, padded
constexpr int WQCH = (WQK + 63) / 64;   // 14 chunks of 64 dims
constexpr int WQVEC = WQCH * 8;         // 16-byte vectors of a q row
constexpr int WTAPV = WCR / 8;          // 16-byte vectors of a tap: 12

// ------------------------------------------------------------ pass (a)
constexpr int WS_Q = 64;                       // queries a CTA
constexpr int WS_K = 256;                      // keys a tile
constexpr int WS_STAGES = 3;
constexpr int WS_QCHUNK = WS_Q * 128;
constexpr int WS_STAGE = WS_K * 128;           // one 64-dim chunk: 32 KB
constexpr int WS_Q_BYTES = WQCH * WS_QCHUNK;   // 112 KB
constexpr int WS_OFF_X = WS_Q_BYTES + WS_STAGES * WS_STAGE;
constexpr int WS_OFF_BAR = WS_OFF_X + WS_Q * 2 * 4;
constexpr int WS_CONSUMERS = 256;
constexpr int WS_THREADS = WS_CONSUMERS + 32;  // + the producer warp
constexpr int SMEM_WS = 1024 + WS_OFF_BAR + 2 * WS_STAGES * 8;

// ------------------------------------------------------------ pass (b)
constexpr int WP_SLABS = S * S * WC / 64;      // 12 phase slabs of a tile
constexpr int WP_BYTES = WP_SLABS * SLAB;      // 96 KB
constexpr int WP_OFF_M = WP_BYTES;
constexpr int WP_OFF_S = WP_OFF_M + M_BYTES;
constexpr int WP_OFF_V = WP_OFF_S + NH * LDSA * 4;
constexpr int WP_OFF_BAR = WP_OFF_V + NHR * 4;
constexpr int SMEM_WP = 1024 + WP_OFF_BAR + 8;
constexpr int WP_WG = 3;                       // 256 output columns each
constexpr int WP_THREADS = WP_WG * 128;
static_assert(WS_Q_BYTES % 1024 == 0 && WS_STAGE % 1024 == 0 &&
                  WP_OFF_M % 1024 == 0,
              "operand tiles start on swizzle atoms");
static_assert(SMEM_WS <= 232448 && SMEM_WP <= 232448, "shared memory");
static_assert(WP_WG * 256 == S * S * WC, "the warpgroups cover s^2 C");

// as put_q, for the wide instance: vector v (0..111) holds channels
// 8 (v % 12).. of tap v / 12; zero for 108..111 (the pad to 896)
__device__ __forceinline__ void put_q_wide(unsigned char* tile, int cb,
                                           int h, int v, const bf16* match,
                                           int b, int Hp, int Wp, int iy,
                                           int ix, bool ok) {
  uint4 val = zero8();
  const int t = v / WTAPV;
  const int yy = iy + t / 3 - 1, xx = ix + t % 3 - 1;
  if (ok && v < 9 * WTAPV && yy >= 0 && yy < Hp && xx >= 0 && xx < Wp)
    val = ld8(match + ((size_t)(b * Hp + yy) * Wp + xx) * WCR +
              8 * (v % WTAPV));
  *reinterpret_cast<uint4*>(tile + (v >> 3) * cb + h * 128 +
                            (((v & 7) ^ (h & 7)) << 4)) = val;
}

// S's row stride: L rounded up to 16 bytes
__host__ __device__ __forceinline__ int s_stride(int L) {
  return (L + 3) & ~3;
}

// S[b, i, l] = q_i . k_l (raw, f32) for the CTA's 64 queries and every
// key; per query m (log2 units, scale included) and l = sum_l
// exp2(scale_log2 S - m)
__global__ void __launch_bounds__(WS_THREADS, 1)
scores_wide_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const bf16* __restrict__ match, float* __restrict__ s_out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int Hp, int Wp, int L, int q0, int q1, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + WS_Q_BYTES;
  float* xch = reinterpret_cast<float*>(smem + WS_OFF_X);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WS_OFF_BAR);
  uint64_t* empty = full + WS_STAGES;
  const int P = Hp * Wp, b = blockIdx.y, i0 = q0 + blockIdx.x * WS_Q;
  const int nt = (L + WS_K - 1) / WS_K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WS_CONSUMERS / 32);  // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WS_CONSUMERS / 32) {  // the producer warp: one thread issues
    if (lane == 0) {
      for (int it = 0; it < nt * WQCH; ++it) {
        const int s = it % WS_STAGES;
        if (it >= WS_STAGES) mbar_wait(&empty[s], (it / WS_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], WS_STAGE);
        tma_load_3d(ring + s * WS_STAGE, &tm_k, &full[s], 64 * (it % WQCH),
                    (it / WQCH) * WS_K, b);
      }
    }
    return;
  }

  for (int idx = threadIdx.x; idx < WS_Q * WQVEC; idx += WS_CONSUMERS) {
    const int r = idx / WQVEC, i = i0 + r;
    put_q_wide(smem, WS_QCHUNK, r, idx % WQVEC, match, b, Hp, Wp, i / Wp,
               i % Wp, i < q1);
  }
  fence_proxy_async();
  bar_sync(1, WS_CONSUMERS);

  const int wg = warp >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0 and r0 + 8
  float m_t[2] = {-INFINITY, -INFINITY}, l_t[2] = {0.f, 0.f};
  int it = 0;
  for (int j = 0; j < nt; ++j) {
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    for (int c = 0; c < WQCH; ++c) {
      const int s = it % WS_STAGES;
      mbar_wait(&full[s], (it / WS_STAGES) & 1);
      const unsigned char* kt = ring + s * WS_STAGE + wg * 128 * 128;
      wgmma_fence();
      fence_regs(sc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n128k16<0>(
            sc, desc_sw128(smem + c * WS_QCHUNK + 32 * k, 16, 1024),
            desc_sw128(kt + 32 * k, 16, 1024), 1);
      wgmma_commit();
      fence_regs(sc);
      wgmma_wait<1>();
      if (c > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % WS_STAGES]);
      ++it;
    }
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % WS_STAGES]);

    // this warpgroup's keys of the tile: l = 256 j + 128 wg + 8 jj + 2 q4 +
    // e. A pair starting below L is stored whole (its second key may be
    // L, a pad column of S's row); only keys below L enter the stats.
    const int lb = j * WS_K + 128 * wg + 2 * q4;
    const int lds = s_stride(L);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + r0 + 8 * h;
      float* srow = s_out + ((size_t)b * (q1 - q0) + (i < q1 ? i - q0 : 0)) *
                                lds;
      float mx = m_t[h];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int l = lb + 8 * jj;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (l + e < L) mx = fmaxf(mx, sc[4 * jj + 2 * h + e] * scale_log2);
        if (i < q1 && l < L)
          *reinterpret_cast<float2*>(srow + l) =
              make_float2(sc[4 * jj + 2 * h], sc[4 * jj + 2 * h + 1]);
      }
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (lb + 8 * jj + e < L)
            sum += ex2(sc[4 * jj + 2 * h + e] * scale_log2 - mx);
      // a thread that has seen no key yet keeps m = -inf and l = 0
      l_t[h] = (m_t[h] == -INFINITY ? 0.f : l_t[h] * ex2(m_t[h] - mx)) + sum;
      m_t[h] = mx;
    }
  }

  // merge the quad's four column sets, then the two warpgroups' keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = fmaxf(m_t[h], __shfl_xor_sync(0xffffffffu, m_t[h], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = m_t[h] == -INFINITY ? 0.f : l_t[h] * ex2(m_t[h] - m);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    m_t[h] = m;
    l_t[h] = l;
    if (wg == 1 && q4 == 0) {
      xch[2 * (r0 + 8 * h)] = m;
      xch[2 * (r0 + 8 * h) + 1] = l;
    }
  }
  bar_sync(1, WS_CONSUMERS);
  if (wg == 0 && q4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, i = i0 + r;
      const float m1 = xch[2 * r], l1 = xch[2 * r + 1];
      const float m = fmaxf(m_t[h], m1);
      const float l = (m_t[h] == -INFINITY ? 0.f : l_t[h] * ex2(m_t[h] - m)) +
                      (m1 == -INFINITY ? 0.f : l1 * ex2(m1 - m));
      if (i < q1) {
        m_out[(size_t)b * P + i] = m;
        l_out[(size_t)b * P + i] = l;
      }
    }
  }
}

// the phase planes of key tile (ky0, kx0): slab n holds, for the 64 keys
// (ly, lx) of the tile, embed[s ly + n / 6, s lx + (64 (n % 6)) / C, ...]:
// columns 64 (n % 6).. of phase row a = n / 6, (b', c) flattened
__device__ __forceinline__ void load_phases_wide(unsigned char* pt,
                                                 const CUtensorMap* tm,
                                                 uint64_t* bar, int ky0,
                                                 int kx0, int b) {
  mbar_expect_tx(bar, WP_BYTES);
  for (int n = 0; n < WP_SLABS; ++n)
    tma_load_5d(pt + n * SLAB, tm, bar, 64 * (n % 6), kx0, n / 6, ky0, b);
}

__global__ void __launch_bounds__(WP_THREADS, 1)
pv_wide_kernel(const __grid_constant__ CUtensorMap tm_ph,
               const float* __restrict__ s_in, const float* __restrict__ m_in,
               const float* __restrict__ l_in, float* __restrict__ out,
               int Hp, int Wp, int y0, int y1, int q0, int q1,
               float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* pt = smem;
  unsigned char* mt = smem + WP_OFF_M;
  float* sa = reinterpret_cast<float*>(smem + WP_OFF_S);
  float* mrow = reinterpret_cast<float*>(smem + WP_OFF_V);
  uint64_t* pbar = reinterpret_cast<uint64_t*>(smem + WP_OFF_BAR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, P = Hp * Wp;
  const int Hq = Hp / S, Wq = Wp / S, lds = s_stride(Hq * Wq);
  const int ntx = (Wp + T - 1) / T;
  const int ty0 = y0 + (blockIdx.x / ntx) * T, tx0 = (blockIdx.x % ntx) * T;
  const int nkx = (Wq + T - 1) / T, nt = nkx * ((Hq + T - 1) / T);
  // the attention rows of the band: output rows y0 .. y1 - 1 and their
  // stencil halo; a query row outside it counts as off the grid (it
  // reaches only output rows past y1, which this launch does not write)
  const int a0 = max(y0 - 1, 0), a1 = min(y1 + 1, Hp);

  if (tid == 0) {
    mbar_init(pbar, 1);
    fence_barrier_init();
    load_phases_wide(pt, &tm_ph, pbar, 0, 0, b);
  }
  // m + log2 l of the query halo's rows (+inf off the band)
  for (int h = tid; h < NHR; h += WP_THREADS) {
    const int iy = ty0 + h / TH - 1, ix = tx0 + h % TH - 1;
    const bool ok = h < NH && iy >= a0 && iy < a1 && ix >= 0 && ix < Wp;
    const size_t gi = (size_t)b * P + (ok ? iy * Wp + ix : 0);
    mrow[h] = ok ? m_in[gi] + __log2f(l_in[gi]) : INFINITY;
  }
  __syncthreads();

  const int wg = warp >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0 and r0 + 8
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int ky0 = (j / nkx) * T, kx0 = (j % nkx) * T;
    // p of the 100 x 100 halo block: element (query-halo row hq, key-halo
    // row cy, column cx), consecutive threads along cx; kept, as in
    // pv_kernel, at sa[hq * LDSA + cy * KCOLS + cx]
#pragma unroll 4
    for (int idx = tid; idx < NH * NH; idx += WP_THREADS) {
      const int hq = idx / NH, hk = idx % NH;
      const int cy = hk / TH, cx = hk % TH;
      const int iy = ty0 + hq / TH - 1, ix = tx0 + hq % TH - 1;
      const int ly = ky0 + cy - 1, lx = kx0 + cx - 1;
      float p = 0.f;
      if (iy >= a0 && iy < a1 && ix >= 0 && ix < Wp && ly >= 0 && ly < Hq &&
          lx >= 0 && lx < Wq)
        p = ex2(fmaf(s_in[((size_t)b * (q1 - q0) + iy * Wp + ix - q0) * lds +
                          ly * Wq + lx],
                     scale_log2, -mrow[hq]));
      sa[hq * LDSA + cy * KCOLS + cx] = p;
    }
    bar_sync(1, WP_THREADS);  // p is whole; every warp is past M of j - 1

    // M[i, l] = sum_d A[i + d, l + d], as pv_kernel: a task is query
    // (iy, ix) and key row ly, eight keys lx
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int combo = warp + (WP_THREADS / 32) * k;
      if (combo < 16) {
        const int iy = combo & 7, ix = lane & 7;
        const int ly = (lane >> 3) + 4 * (combo >> 3), i = iy * T + ix;
        float mv[T];
#pragma unroll
        for (int lx = 0; lx < T; ++lx) mv[lx] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* src = sa + ((iy + dy) * TH + ix + dx) * LDSA +
                               (ly + dy) * KCOLS + dx;
#pragma unroll
            for (int lx = 0; lx < T; ++lx) mv[lx] += src[lx];
          }
        __align__(16) __nv_bfloat162 pk[T / 2];
        const bool row_ok = ky0 + ly < Hq;
#pragma unroll
        for (int lx = 0; lx < T; lx += 2)
          pk[lx / 2] = __floats2bfloat162_rn(
              row_ok && kx0 + lx < Wq ? mv[lx] : 0.f,
              row_ok && kx0 + lx + 1 < Wq ? mv[lx + 1] : 0.f);
        *reinterpret_cast<uint4*>(mt + i * 128 + ((ly ^ (i & 7)) << 4)) =
            *reinterpret_cast<const uint4*>(pk);
      }
    }
    fence_proxy_async();
    bar_sync(1, WP_THREADS);  // M is whole; every warp is past p

    // acc (64 x 256) += M (64 x 64) @ phase columns 256 wg .. 256 wg + 255
    mbar_wait(pbar, j & 1);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < T * T / 16; ++k)
      wgmma_m64n256k16<1>(acc, desc_sw128(mt + 32 * k, 16, 1024),
                          desc_sw128(pt + 4 * wg * SLAB + 2048 * k, SLAB,
                                     1024),
                          1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    bar_sync(1, WP_THREADS);  // every warpgroup is past M and the phases
    if (tid == 0 && j + 1 < nt)
      load_phases_wide(pt, &tm_ph, pbar, ((j + 1) / nkx) * T,
                       ((j + 1) % nkx) * T, b);
  }

  // pixel shuffle: column u = 256 wg + 8 jj + 2 q4 (+1) is (b', c) =
  // u - 384 a of phase row a = u / 384, at out[s iy + a, s ix + b', c]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const int iy = ty0 + row / T, ix = tx0 + row % T;
    if (iy >= y1 || ix >= Wp) continue;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int u = 256 * wg + 8 * jj + 2 * q4, a = u / (S * WC);
      float* dst = out + ((size_t)(b * S * Hp + S * iy + a) * (S * Wp) +
                          S * ix) * WC + (u - S * WC * a);
      *reinterpret_cast<float2*>(dst) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
  }
}

// tensor maps (innermost dimension first, strides in bytes)
int map_keys_flat(CUtensorMap* m, const void* keys, int B, int L) {
  const cuuint64_t dims[3] = {QK, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {QK * 2, (cuuint64_t)L * QK * 2};
  const cuuint32_t box[3] = {64, ST_K, 1};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, keys, 3, dims,
                     strides, box);
}

int map_keys_grid(CUtensorMap* m, const void* keys, int B, int Hq, int Wq) {
  const cuuint64_t dims[4] = {QK, (cuuint64_t)Wq, (cuuint64_t)Hq,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {QK * 2, (cuuint64_t)Wq * QK * 2,
                                 (cuuint64_t)Hq * Wq * QK * 2};
  const cuuint32_t box[4] = {64, TH, TH, 1};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, keys, 4, dims,
                     strides, box);
}

// embed (B, Hp, Wp, C) as (B, Hq, a, Wq, (b', c)): (S C, Wq, S, Hq, B)
int map_phases(CUtensorMap* m, const void* embed, int B, int Hp, int Wp) {
  const cuuint64_t row = (cuuint64_t)Wp * C * 2;
  const cuuint64_t dims[5] = {S * C, (cuuint64_t)(Wp / S), S,
                              (cuuint64_t)(Hp / S), (cuuint64_t)B};
  const cuuint64_t strides[4] = {S * C * 2, row, S * row,
                                 (cuuint64_t)Hp * row};
  const cuuint32_t box[5] = {64, T, 1, T, 1};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, embed, 5, dims,
                     strides, box);
}

int map_keys_wide(CUtensorMap* m, const void* keys, int B, int L) {
  const cuuint64_t dims[3] = {WQK, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {WQK * 2, (cuuint64_t)L * WQK * 2};
  const cuuint32_t box[3] = {64, WS_K, 1};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, keys, 3, dims,
                     strides, box);
}

// embed (B, Hp, Wp, 192) as (B, Hq, a, Wq, (b', c)): (S C, Wq, S, Hq, B)
int map_phases_wide(CUtensorMap* m, const void* embed, int B, int Hp,
                    int Wp) {
  const cuuint64_t row = (cuuint64_t)Wp * WC * 2;
  const cuuint64_t dims[5] = {S * WC, (cuuint64_t)(Wp / S), S,
                              (cuuint64_t)(Hp / S), (cuuint64_t)B};
  const cuuint64_t strides[4] = {S * WC * 2, row, S * row,
                                 (cuuint64_t)Hp * row};
  const cuuint32_t box[5] = {64, T, 1, T, 1};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, embed, 5, dims,
                     strides, box);
}

}  // namespace

// K4 and row 6: match (B, Hp, Wp, 32), keys (B, Hp/2 * Wp/2, 288), embed
// (B, Hp, Wp, 64) bf16 -> out (B, 2Hp, 2Wp, 64) f32 (every element
// written); m_buf, l_buf: (B, Hp*Wp) f32 scratch
extern "C" int csa_stencil_sm90(const void* match, const void* keys,
                                const void* embed, void* m_buf, void* l_buf,
                                void* out, int B, int Hp, int Wp,
                                float scale, void* stream) {
  static cudaError_t attr_a = allow_smem(stats_kernel, SMEM_ST);
  static cudaError_t attr_b = allow_smem(pv_kernel, SMEM_PV);
  if (attr_a != cudaSuccess) return (int)attr_a;
  if (attr_b != cudaSuccess) return (int)attr_b;
  if (B <= 0 || Hp <= 0 || Wp <= 0 || Hp % S || Wp % S)
    return (int)cudaErrorInvalidValue;
  const int Hq = Hp / S, Wq = Wp / S, P = Hp * Wp, L = Hq * Wq;
  CUtensorMap tk, tkh, tph;
  int err = map_keys_flat(&tk, keys, B, L);
  if (!err) err = map_keys_grid(&tkh, keys, B, Hq, Wq);
  if (!err) err = map_phases(&tph, embed, B, Hp, Wp);
  if (err) return err;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  stats_kernel<<<dim3((P + ST_Q - 1) / ST_Q, B), ST_THREADS, SMEM_ST, st>>>(
      tk, (const bf16*)match, (float*)m_buf, (float*)l_buf, Hp, Wp, L,
      scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((Hp + T - 1) / T) * ((Wp + T - 1) / T);
  pv_kernel<<<dim3(tiles, B), PV_THREADS, SMEM_PV, st>>>(
      tkh, tph, (const bf16*)match, (const float*)m_buf,
      (const float*)l_buf, (float*)out, Hp, Wp, scale_log2);
  return (int)cudaGetLastError();
}

// K4, row 5 and row 6 at the wide instance, one block of output rows:
// match (B, Hp, Wp, 96), keys (B, Hp/2 * Wp/2, 864), embed (B, Hp, Wp,
// 192) bf16 -> rows y0 .. y1 - 1 of out (B, 2Hp, 2Wp, 192) f32 (every
// element of those rows written). Scratch: s_buf (B, q1 - q0, ldS) f32,
// the raw scores of query pixels q0 .. q1 - 1, which must hold the band
// of attention rows max(y0 - 1, 0) .. min(y1 + 1, Hp) - 1; m_buf, l_buf
// (B, Hp*Wp) f32. ldS = L = Hp/2 * Wp/2 rounded up to a multiple of 4.
extern "C" int csa_stencil_sm90_wide(const void* match, const void* keys,
                                     const void* embed, void* s_buf,
                                     void* m_buf, void* l_buf, void* out,
                                     int B, int Hp, int Wp, int y0, int y1,
                                     int q0, int q1, float scale,
                                     void* stream) {
  static cudaError_t attr_a = allow_smem(scores_wide_kernel, SMEM_WS);
  static cudaError_t attr_b = allow_smem(pv_wide_kernel, SMEM_WP);
  if (attr_a != cudaSuccess) return (int)attr_a;
  if (attr_b != cudaSuccess) return (int)attr_b;
  if (B <= 0 || Hp <= 0 || Wp <= 0 || Hp % S || Wp % S)
    return (int)cudaErrorInvalidValue;
  const int Hq = Hp / S, Wq = Wp / S, P = Hp * Wp, L = Hq * Wq;
  if (y0 < 0 || y1 <= y0 || y1 > Hp || q0 < 0 ||
      q0 > (y0 > 0 ? y0 - 1 : 0) * Wp || q1 < (y1 < Hp ? y1 + 1 : Hp) * Wp ||
      q1 > P)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tph;
  int err = map_keys_wide(&tk, keys, B, L);
  if (!err) err = map_phases_wide(&tph, embed, B, Hp, Wp);
  if (err) return err;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  scores_wide_kernel<<<dim3((q1 - q0 + WS_Q - 1) / WS_Q, B), WS_THREADS,
                       SMEM_WS, st>>>(tk, (const bf16*)match, (float*)s_buf,
                                      (float*)m_buf, (float*)l_buf, Hp, Wp,
                                      L, q0, q1, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((y1 - y0 + T - 1) / T) * ((Wp + T - 1) / T);
  pv_wide_kernel<<<dim3(tiles, B), WP_THREADS, SMEM_WP, st>>>(
      tph, (const float*)s_buf, (const float*)m_buf, (const float*)l_buf,
      (float*)out, Hp, Wp, y0, y1, q0, q1, scale_log2);
  return (int)cudaGetLastError();
}
