// K2 wt_hoist on Hopper: the hoisted output layer of imnet_k, for the nine
// edge-clamped shifts, with wgmma and TMA.
//
// Replaces ciaosr_tpu/ops/pallas/decoder_kernel.py::_wt_hoist_planes
// (kernel _wt_kernel). For each LR pixel p and each d in {-1,0,1}^2:
//   qk_d  = u[p] (.) u[clamp(p + d)]            (bf16 product, DK wide)
//   wt_d  = qk_d @ W_kout                       (DK -> 256, bf16 out)
//   ck_d  = qk_d . b_kout                       (one f32 per (d, p))
// u is the 3x3 zero-padded unfold of the raw feature, tap-major (DK = 9C);
// the shift clamps at the image edge AFTER the unfold (u is not the unfold
// of a clamped map). Without the unfold (feat_unfold=False, TAPS = 1) u is
// the feature itself, DK = C. The decode kernel then computes each logit
// as wt_d . h_k + ck_d and skips the 256 -> DK product. Outputs: wt
// (9, B, H, W, 256) bf16 and ck (9, B, H, W) f32, plane d = 3(dy+1)+dx+1.
//
// Bound on the H100: 2*9*M*DK*257 = 98.2 GFLOP at M = 192*192, C = 64: 99
// us at the bf16 dense peak; the 170 MB of bf16 wt written (+1.3 MB ck,
// 4.7 MB feature read) take 52 us, so it is compute-bound. SwinIR-CiaoSR
// (C = 180 padded to 192 with zero weight rows) on a 256 x 256 map: 491
// GFLOP of the function's, 0.50 ms; on config 001 swinir's 192 x 192 tile
// 0.28 ms. At one tap (M = 192*192, C = 64) 10.9 GFLOP, where the wt
// stores set the bound (52 us).
//
// Design. The product is K1's (f3p_build.cu): 128 pixels (a 16 x 8 patch)
// a CTA, two consumer warpgroups with 64 x 256 f32 accumulators, the
// weights read MN-major from the (DK, 256) row-major matrix as 64-row K
// chunks of four 64-column TMA boxes (32 KB) through a 3-stage mbarrier
// ring, so each weight byte read from L2 serves 128 pixels. One thread of
// a producer warpgroup issues every copy; setmaxnreg moves the rest of its
// registers to the consumers (232 each; at 9 warps without it ptxas caps
// a thread at 168 and the consumers spilled). A work item is one patch and
// one shift; the grid is one CTA a multiprocessor, each walking a
// contiguous run of items (patch-major, the nine shifts of a patch
// adjacent), so that partial waves cost at most one item. TMA cannot
// multiply, so the consumers form the A operand in registers and multiply
// it by the register-A form of wgmma (m64n256k16, A as four bf16x2
// registers a thread): the feature's halo window (the patch grown by 2
// pixels each side, 20 x 12 pixels of one 64-channel slab, 30 KB) is one
// 4-D TMA box, whose zero fill out of bounds is the unfold's zero padding;
// for a K chunk (tap t, slab cs) each thread loads its q and k fragments
// from the window by ldmatrix (the 128-byte swizzle keeps the eight rows
// of a matrix on distinct banks) and multiplies them in bf16x2. The edge
// clamp is index arithmetic on the window. The next chunk's fragments are
// formed while the current chunk's products run (named fragment sets, the
// taps unrolled). K chunks run slab-major (cs outer, tap inner: W_kout's
// rows are t*C + c, so a chunk is still 64 contiguous rows); the window
// slabs go through a ring of their own (2 buffers), refilled per item and
// slab. ck is a fifth product of the same fragments: m64n8k16 against
// b_kout, held in shared memory in bf16, of whose 8 columns the first is
// ck (b_kout is rounded to bf16 as the JAX package rounds it; the packed
// b_kout is bf16 already). Summing qk . b_kout on the CUDA cores instead
// cost a fifth of the kernel. Epilogue: each warpgroup writes its 64 x 256
// tile in bf16 into its own 32 KB staging buffer (four swizzled 64-column
// slabs) and one thread stores it by TMA as 64 x 16 x 4 boxes of the
// (256, W, H, 9B) output map (edges clipped by TMA), while the next
// item's products run; the buffer is rewritten only after the store has
// read it. Each output element is written once in a fixed order: the
// results are the same bits from launch to launch.
// Shared memory: ring 3 x 32 KB + window 2 x 30 KB + staging 2 x 32 KB +
// barriers + b_kout (3.5 KB) = 230,016 bytes with the 1 KB alignment pad
// (<= 227 KB), the same at every instance (at C = 192 the window is one
// slab of three at a time).
// Compiled for C = 64 (the flagship) and C = 192 with the unfold, and for
// C = 64 and C = 192 without it (one tap: a K chunk a slab).
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int HID = 256;                    // output columns
constexpr int BW = 16, BH = 8;              // pixel patch of a work item
constexpr int KC = 64;                      // K chunk: one swizzle row
constexpr int WIN_W = BW + 4, WIN_H = BH + 4;
constexpr int WIN_BYTES = WIN_W * WIN_H * 128;  // 30 KB, 30 swizzle atoms
constexpr int SLAB = KC * 128;              // 64 weight rows x 64 columns
constexpr int B_BYTES = (HID / 64) * SLAB;  // 32 KB
constexpr int STAGES = 3;
constexpr int WBUFS = 2;
constexpr int OUT_BYTES = 64 * HID * 2;     // a warpgroup's bf16 tile
constexpr int CONSUMERS = 2;                // warpgroups of 64 rows
// a whole producer warpgroup: setmaxnreg moves registers only between the
// warpgroups of one CTA (at 9 warps and no setmaxnreg ptxas caps every
// thread at 168 and the consumers spill)
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int RING_OFF = 0;
constexpr int WIN_OFF = STAGES * B_BYTES;
constexpr int OUT_OFF = WIN_OFF + WBUFS * WIN_BYTES;
constexpr int BAR_OFF = OUT_OFF + CONSUMERS * OUT_BYTES;
// b_kout in bf16, padded by one chunk (ck's B tiles read 64 past a start)
constexpr int BIAS_OFF = BAR_OFF + 128;
constexpr int DK_MAX = 9 * 192;
constexpr int SMEM = 1024 + BIAS_OFF + (DK_MAX + KC) * 2;
static_assert(WIN_BYTES % 1024 == 0 && OUT_OFF % 1024 == 0, "atoms");
static_assert(SMEM <= 232448, "shared memory per block");

struct Geo {
  int H, W, B, npx, npy;  // patches across and down
  long long items;        // B * npy * npx * 9
};

// the ldmatrix x4 of a 16 x 16 bf16 tile: lane l gives the address of
// row (l & 7) + 8 ((l >> 3) & 1), 16-byte column half l >> 4; register i
// is the wgmma A fragment's a[i] (rows l/4 (+8 for odd i), columns
// 2(l%4) (+8 for i >= 2))
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 z = __hmul2(x, y);  // one rounding of the exact product
  return *reinterpret_cast<uint32_t*>(&z);
}

// A work item (patch, shift) as a consumer thread sees it: the patch's
// origin, the shift d and the window pixel of the thread's k row (the
// clamped shifted pixel; a pixel past the image edge takes the last one's,
// so that every window index stays inside the window)
struct Item {
  int b, y0, x0, d, rk;
};

__device__ __forceinline__ Item item_at(long long it, const Geo& g, int r,
                                        int xm) {
  Item m;
  const long long patch = it / 9;
  m.d = (int)(it % 9);
  m.x0 = (int)(patch % g.npx) * BW;
  m.y0 = (int)((patch / g.npx) % g.npy) * BH;
  m.b = (int)(patch / ((long long)g.npx * g.npy));
  const int yc = min(m.y0 + r, g.H - 1), xc = min(m.x0 + xm, g.W - 1);
  const int ys = clampi(yc + m.d / 3 - 1, 0, g.H - 1);
  const int xs = clampi(xc + m.d % 3 - 1, 0, g.W - 1);
  m.rk = (ys - m.y0 + 2) * WIN_W + (xs - m.x0 + 2);
  return m;
}

// The A fragments of one K chunk (64 channels of tap t) from the window
// at `win` (shared address; pq, pk: the q and k rows' window pixels at
// the tap).
__device__ __forceinline__ void form(uint32_t (&a)[4][4], uint32_t win,
                                     int pq, int pk, int hi) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t q[4], k[4];
    const int ch = 2 * kk + hi;
    ldsm_x4(q, win + pq * 128 + ((ch ^ (pq & 7)) << 4));
    ldsm_x4(k, win + pk * 128 + ((ch ^ (pk & 7)) << 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = bmul2(q[i], k[i]);
  }
}

// Tap t of slab cs of an item whose first window slab is ws, into
// fragment set f: wait for the slab's window at its first tap, release it
// after its last.
template <int C, int TAPS>
__device__ __forceinline__ void form_at(uint32_t (&f)[4][4],
                                        unsigned char* smem, int ws, int t,
                                        int cs, int rq, int rk, int hi) {
  uint64_t* wfull = reinterpret_cast<uint64_t*>(smem + BAR_OFF) +
                    2 * STAGES;
  uint64_t* wempty = wfull + WBUFS;
  const int wb = (ws + cs) % WBUFS;
  if (t == 0) mbar_wait(&wfull[wb], ((ws + cs) / WBUFS) & 1);
  const int toff = TAPS == 9 ? (t / 3 - 1) * WIN_W + (t % 3 - 1) : 0;
  form(f, smem_u32(smem + WIN_OFF + wb * WIN_BYTES), rq + toff, rk + toff,
       hi);
  if (t == TAPS - 1) mbar_arrive(&wempty[wb]);
}

// The consumer warpgroups: warpgroup wg takes patch rows 4 wg .. 4 wg + 3,
// warp w4 of it patch row r = 4 wg + w4 (its 16 accumulator rows are that
// row's 16 pixels). The taps of a slab are unrolled and their A fragments
// rotate through named sets, so that chunk j + 1's fragments are formed
// while chunk j's products run, also across a slab boundary (three sets:
// with nine taps the next slab's first chunk takes set 0 again). The slab
// loop is not unrolled: 27 unrolled chunks at C = 192 spilled. At one tap
// a chunk is a slab, the fragments one set, and chunk j + 1's are formed
// only once chunk j's products are done; and both consumer warpgroups
// start each item together (an item of three chunks is the weight ring's
// depth, so one could otherwise run a whole item ahead of the other). At
// C = 192, on CTAs that walk several items: with three rotating sets and
// neither rule some wt rows were wrong; with the first rule alone a few
// pixels in the first rows of a patch's first item (wt and ck) still
// changed from launch to launch. The cause is not found; ptxas reported
// no spill, and the nine-tap instances keep their bits.
template <int C, int TAPS>
__device__ __forceinline__ void consume(unsigned char* smem,
                                        const CUtensorMap* tm_out,
                                        const float* __restrict__ bk,
                                        float* __restrict__ ck, const Geo& g,
                                        long long i0, long long i1) {
  constexpr int CS = C / KC, NCH = TAPS * CS;  // slabs, chunks an item
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, q4 = lane & 3;
  const int r = 4 * wg + w4;
  // this lane's ldmatrix row: pixel xm of row r, column half hi; rq is
  // its q row's window pixel at the centre tap
  const int xm = (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4;
  const int rq = (2 + r) * WIN_W + 2 + xm;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* st = smem + OUT_OFF + wg * OUT_BYTES;
  // b_kout in bf16 (as the JAX package rounds it, decoder_kernel.py:360;
  // pack_decoder's is bf16 already): ck is a fifth product, m64n8k16 with
  // B = 8 x 16-byte rows of this array, whose first row is b's 8 values
  // of the k step and whose other rows feed discarded columns
  __nv_bfloat16* b16 = reinterpret_cast<__nv_bfloat16*>(smem + BIAS_OFF);
  for (int i = threadIdx.x; i < TAPS * C + KC; i += CONSUMERS * 128)
    b16[i] = __float2bfloat16_rn(i < TAPS * C ? bk[i] : 0.f);
  fence_proxy_async();
  bar_sync(1, CONSUMERS * 128);
  float acc[128], cka[4];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) cka[i] = 0.f;
  // fragment sets: three where a slab's last tap forms the next slab's
  // first, two for one slab of nine taps, one for one tap
  constexpr int NSET = TAPS == 1 ? 1 : CS > 1 ? 3 : 2;
  uint32_t a[NSET][4][4];
  int kc = 0, ws = 0;  // chunks and window slabs before this item
  for (long long it = i0; it < i1; ++it, kc += NCH, ws += CS) {
    const Item m = item_at(it, g, r, xm);
    if constexpr (TAPS == 1) bar_sync(1, CONSUMERS * 128);
    form_at<C, TAPS>(a[0], smem, ws, 0, 0, rq, m.rk, hi);
#pragma unroll 1
    for (int cs = 0; cs < CS; ++cs) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {  // chunk j = cs TAPS + t
        const int j = cs * TAPS + t;
        const int s = (kc + j) % STAGES;
        mbar_wait(&full[s], ((kc + j) / STAGES) & 1);
        const unsigned char* bt = smem + RING_OFF + s * B_BYTES;
        const bool first = j == 0;
        const __nv_bfloat16* bc = b16 + t * C + cs * KC;
        wgmma_fence();
        fence_regs(acc);
        fence_regs(cka);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n256k16_rs<1>(acc, a[t % NSET][kk],
                                 desc_sw128(bt + 2048 * kk, SLAB, 1024),
                                 first && kk == 0 ? 0 : 1);
          wgmma_m64n8k16_rs(cka, a[t % NSET][kk],
                            desc_plain(bc + 16 * kk, 16, 16),
                            first && kk == 0 ? 0 : 1);
        }
        wgmma_commit();
        fence_regs(acc);
        fence_regs(cka);
        // chunk j - 1's products are done: release its stage (at one tap
        // chunk j's are done too before the next fragments are formed)
        if constexpr (TAPS == 1)
          wgmma_wait<0>();
        else
          wgmma_wait<1>();
        if (j > 0) mbar_arrive(&empty[(kc + j - 1) % STAGES]);
        if (t + 1 < TAPS)
          form_at<C, TAPS>(a[(t + 1) % NSET], smem, ws, t + 1, cs, rq,
                           m.rk, hi);
        else if (cs + 1 < CS)
          form_at<C, TAPS>(a[0], smem, ws, 0, cs + 1, rq, m.rk, hi);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(cka);
    mbar_arrive(&empty[(kc + NCH - 1) % STAGES]);

    // ck: column 0 of the fifth product, rows lane/4 and lane/4 + 8
    const int y = m.y0 + r, xa = m.x0 + (lane >> 2);
    if (q4 == 0 && y < g.H) {
      float* row = ck + (((long long)m.d * g.B + m.b) * g.H + y) * g.W;
      if (xa < g.W) row[xa] = cka[0];
      if (xa + 8 < g.W) row[xa + 8] = cka[2];
    }
    // wt: the staging buffer is free once the previous item's store has
    // read it; the tile goes in as four swizzled 64-column slabs
    if (leader) bulk_wait_read();
    bar_sync(2 + wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * w4 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < HID / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            st + (j >> 3) * 8192 + rr * 128 + (((j & 7) ^ (rr & 7)) << 4) +
            4 * q4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (leader) {
      for (int j = 0; j < HID / 64; ++j)
        tma_store_4d(tm_out, st + j * 8192, 64 * j, m.x0, m.y0 + 4 * wg,
                     m.d * g.B + m.b);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_read();
}

template <int C, int TAPS>
__global__ void __launch_bounds__(THREADS, 1)
wt_sm90(const __grid_constant__ CUtensorMap tm_feat,
        const __grid_constant__ CUtensorMap tm_w,
        const __grid_constant__ CUtensorMap tm_out,
        const float* __restrict__ bk, float* __restrict__ ck, Geo g) {
  constexpr int CS = C / KC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;
  uint64_t* wempty = wfull + WBUFS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i0 = g.items * blockIdx.x / gridDim.x;
  const long long i1 = g.items * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    for (int s = 0; s < WBUFS; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // one if-else: the producer warpgroup gives registers to the consumers,
  // and one of its threads issues every copy
  if (warp >= CONSUMERS * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (warp == CONSUMERS * 4 && lane == 0) {
      int kc = 0, ws = 0;
      for (long long it = i0; it < i1; ++it) {
        const long long patch = it / 9;
        const int px = (int)(patch % g.npx);
        const int py = (int)((patch / g.npx) % g.npy);
        const int b = (int)(patch / ((long long)g.npx * g.npy));
        for (int cs = 0; cs < CS; ++cs, ++ws) {
          const int wb = ws % WBUFS;
          if (ws >= WBUFS) mbar_wait(&wempty[wb], (ws / WBUFS - 1) & 1);
          mbar_expect_tx(&wfull[wb], WIN_BYTES);
          tma_load_4d(smem + WIN_OFF + wb * WIN_BYTES, &tm_feat, &wfull[wb],
                      cs * KC, px * BW - 2, py * BH - 2, b);
          for (int t = 0; t < TAPS; ++t, ++kc) {
            const int s = kc % STAGES;
            if (kc >= STAGES) mbar_wait(&empty[s], (kc / STAGES - 1) & 1);
            unsigned char* bt = smem + RING_OFF + s * B_BYTES;
            mbar_expect_tx(&full[s], B_BYTES);
            for (int j = 0; j < HID / 64; ++j)
              tma_load_2d(bt + j * SLAB, &tm_w, &full[s], j * 64,
                          t * C + cs * KC);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    consume<C, TAPS>(smem, &tm_out, bk, ck, g, i0, i1);
  }
}

// tensor maps: a (N, H, W, ch) map as (ch, W, H, N) in 64 x box_w x box_h
// x 1 boxes; a (rows, 256) weight matrix as (256, rows) in 64 x 64 boxes
int map_nhwc(CUtensorMap* m, const void* p, int N, int H, int W, int ch,
             int box_w, int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)ch * 2, (cuuint64_t)W * ch * 2,
                                 (cuuint64_t)H * W * ch * 2};
  const cuuint32_t box[4] = {KC, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
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

template <int C, int TAPS>
int launch(const void* feat, const void* wkt, const void* bk, void* wt,
           void* ck, int B, int H, int W, void* stream) {
  static cudaError_t attr = allow_smem(wt_sm90<C, TAPS>, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (B < 1 || H < 1 || W < 1 || 9LL * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  CUtensorMap tf, tw, to;
  int err = map_nhwc(&tf, feat, B, H, W, C, WIN_W, WIN_H);
  if (!err) err = map_weights(&tw, wkt, TAPS * C);
  if (!err) err = map_nhwc(&to, wt, 9 * B, H, W, HID, BW, BH / CONSUMERS);
  if (err) return err;
  Geo g;
  g.H = H;
  g.W = W;
  g.B = B;
  g.npx = (W + BW - 1) / BW;
  g.npy = (H + BH - 1) / BH;
  g.items = 9LL * B * g.npx * g.npy;
  const long long grid = g.items < sms ? g.items : sms;
  wt_sm90<C, TAPS><<<(unsigned)grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      tf, tw, to, (const float*)bk, (float*)ck, g);
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
  if (C == 192 && taps == 1)
    return launch<192, 1>(feat, wkt, bk, wt, ck, B, H, W, stream);
  return (int)cudaErrorInvalidValue;
}
