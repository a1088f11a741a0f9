// Row 11 swin_block on Hopper: one whole Swin transformer block with wgmma
// and TMA.
//
// Replaces ciaosr_tpu/ops/pallas/swin_block.py::_swin_block_call (kernel
// _block_kernel, the forward of swin_block_fused). On a token map x
// (B, H, W, C) f32 that is already rolled by the block's shift, for each
// ws x ws window (N = ws^2 <= 64 tokens):
//   xn = bf16(LN1(x)); q = xn@Wq*scale + bq*scale, k = xn@Wk + bk,
//   v = xn@Wv + bv (f32, then bf16)
//   per head h: P = softmax(q_h k_h^T + bias_h [+ shift mask]) (f32),
//               o_h = bf16(P) v_h (f32, then bf16)
//   x1 = x + o@Wp + bp;  y = x1 + bf16(GELU(bf16(LN2(x1))@W1 + b1))@W2 + b2
// with every matmul operand bf16 and every sum, softmax, LayerNorm and the
// exact-erf GELU in f32, as the TPU kernel casts; y is f32. LayerNorm
// averages over the C real channels only. The shift mask is recomputed from
// the window's position (three regions per axis); the roll stays outside.
//
// Layout (ops/kernels/swin_block.py::pack_swin_block): C <= 192 padded to
// CP = 192, the MLP hidden width to HIDP = 384, head h of q/k/v in the 32
// columns [32h, 32h + head_dim) of its part; padded weights are zero. The
// kernel reads wqkv_hm (wqkv transposed, head-major: rows 96h..96h+95 are
// head h's q, k and v slots, each a row of the 192 inputs), wp, w1 and w2
// as packed ((in, out) row-major).
//
// Bound on the H100 (SwinIR-CiaoSR, C = 180, 6 heads, hidden 360, one
// 256 x 256 map): 2*T*C*(3C + C + 2*360) + 4*T*64*C = 37.0 GFLOP at
// T = 65536, 37 us at the bf16 dense peak; x in and y out (f32, 94 MB)
// take 28 us. The padded products are 41.8 GFLOP.
//
// Design. A CTA takes two windows, one per consumer warpgroup (64 token
// rows: one m64 wgmma tile), and walks over window pairs (persistent: one
// CTA a multiprocessor; one CTA a pair was 6-8% slower on an H100,
// tools/swin_block_probe.py). One thread of a
// producer warpgroup streams every weight through a 4-stage ring of
// shared memory by TMA in the order the consumers use them, the same order
// for every pair: per head the three 64-deep K chunks of wqkv_hm's 96 rows
// (K-major B, 12 KB each) and wp's 32 rows of that head (MN-major,
// 12 KB); per 64-column chunk of the MLP hidden, W1's 192 x 64 columns
// and W2's 64 x 192 rows (24 KB each). Both warpgroups consume each stage
// (8 arrivals empty it), so each weight byte crosses from L2 once per two
// windows and no consumer thread spends a load on weights. The producer
// also asks L2 for the next pair's rows of x. setmaxnreg gives the
// consumers 232 registers and the producer 40 (ptxas allocates to them:
// no spills; at 168 it spills 2.2 KB).
// A consumer warpgroup:
//   x1 (64 x 192 f32, a wgmma accumulator: 96 registers a thread) = x,
//   read in the accumulator's layout; LN1 from those registers (quad
//   shuffles) into xn (bf16, 128-byte-swizzled K-major, 24 KB); x1 += bp.
//   Per head: [q_h | k_h | v_h] = xn @ wqkv_hm[96 rows of h]^T (m64n96,
//   A and B from shared memory); + biases (q scaled), bf16: q_h stays in
//   registers as the A operand, k_h goes to a K-major tile and v_h^T to
//   another (4 KB); S = q_h k_h^T (m64n64, A from registers); relative
//   bias, mask and softmax over the 64 keys in registers (quad shuffles);
//   o_h = bf16(P) v_h (m64n32, A from registers); x1 += bf16(o_h) @
//   wp[32h..32h+31, :] (m64n192, A from registers). Summing Wp's product
//   head by head only changes the f32 order of the sum.
//   LN2 of x1 in registers into xn; per hidden chunk z = yn @ W1[:, chunk]
//   (m64n64), + b1, GELU (erff), bf16 as A fragments, x1 += gelu @
//   W2[chunk, :] (m64n192): the accumulator becomes y. Epilogue: + b2,
//   y stored for the window's real tokens and the C real channels, each
//   element by one thread: the same bits on every run.
// The relative bias depends on the displacement of query and key only,
// so the CTA keeps it as (heads, (2 ws - 1)^2) in shared memory (5.4 KB
// at ws = 8, from any entry of the (heads, N, N) input with that
// displacement), with -inf for keys past N; each thread looks its score
// elements up through a byte-index table. The shift mask is a bit a score
// element, made once a window and applied only where it is non-zero (the
// shifted map's seams). The LayerNorm and bias vectors sit in shared
// memory too.
// Shared memory: two xn tiles (48 KB), k_h and v_h^T of two windows
// (24 KB), the ring (96 KB), the tables (19 KB): 188 KB, one CTA an SM.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int CP = 192;     // packed residual width
constexpr int HD = 32;      // head slot
constexpr int MAX_HEADS = CP / HD;
constexpr int HIDP = 384;   // packed MLP hidden width
constexpr int NT = 64;      // tokens a window, at most (one m64 tile)
constexpr int QKV_ROWS = 3 * HD;   // wqkv_hm rows a head
constexpr int HCH = 64;            // MLP hidden columns a chunk
// the relative-bias table's stride: (2 ws - 1)^2 <= 225 displacements,
// then -inf at BT_NONE for keys past n
constexpr int BTAB = 226, BT_NONE = 225;
constexpr int KC = 64;             // K chunk: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int SLAB = KC * 128;          // 64 rows x 64 bf16 columns: 8 KB
constexpr int WP_SLAB = HD * 128;       // 32 rows x 64 columns: 4 KB
constexpr int QKV_BOX = QKV_ROWS * 128;   // 96 rows x 64 K: 12 KB
constexpr int STAGE_BYTES = 3 * SLAB;   // the largest stage: a W2 chunk
constexpr int XN_BYTES = (CP / KC) * SLAB;   // a window's xn: 24 KB
constexpr int K_BYTES = NT * 128;            // k_h: 64 keys (64 B used)
constexpr int VT_BYTES = HD * 128;           // v_h^T: 32 dims x 64 keys
constexpr int CONSUMERS = 2;
// a whole producer warpgroup: each of the 4 schedulers' register files
// (16K) holds one warp of every warpgroup, so 2 consumer warps at 232
// registers and a producer warp at 40 fill one; setmaxnreg moves them
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int OFF_K = CONSUMERS * XN_BYTES;
constexpr int OFF_VT = OFF_K + CONSUMERS * K_BYTES;
constexpr int OFF_RING = OFF_VT + CONSUMERS * VT_BYTES;
constexpr int OFF_BAR = OFF_RING + STAGES * STAGE_BYTES;
constexpr int SMEM = 1024 + OFF_BAR + 2 * STAGES * 8;
constexpr float LN_EPS = 1e-5f;
// the vectors' offsets in shared memory: g1, b1, bp, g2, b2, b2m, b1m,
// bqkv
constexpr int V_G1 = 0, V_B1 = CP, V_BP = 2 * CP, V_G2 = 3 * CP,
              V_B2 = 4 * CP, V_B2M = 5 * CP, V_B1M = 6 * CP,
              V_BQKV = V_B1M + HIDP, V_SIZE = V_BQKV + 3 * CP;
static_assert(OFF_RING % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "tiles start on swizzle atoms");

struct Maps {
  CUtensorMap qkv, wp, w1, w2;
};

struct Params {
  const float* x;
  const float *g1, *b1;
  const float* bqkv;   // (3CP), the q part pre-scaled
  const float* bp;
  const float *g2, *b2;
  const float* b1m;
  const float* b2m;
  const float* bias;   // (heads, N, N)
  float* out;
  int H, W, C, heads, ws, shift, nwin;
  float scale;
};

// each consumer warpgroup's window: the element offset of each token's
// row in x and y (-1: no token) and its shift-mask region
struct Tables {
  long long tok[CONSUMERS][NT];
  signed char reg[CONSUMERS][NT];
};

// swizzled byte offset of element (row, 8 * c8) in a K-major tile whose
// 64-column slabs are `slab` bytes apart
__device__ __forceinline__ int swz(int row, int c8, int slab) {
  return (c8 >> 3) * slab + row * 128 + (((c8 & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// keep the compiler from moving A-fragment registers across the async
// wgmma (as fence_regs does for accumulators)
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// shift-mask region of a rolled coordinate (the JAX package's _attn_mask:
// [0, n - ws), [n - ws, n - shift), [n - shift, n))
__device__ __forceinline__ int region(int y, int n, int ws, int shift) {
  return y < n - ws ? 0 : (y < n - shift ? 1 : 2);
}

// exact-erf GELU (the reference's nn.GELU())
__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// ------------------------------------------------------------ the ring
// The producer's side: one stage of `nbox` boxes of map at (c0 + j dc0,
// c1 + j dc1), each box_bytes after the last.
__device__ __forceinline__ void load_stage(const CUtensorMap* map, int nbox,
                                           int box_bytes, int c0, int c1,
                                           int dc0, int dc1,
                                           unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int& it) {
  const int s = it % STAGES;
  if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
  unsigned char* dst = ring + s * STAGE_BYTES;
  mbar_expect_tx(&full[s], nbox * box_bytes);
  for (int j = 0; j < nbox; ++j)
    tma_load_2d(dst + j * box_bytes, map, &full[s], c0 + j * dc0,
                c1 + j * dc1);
  ++it;
}

// The consumers' side. A stage is released (one arrival a warp) once the
// wgmma group that read it has completed: `taken` after its group is
// committed and every older group waited for (wgmma_wait<1>), `release`
// after wgmma_wait<0>.
struct Ring {
  unsigned char* smem;   // the aligned dynamic shared memory
  int it, pending;

  __device__ __forceinline__ uint64_t* bars() {
    return reinterpret_cast<uint64_t*>(smem + OFF_BAR);  // full, then empty
  }
  __device__ __forceinline__ const unsigned char* wait() {
    const int s = it % STAGES;
    mbar_wait(bars() + s, (it / STAGES) & 1);
    return smem + OFF_RING + s * STAGE_BYTES;
  }
  __device__ __forceinline__ void release() {
    if (pending >= 0 && (threadIdx.x & 31) == 0)
      mbar_arrive(bars() + STAGES + pending);
    pending = -1;
  }
  __device__ __forceinline__ void taken() {
    release();
    pending = it % STAGES;
    ++it;
  }
};

__device__ __forceinline__ uint64_t kdesc(const void* p) {
  return desc_sw128(p, 16, 1024);   // K-major: LBO unused
}

// keep the compiler from hoisting the loads after it above it: a long
// unrolled loop would otherwise load every parameter at once and spill
__device__ __forceinline__ void compiler_fence() {
  asm volatile("" ::: "memory");
}

// LayerNorm of the two rows this thread holds in an accumulator layout
// (x: 64 x 192, its padded columns exactly 0) over the first C channels,
// written as bf16 into the K-major xn tile (padded channels 0: g, b are
// zero there)
__device__ __forceinline__ void layer_norm(const float (&x)[96],
                                           const float* g, const float* b,
                                           int C, unsigned char* xn) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int q4 = lane & 3;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) s[h] += x[4 * j + 2 * h] + x[4 * j + 2 * h + 1];
  const float inv_c = 1.f / (float)C;
  float mu[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    mu[h] = s[h] * inv_c;
  }
  // sum (x - mu)^2 over all CP columns, less the CP - C padded ones'
  // mu^2 each
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = x[4 * j + 2 * h + e] - mu[h];
        v[h] += d * d;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
    v[h] -= (float)(CP - C) * mu[h] * mu[h];
    rs[h] = rsqrtf(fmaxf(v[h], 0.f) * inv_c + LN_EPS);
  }
  // (x - mu) rs g + b as x a + c: the x - mu of the variance are not kept
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
    const int col = 8 * j + 2 * q4;
    const float2 gg = *reinterpret_cast<const float2*>(g + col);
    const float2 bb = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w4 + (lane >> 2) + 8 * h;
      const float a0 = rs[h] * gg.x, a1 = rs[h] * gg.y;
      *reinterpret_cast<uint32_t*>(xn + swz(row, j, SLAB) + 4 * q4) =
          pack_bf16(fmaf(x[4 * j + 2 * h], a0, fmaf(-mu[h], a0, bb.x)),
                    fmaf(x[4 * j + 2 * h + 1], a1, fmaf(-mu[h], a1, bb.y)));
    }
    if (j % 4 == 3) compiler_fence();
  }
}

// Shared memory declared statically (its addresses are constants): the
// windows' tables; the relative bias by displacement; the LayerNorm and
// bias vectors; and for consumer thread t of a warpgroup and each element
// i = 4j + 2h + e of a 64 x 64 score tile it holds (row 16 w + g + 8h, key
// 8j + 2q + e; w, g, q: its warp, lane / 4, lane % 4) the bias table's
// index, byte 2h + e of bidx[j][t] (BT_NONE for keys past n)
__shared__ Tables T;
__shared__ float btab[MAX_HEADS * BTAB];
__shared__ __align__(16) float V[V_SIZE];
__shared__ uint32_t bidx[NT / 8][128];

__device__ __forceinline__ void fill_bidx(int t, int ws) {
  const int n = ws * ws, d = 2 * ws - 1;
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2), q4 = t & 3;
  for (int j = 0; j < NT / 8; ++j) {
    uint32_t word = 0;
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * h, c = 8 * j + 2 * q4 + e;
        // displacement (r - c) + (ws - 1) in each axis, row-major (rows
        // past n: any real key)
        const int idx = c >= n  ? BT_NONE
                        : r < n ? (r / ws - c / ws + ws - 1) * d + r % ws -
                                      c % ws + ws - 1
                                : 0;
        word |= (uint32_t)idx << (8 * (2 * h + e));
      }
    bidx[j][t] = word;
  }
}

// one consumer warpgroup: window `win` of the pair, or none (nothing read
// or stored, every product still taken from the ring). EVEN: C is even, so
// a thread's column pairs are 8-byte aligned in x and y
template <bool EVEN>
__device__ __forceinline__ void consume(const Params& P, unsigned char* smem,
                                       Ring& ring, int pair, int wg) {
  const int t = threadIdx.x & 127, lane = t & 31, q4 = lane & 3;
  const int rows[2] = {16 * (t >> 5) + (lane >> 2),
                       16 * (t >> 5) + (lane >> 2) + 8};
  const int bar = 2 + wg;
  const int ws = P.ws, n = ws * ws, C = P.C;
  unsigned char* xn = smem + wg * XN_BYTES;
  unsigned char* kt = smem + OFF_K + wg * K_BYTES;
  unsigned char* vt = smem + OFF_VT + wg * VT_BYTES;
  const int win = 2 * pair + wg;

  // ---- the window's tables (the previous pair's readers are done)
  bar_sync(bar, 128);
  if (t < NT) {
    const int nwx = P.W / ws, nwin_img = (P.H / ws) * nwx;
    const int bimg = win / nwin_img, wi = win % nwin_img;
    const int ty = t / ws, tx = t % ws;
    const int y = (wi / nwx) * ws + ty, xx = (wi % nwx) * ws + tx;
    const bool ok = win < P.nwin && t < n;
    T.tok[wg][t] = ok ? (((long long)bimg * P.H + y) * P.W + xx) * C : -1;
    T.reg[wg][t] = P.shift > 0 && ok ? region(y, P.H, ws, P.shift) * 3 +
                                           region(xx, P.W, ws, P.shift)
                                     : 0;
  }
  bar_sync(bar, 128);
  // the shift mask of this thread's score elements (bit i: element i, as
  // in bidx)
  uint32_t masked = 0;
  if (P.shift > 0) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = rows[h], c = 8 * j + 2 * q4 + e;
          if (r < n && T.reg[wg][r] != T.reg[wg][c])
            masked |= 1u << (4 * j + 2 * h + e);
        }
  }

  // ---- x1 = x in the accumulator layout; LN1 into xn; x1 += bp
  float x1[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) x1[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long tok = T.tok[wg][rows[h]];
    if (tok < 0) continue;
    const float* src = P.x + tok + 2 * q4;
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      if (EVEN) {
        if (col < C) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(src + 8 * j));
          x1[4 * j + 2 * h] = v.x;
          x1[4 * j + 2 * h + 1] = v.y;
        }
      } else {
        if (col < C) x1[4 * j + 2 * h] = __ldg(src + 8 * j);
        if (col + 1 < C) x1[4 * j + 2 * h + 1] = __ldg(src + 8 * j + 1);
      }
    }
  }
  layer_norm(x1, V + V_G1, V + V_B1, C, xn);
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
    const float2 bb =
        *reinterpret_cast<const float2*>(V + V_BP + 8 * j + 2 * q4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x1[4 * j + 2 * h] += bb.x;
      x1[4 * j + 2 * h + 1] += bb.y;
    }
  }
  fence_proxy_async();
  bar_sync(bar, 128);

  // ---- attention, head by head
  for (int hh = 0; hh < P.heads; ++hh) {
    float acc[48];   // [q_h | k_h | v_h]: 64 x 96
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < CP / KC; ++kc) {
      const unsigned char* b = ring.wait();
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        wgmma_m64n96k16<0>(acc, kdesc(xn + kc * SLAB + 32 * k),
                           kdesc(b + 32 * k), 1);
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();
      ring.taken();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release();

    // q_h (scaled, + bias) as A fragments; k_h and v_h^T to their tiles
    // once every warp's products of the previous head have read them
    bar_sync(bar, 128);
    const float* bq = V + V_BQKV + HD * hh;
    uint32_t qf[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 8 * j + 2 * q4;
      const float2 b0 = *reinterpret_cast<const float2*>(bq + d);
      const float2 b1 = *reinterpret_cast<const float2*>(bq + CP + d);
      const float2 b2 = *reinterpret_cast<const float2*>(bq + 2 * CP + d);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rows[h];
        qf[j >> 1][(j & 1) * 2 + h] =
            pack_bf16(acc[4 * j + 2 * h] * P.scale + b0.x,
                      acc[4 * j + 2 * h + 1] * P.scale + b0.y);
        *reinterpret_cast<uint32_t*>(kt + swz(r, j, 0) + 4 * q4) =
            pack_bf16(acc[16 + 4 * j + 2 * h] + b1.x,
                      acc[16 + 4 * j + 2 * h + 1] + b1.y);
        // v_h^T: dims d, d + 1 are rows, the token r a column
        const __nv_bfloat162 v2 =
            __floats2bfloat162_rn(acc[32 + 4 * j + 2 * h] + b2.x,
                                  acc[32 + 4 * j + 2 * h + 1] + b2.y);
        *reinterpret_cast<bf16*>(vt + swz(d, r >> 3, 0) + 2 * (r & 7)) =
            v2.x;
        *reinterpret_cast<bf16*>(vt + swz(d + 1, r >> 3, 0) + 2 * (r & 7)) =
            v2.y;
      }
    }
    fence_proxy_async();
    bar_sync(bar, 128);

    // S = q_h k_h^T (64 x 64)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_frags(qf);
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k)
      wgmma_m64n64k16_rs<0>(sc, qf[k], kdesc(kt + 32 * k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_frags(qf);

    // softmax over the keys of each row (+ relative bias, + mask), f32;
    // keys past n get probability 0
    const float* bt = btab + hh * BTAB;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const uint32_t bi = bidx[j][t];
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[4 * j + k] += bt[bi >> (8 * k) & 255];
    }
    if (masked) {   // a window on the shifted map's seams only
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (masked >> i & 1) sc[i] -= 100.f;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(mx[h], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& l = sc[4 * j + 2 * h + e];
          l = __expf(l - mx[h]);   // keys past n: exp(-inf) = 0
          sum[h] += l;
        }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      inv[h] = 1.f / sum[h];
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pf[j >> 1][(j & 1) * 2 + h] =
            pack_bf16(sc[4 * j + 2 * h] * inv[h],
                      sc[4 * j + 2 * h + 1] * inv[h]);

    // o_h = P v_h (64 x 32)
    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    fence_frags(pf);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int k = 0; k < NT / 16; ++k)
      wgmma_m64n32k16_rs<0>(o, pf[k], kdesc(vt + 32 * k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_frags(pf);

    // x1 += bf16(o_h) @ wp[32h .. 32h + 31, :]
    uint32_t of[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        of[j >> 1][(j & 1) * 2 + h] =
            pack_bf16(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    const unsigned char* b = ring.wait();
    fence_frags(of);
    wgmma_fence();
    fence_regs(x1);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k)
      wgmma_m64n192k16_rs<1>(x1, of[k],
                             desc_sw128(b + 2048 * k, WP_SLAB, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x1);
    fence_frags(of);
    ring.taken();
    ring.release();
  }

  // ---- LN2 into xn (the last head's products have read it: the barrier
  // before its k_h / v_h^T stores came after them)
  layer_norm(x1, V + V_G2, V + V_B2, C, xn);
  fence_proxy_async();
  bar_sync(bar, 128);

  // ---- the MLP, 64 hidden columns at a time: x1 += gelu(yn @ W1 + b1) @ W2
  for (int ch = 0; ch < HIDP / HCH; ++ch) {
    float z[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) z[i] = 0.f;
    const unsigned char* b = ring.wait();   // W1[:, chunk]: 192 x 64
    wgmma_fence();
    fence_regs(z);
#pragma unroll
    for (int k = 0; k < CP / 16; ++k)
      wgmma_m64n64k16<1>(z, kdesc(xn + (k >> 2) * SLAB + 32 * (k & 3)),
                         desc_sw128(b + 2048 * k, SLAB, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);
    ring.taken();
    ring.release();
    uint32_t gf[HCH / 16][4];
    const float* b1 = V + V_B1M + HCH * ch;
#pragma unroll
    for (int j = 0; j < HCH / 8; ++j) {
      const float2 bb =
          *reinterpret_cast<const float2*>(b1 + 8 * j + 2 * q4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z0 = z[4 * j + 2 * h] + bb.x;
        const float z1 = z[4 * j + 2 * h + 1] + bb.y;
        gf[j >> 1][(j & 1) * 2 + h] = pack_bf16(gelu(z0), gelu(z1));
      }
    }
    b = ring.wait();   // W2[chunk, :]: 64 x 192
    fence_frags(gf);
    wgmma_fence();
    fence_regs(x1);
#pragma unroll
    for (int k = 0; k < HCH / 16; ++k)
      wgmma_m64n192k16_rs<1>(x1, gf[k], desc_sw128(b + 2048 * k, SLAB, 1024),
                             1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x1);
    fence_frags(gf);
    ring.taken();
    ring.release();
  }

  // ---- y = x1 + b2 for the real tokens and channels
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long tok = T.tok[wg][rows[h]];
    if (tok < 0) continue;
    float* dst = P.out + tok + 2 * q4;
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      const float2 bb = *reinterpret_cast<const float2*>(V + V_B2M + col);
      const float y0 = x1[4 * j + 2 * h] + bb.x;
      const float y1 = x1[4 * j + 2 * h + 1] + bb.y;
      if (EVEN) {
        if (col < C)
          *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(y0, y1);
      } else {
        if (col < C) dst[8 * j] = y0;
        if (col + 1 < C) dst[8 * j + 1] = y1;
      }
    }
  }
}

// ask L2 for the rows of x of window `win` (the producer, a pair ahead)
__device__ __forceinline__ void prefetch_window(const Params& P, int win) {
  if (win >= P.nwin) return;
  const int ws = P.ws, nwx = P.W / ws, nwin_img = (P.H / ws) * nwx;
  const int bimg = win / nwin_img, wi = win % nwin_img;
  for (int ty = 0; ty < ws; ++ty) {
    const long long row = ((long long)bimg * P.H + (wi / nwx) * ws + ty) *
                              P.W + (wi % nwx) * ws;
    const uintptr_t a = reinterpret_cast<uintptr_t>(P.x + row * P.C);
    const uintptr_t e = a + (uintptr_t)ws * P.C * 4;
    const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, e16 = e & ~(uintptr_t)15;
    if (e16 > a16)
      bulk_prefetch_l2(reinterpret_cast<const void*>(a16),
                       (uint32_t)(e16 - a16));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
swin_sm90(const __grid_constant__ Maps maps, const Params P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + OFF_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int npair = (P.nwin + 1) / 2;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  // the LayerNorm and bias vectors, read by every pair
  {
    const float* src[8] = {P.g1, P.b1, P.bp, P.g2, P.b2, P.b2m, P.b1m,
                           P.bqkv};
    const int off[9] = {V_G1, V_B1, V_BP, V_G2, V_B2, V_B2M, V_B1M, V_BQKV,
                        V_SIZE};
    for (int k = 0; k < 8; ++k)
      for (int i = off[k] + tid; i < off[k + 1]; i += THREADS)
        V[i] = src[k][i - off[k]];
  }
  // the relative bias by displacement: btab[h][(dy + ws - 1) * (2 ws - 1)
  // + dx + ws - 1] = bias[h][r][c] for any tokens r, c with r - c = (dy,
  // dx), so that the softmax reads shared memory only
  {
    const int ws = P.ws, n = ws * ws, d = 2 * ws - 1;
    for (int i = tid; i < P.heads * d * d; i += THREADS) {
      const int h = i / (d * d), k = i % (d * d);
      const int dy = k / d - (ws - 1), dx = k % d - (ws - 1);
      const int r = max(dy, 0) * ws + max(dx, 0);
      const int c = max(-dy, 0) * ws + max(-dx, 0);
      btab[h * BTAB + k] = P.bias[((size_t)h * n + r) * n + c];
    }
    for (int h = tid; h < MAX_HEADS; h += THREADS)
      btab[h * BTAB + BT_NONE] = -INFINITY;
    if (tid < 128) fill_bidx(tid, ws);
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer: one thread issues every copy, a pair at a time, and
    // asks L2 for the next pair's x
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (warp == CONSUMERS * 4 && lane == 0) {
      int it = 0;
      for (int pair = blockIdx.x; pair < npair; pair += gridDim.x) {
        prefetch_window(P, 2 * (pair + gridDim.x));
        prefetch_window(P, 2 * (pair + gridDim.x) + 1);
        for (int h = 0; h < P.heads; ++h) {
          for (int kc = 0; kc < CP / KC; ++kc)
            load_stage(&maps.qkv, 1, QKV_BOX, kc * KC, h * QKV_ROWS, 0, 0,
                       ring, full, empty, it);
          load_stage(&maps.wp, CP / 64, WP_SLAB, 0, h * HD, 64, 0, ring, full,
                     empty, it);
        }
        for (int ch = 0; ch < HIDP / HCH; ++ch) {
          load_stage(&maps.w1, CP / KC, SLAB, ch * HCH, 0, 0, KC, ring, full,
                     empty, it);
          load_stage(&maps.w2, CP / 64, SLAB, 0, ch * HCH, 64, 0, ring, full,
                     empty, it);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    const int wg = warp >> 2;
    Ring r{smem, 0, -1};
    for (int pair = blockIdx.x; pair < npair; pair += gridDim.x) {
      if (P.C & 1)
        consume<false>(P, smem, r, pair, wg);
      else
        consume<true>(P, smem, r, pair, wg);
    }
  }
}

// a row-major (rows, cols) bf16 matrix as (cols, rows) in boxes of 64
// columns x box_rows rows
int map_matrix(CUtensorMap* m, const void* p, int rows, int cols,
               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, dims, strides,
                     box);
}

}  // namespace

// ptrs: x, g1, b1, wqkv_hm, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m, bias,
// out. max_ctas > 0 caps the grid (each CTA then walks over window pairs);
// 0 launches one CTA a pair.
extern "C" int swin_block(void* const* ptrs, int B, int H, int W, int C,
                          int heads, int ws, int shift, float scale,
                          int max_ctas, void* stream) {
  static cudaError_t attr = allow_smem(swin_sm90, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (C < 1 || C > CP || heads < 1 || heads > MAX_HEADS || C / heads > HD ||
      ws < 1 || ws * ws > NT || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const long long nwin = (long long)B * (H / ws) * (W / ws);
  if (nwin < 1 || nwin > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params P;
  P.x = (const float*)ptrs[0];
  P.g1 = (const float*)ptrs[1];
  P.b1 = (const float*)ptrs[2];
  const void* wqkv_hm = ptrs[3];
  P.bqkv = (const float*)ptrs[4];
  const void* wp = ptrs[5];
  P.bp = (const float*)ptrs[6];
  P.g2 = (const float*)ptrs[7];
  P.b2 = (const float*)ptrs[8];
  const void* w1 = ptrs[9];
  P.b1m = (const float*)ptrs[10];
  const void* w2 = ptrs[11];
  P.b2m = (const float*)ptrs[12];
  P.bias = (const float*)ptrs[13];
  P.out = (float*)ptrs[14];
  P.H = H;
  P.W = W;
  P.C = C;
  P.heads = heads;
  P.ws = ws;
  P.shift = shift;
  P.nwin = (int)nwin;
  P.scale = scale;
  Maps m;
  int err = map_matrix(&m.qkv, wqkv_hm, MAX_HEADS * QKV_ROWS, CP, QKV_ROWS);
  if (!err) err = map_matrix(&m.wp, wp, CP, CP, HD);
  if (!err) err = map_matrix(&m.w1, w1, CP, HIDP, KC);
  if (!err) err = map_matrix(&m.w2, w2, HIDP, CP, KC);
  if (err) return err;
  const long long npair = (nwin + 1) / 2;
  const long long grid = max_ctas > 0 && max_ctas < npair ? max_ctas : npair;
  swin_sm90<<<(unsigned)grid, THREADS, SMEM, (cudaStream_t)stream>>>(m, P);
  return (int)cudaGetLastError();
}
