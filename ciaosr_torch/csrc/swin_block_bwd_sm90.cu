// Row 12 swin_block_bwd on Hopper: the backward of one whole Swin
// transformer block, its window kernel on wgmma and TMA.
//
// Replaces ciaosr_tpu/ops/pallas/swin_block.py::_swin_block_bwd_call
// (kernel _block_bwd_kernel), the custom VJP of swin_block_fused. Given the
// rolled token map x (B, H, W, C) f32 and the output's cotangent dy (same
// shape, f32), it recomputes the block forward (row 11's function,
// csrc/swin_block_sm90.cu) and returns dx and every packed parameter
// gradient in f32, with the TPU kernel's casts: matmul operands bf16 (dq,
// dk, dv, dl, dz1, dx1, dy and do rounded to bf16 before their products),
// sums, LayerNorm, softmax, GELU and GELU' (exact erf) in f32. One
// difference: the packed q bias is b_q * scale, and its gradient here is
// the sum of dL/dq before the scale (the true gradient); the TPU kernel
// sums dq after the scale, so its q-bias gradient is head_dim^-0.5 times
// the true one.
//
// Layout: row 11's packed one (C -> 192, head h in columns [32h, 32h + 32)
// of each of q, k, v, MLP hidden -> 384); LayerNorm statistics and their
// backward average over the C real channels only; padded channels, head
// columns, hidden columns and window rows come out as exact zeros.
//
// Three launches:
//  (1) swin_bwd_sm90, the window kernel. It writes dx, the per-token
//      operand pairs of the weight gradients in bf16 ((xn, [dq|dk|dv]),
//      (o, dx1), (yn, dz1), (hdn, dy): (T, width) row-major, NT rows a
//      window) and one row of f32 per-window partials (LayerNorm gamma and
//      beta, every bias, and the (heads, N, N) bias-table gradient).
//  (2) swin_wgrad_sm90, the weight-gradient kernel: dW = A^T B over the
//      tokens for Wqkv (192 x 576), Wp (192 x 192), W1 (192 x 384) and W2
//      (384 x 192), into f32 partials (splits, LD), one row a token chunk.
//      It replaces the TPU kernel's resident sums dw2 += hdn^T dy, dw1 +=
//      yn^T dz1, dwp += attn^T dx1 and dwq, dwk, dwv += xn^T [dq, dk, dv]
//      (_block_bwd_kernel's _mm_at). Bound by bytes: at the 002 batch (T =
//      24576 tokens, C = 180, 360 hidden units) the function reads 106 MB
//      of real pair columns and writes 1.0 MB of weight gradients (32 us
//      at 3.35 TB/s), for 12.7 GFLOP (13 us at the bf16 dense peak); this
//      design moves 113 MB of padded pairs and 9.4 MB of chunk partials at
//      8 chunks, and multiplies 14.5 GFLOP. Design: a CTA per 192 x 192
//      output tile (8 tiles) and token chunk, so that each pair is read
//      about 1.3 times (L2 serves the re-reads: a chunk's tiles run side by
//      side); one producer thread streams 64 tokens of the tile's A and B
//      columns a stage, by TMA in 64 x 64 boxes (the 128-byte swizzle),
//      through a 4-stage ring of 48 KB; three consumer warpgroups, one per
//      64 output rows, run wgmma m64n192k16 with both operands MN-major
//      (the pairs are token-major: A is read transposed), keep the 64 x 192
//      sum in registers and store it once. A chunk sums its tokens in a
//      fixed order.
//  (3) swin_gsum_kernel: sums the window partials and the chunk partials in
//      a fixed order. No atomics anywhere, and each element of dx, of a pair
//      and of a partial is written by one thread, so the gradients are the
//      same bits run to run.
// The TPU kernel keeps its parameter gradients resident across a
// sequential grid; on Hopper blocks run in no order and dWqkv alone (442 KB
// f32) does not fit in shared memory, hence (2) and (3).
//
// The window kernel takes row 11's machinery: a persistent CTA a
// multiprocessor walking over window pairs, one consumer warpgroup a window
// (64 token rows: one m64 wgmma tile), and one producer thread streaming
// every weight by TMA through a 4-stage ring of 24 KB that both consumers
// read, in the same order for every pair; setmaxnreg 232 / 40; the
// relative bias by displacement and the shift mask as a bit a score
// element; LayerNorm in the accumulator's layout. Three passes, each weight
// tile once a pass:
//  1. The forward recompute, per head: [q|k|v]_h = xn @ wqkv_hm[96 rows of
//     h]^T (3 stages), S, softmax, o_h = P v_h, x1 += o_h @ wp[32 rows of h]
//     (1 stage). Writes the xn and o pairs, and q_h, k_h, v_h (bf16) into
//     the dqkv pair's slots as scratch for pass 3; x1 goes to dx as
//     scratch, yn = LN2(x1) and bf16(dy) to shared memory.
//  2. The MLP forward and backward fused, per 64-column hidden chunk (a W1
//     stage and a W2 stage): z = yn @ W1[:, c]; hdn = GELU(z + b1);
//     dh = bf16(dy) @ W2[c, :]^T; dz1 = dh GELU'(z + b1); dyn +=
//     bf16(dz1) @ W1[:, c]^T (the W1 stage read the other way). Then LN2'
//     gives dx1 (f32 to dx, replacing x1; bf16 to its pair), and do =
//     bf16(dx1) @ wp^T for every head (3 stages of wp, 64 columns x 192
//     rows), kept as a bf16 tile.
//  3. The attention backward, per head: q_h, k_h, v_h read back from the
//     dqkv pair; S and P again; dP = do_h v_h^T; dv = P^T do; dl = P (dP -
//     rowsum(P dP)), the head's bias-table partial; dq = dl k_h, dk = dl^T
//     q_h; dxn += bf16([dq scale | dk | dv]_h) @ wqkv_hm[96 rows of h] (its
//     3 stages again, read MN-major). Then LN1' gives dx = dx1 + LN1'(dxn).
// P^T and dl^T are read as MN-major A operands (wgmma's transposed A) of
// the natural P and dl tiles; dq, dk and dv come from m64n64 products
// against [q|k] and a do slab, half of each product unused.
// Shared memory: a window's 48 KB region (pass 1: xn, k_h, v_h^T; pass 2:
// yn, bf16 dy; pass 3: do, [q|k]_h, v_h, P then dl) twice, the ring (96
// KB) and tables (25 KB): 218 KB, one CTA an SM.
//
// Bound on the H100 (SwinIR-CiaoSR, C = 180, hidden 360, N = 64): about 3x
// the forward's 2*T*C*(4C + 2*360) + 4*T*N*C FLOPs (recompute + 2x for the
// backward products), 41.6 GFLOP at the 002 batch's T = 24576 tokens, 42 us
// at the bf16 dense peak; x, dy and dx in f32 move 53 MB (16 us). The
// window kernel alone moves x and dy in, dx, the ~113 MB of bf16 pairs and
// the ~41 MB of f32 partials out: 207 MB, 62 us at 3.35 TB/s.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int CP = 192;     // packed residual width
constexpr int HD = 32;      // head slot
constexpr int MAX_HEADS = CP / HD;
constexpr int HIDP = 384;   // packed MLP hidden width
constexpr int QKV = 3 * CP;
constexpr int NT = 64;      // tokens a window, at most (one m64 tile)
constexpr int QKV_ROWS = 3 * HD;   // wqkv_hm rows a head
constexpr int HCH = 64;            // MLP hidden columns a chunk
constexpr int NCH = HIDP / HCH;
// the relative-bias table's stride: (2 ws - 1)^2 <= 225 displacements,
// then -inf at BT_NONE for keys past n
constexpr int BTAB = 226, BT_NONE = 225;
constexpr int KC = 64;             // K chunk: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int SLAB = KC * 128;          // 64 rows x 64 bf16 columns: 8 KB
constexpr int WP_SLAB = HD * 128;       // 32 rows x 64 columns: 4 KB
constexpr int QKV_BOX = QKV_ROWS * 128;   // 96 rows x 64 K: 12 KB
constexpr int WPT_BOX = CP * 128;         // 192 rows x 64 K: 24 KB
constexpr int STAGE_BYTES = 3 * SLAB;     // the largest stage: 24 KB
constexpr int TILE = (CP / KC) * SLAB;    // a 64 x 192 bf16 tile: 24 KB
// a window's region and its tiles by pass (the first TILE: xn, yn, do)
constexpr int REGION = 2 * TILE;
constexpr int R_KT = TILE, R_VT = TILE + SLAB;                  // pass 1
constexpr int R_DY = TILE;                                      // pass 2
constexpr int R_QK = TILE, R_V = TILE + SLAB, R_PL = TILE + 2 * SLAB;
constexpr int CONSUMERS = 2;
// a whole producer warpgroup (see csrc/swin_block_sm90.cu)
constexpr int CTA_THREADS = (CONSUMERS + 1) * 128;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int OFF_RING = CONSUMERS * REGION;
constexpr int OFF_BAR = OFF_RING + STAGES * STAGE_BYTES;
constexpr int SMEM = 1024 + OFF_BAR + 2 * STAGES * 8;
constexpr float LN_EPS = 1e-5f;
// the vectors' offsets in shared memory: g1, b1, bp, g2, b2, b1m, bqkv
constexpr int V_G1 = 0, V_B1 = CP, V_BP = 2 * CP, V_G2 = 3 * CP,
              V_B2 = 4 * CP, V_B1M = 5 * CP, V_BQKV = V_B1M + HIDP,
              V_SIZE = V_BQKV + QKV;
static_assert(OFF_RING % 1024 == 0 && STAGE_BYTES % 1024 == 0 &&
                  REGION % 1024 == 0 && R_PL % 1024 == 0,
              "tiles start on swizzle atoms");
static_assert(R_VT + HD * 128 <= REGION && R_PL + SLAB <= REGION,
              "a window's tiles fit its region");

// per-window partial row: vectors, then the (heads, n, n) bias gradient
constexpr int PV_G1 = 0, PV_B1 = CP, PV_BQKV = 2 * CP, PV_BP = 5 * CP,
              PV_G2 = 6 * CP, PV_B2 = 7 * CP, PV_B1M = 8 * CP,
              PV_B2M = 8 * CP + HIDP, PV_BIAS = 9 * CP + HIDP;   // 2112

struct Maps {
  CUtensorMap qkv, wp, w1, w2, wpt;
};

struct Params {
  const float *x, *dy;
  const float *g1, *b1;
  const float* bqkv;   // (3CP), the q part pre-scaled
  const float* bp;
  const float *g2, *b2;
  const float* b1m;
  const float* bias;   // (heads, N, N)
  float* dx;
  // per-token pairs, NT rows a window: (T, width) bf16
  bf16 *xn, *dqkv, *o, *dx1, *yn, *dz1, *hdn, *dyb;
  float* part;         // (windows, PV_BIAS + heads*N*N) f32
  int H, W, C, heads, ws, shift, nwin;
  float scale;
};

// each consumer warpgroup's window: the element offset of each token's
// row in x, dy and dx (-1: no token) and its shift-mask region
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

// stores of what this kernel writes once and never reads back (the pairs,
// the partials): cache-streaming, evicted from L2 first, so that the maps
// the backward passes re-read (x, dy, and x1 and dx1 in dx) stay there
__device__ __forceinline__ void st_cs(bf16* p, uint32_t v) {
  __stcs(reinterpret_cast<unsigned int*>(p), v);
}
__device__ __forceinline__ void st_cs(bf16* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
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

// exact-erf GELU (the reference's nn.GELU()) of z, and its derivative in
// d, from one erff
__device__ __forceinline__ float gelu(float z, float& d) {
  const float phi = 0.5f * (1.f + erff(z * 0.70710678118654752f));
  d = phi + z * 0.3989422804014327f * expf(-0.5f * z * z);
  return z * phi;
}

__device__ __forceinline__ uint64_t kdesc(const void* p) {
  return desc_sw128(p, 16, 1024);   // K-major: LBO unused
}
// an MN-major operand of one 64-column slab: 16 K rows a 2048-byte step
__device__ __forceinline__ uint64_t mdesc(const void* p) {
  return desc_sw128(p, SLAB, 1024);
}

// keep the compiler from hoisting the loads after it above it: a long
// unrolled loop would otherwise load every parameter at once and spill
__device__ __forceinline__ void compiler_fence() {
  asm volatile("" ::: "memory");
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

// The consumers' side: stages are taken in the producer's order and each
// is released (one arrival a warp) once the wgmma groups that read it
// have completed (after wgmma_wait<0>); a product may hold several.
struct Ring {
  unsigned char* smem;   // the aligned dynamic shared memory
  int it;

  __device__ __forceinline__ const unsigned char* acquire(int& s) {
    s = it % STAGES;
    mbar_wait(reinterpret_cast<uint64_t*>(smem + OFF_BAR) + s,
              (it / STAGES) & 1);
    ++it;
    return smem + OFF_RING + s * STAGE_BYTES;
  }
  __device__ __forceinline__ void release(int s) {
    if ((threadIdx.x & 31) == 0)
      mbar_arrive(reinterpret_cast<uint64_t*>(smem + OFF_BAR) + STAGES + s);
  }
};

// the stages a pair takes: per head 3 + 1 (pass 1) and 3 (pass 3); per
// hidden chunk 2; wp^T 3
__device__ __forceinline__ int stages_a_pair(int heads) {
  return heads * 7 + 2 * NCH + 3;
}

// Shared memory declared statically (its addresses are constants): the
// windows' tables; the relative bias by displacement; the LayerNorm and
// bias vectors; the column-sum scratch of each consumer warpgroup; and
// for consumer thread t of a warpgroup and each element i = 4j + 2h + e of
// a 64 x 64 score tile it holds (row 16 w + g + 8h, key 8j + 2q + e; w,
// g, q: its warp, lane / 4, lane % 4) the bias table's index, byte 2h + e
// of bidx[j][t] (BT_NONE for keys past n)
__shared__ Tables T;
__shared__ float btab[MAX_HEADS * BTAB];
__shared__ __align__(16) float V[V_SIZE];
__shared__ uint32_t bidx[NT / 8][128];
__shared__ float red[CONSUMERS][4][CP];

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

// Column sums over a consumer warpgroup's 64 rows, a chunk at a time.
// colsum_part reduces this thread's values c[2j + e] of column groups j0
// .. j0 + G - 1 (columns 8(j0 + j) + 2q + e, q = lane % 4; its two rows
// already added) over the 8 lanes that share q (a reduce-scatter over lane
// bits 4, 3, 2) into the warp's row of rd. colsum_end sums the 4 warps'
// rows in order and calls out(col, sum) once for each of the first ncols
// columns. A fixed order of sums.
template <int G>
__device__ __forceinline__ void colsum_part(float (&c)[2 * G], int j0,
                                            float* rd) {
  constexpr int N = 2 * G;
  static_assert(N == 8 || N == 16, "chunks of 4 or 8 column groups");
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  int off = 0;
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int m = 16 >> step;
    const bool up = lane & m;
    const int half = N >> (step + 1);
#pragma unroll
    for (int i = 0; i < (N >> (step + 1)); ++i) {
      const float send = up ? c[i] : c[i + half];
      const float keep = up ? c[i + half] : c[i];
      c[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
    off += up ? half : 0;
  }
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int idx = 2 * j0 + off + i;
    rd[w * CP + 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1)] = c[i];
  }
}

template <typename Out>
__device__ __forceinline__ void colsum_end(int ncols, const float* rd,
                                           int bar, Out out) {
  const int t = threadIdx.x & 127;
  bar_sync(bar, 128);
  for (int col = t; col < ncols; col += 128)
    out(col, rd[col] + rd[CP + col] + rd[2 * CP + col] + rd[3 * CP + col]);
  bar_sync(bar, 128);
}

// column groups j0 .. j0 + G - 1 of an accumulator layout x with its two
// rows added: c[2j + e] = x[4(j0 + j) + e] + x[4(j0 + j) + 2 + e]
template <int G, int M>
__device__ __forceinline__ void fold(const float (&x)[M], int j0,
                                     float (&c)[2 * G]) {
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      c[2 * j + e] = x[4 * (j0 + j) + e] + x[4 * (j0 + j) + 2 + e];
}

// the column sums of a 64 x 192 accumulator layout
template <typename Out>
__device__ __forceinline__ void colsum192(const float (&x)[96], float* rd,
                                          int bar, Out out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float c[16];
    fold<8>(x, 8 * k, c);
    colsum_part<8>(c, 8 * k, rd);
  }
  colsum_end(CP, rd, bar, out);
}

// columns col, col + 1 of a token row at element offset tok of a (.., C)
// f32 map (0 where absent; EVEN: C is even, the pair is 8-byte aligned)
template <bool EVEN>
__device__ __forceinline__ float2 ld_cols(const float* base, long long tok,
                                          int col, int C) {
  float2 v = make_float2(0.f, 0.f);
  if (tok < 0) return v;
  const float* p = base + tok + col;
  if (EVEN) {
    if (col < C) v = *reinterpret_cast<const float2*>(p);
  } else {
    if (col < C) v.x = p[0];
    if (col + 1 < C) v.y = p[1];
  }
  return v;
}

template <bool EVEN>
__device__ __forceinline__ void st_cols(float* base, long long tok, int col,
                                        int C, float a, float b) {
  if (tok < 0) return;
  float* p = base + tok + col;
  if (EVEN) {
    if (col < C) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (col < C) p[0] = a;
    if (col + 1 < C) p[1] = b;
  }
}

// a 64 x 192 map in the accumulator layout (the thread's rows tok[2])
template <bool EVEN>
__device__ __forceinline__ void load_map(const float* base,
                                         const long long (&tok)[2], int C,
                                         float (&x)[96]) {
  const int q4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = ld_cols<EVEN>(base, tok[h], 8 * j + 2 * q4, C);
      x[4 * j + 2 * h] = v.x;
      x[4 * j + 2 * h + 1] = v.y;
    }
}

template <bool EVEN>
__device__ __forceinline__ void store_map(float* base,
                                          const long long (&tok)[2], int C,
                                          const float (&x)[96]) {
  const int q4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st_cols<EVEN>(base, tok[h], 8 * j + 2 * q4, C, x[4 * j + 2 * h],
                    x[4 * j + 2 * h + 1]);
}

// an accumulator-layout 64 x 192 array as bf16 into the K-major tile
__device__ __forceinline__ void to_tile(const float (&x)[96],
                                        unsigned char* tile) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w4 + (lane >> 2) + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + swz(row, j, SLAB) +
                                   4 * (lane & 3)) =
          pack_bf16(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
    }
}

// the window's 64 rows of a K-major tile (192 columns) into a (T, 192)
// pair from row 0 of dst (16-byte copies)
__device__ __forceinline__ void tile_to_pair(const unsigned char* tile,
                                             bf16* dst) {
  for (int i = threadIdx.x & 127; i < NT * (CP / 8); i += 128) {
    const int row = i / (CP / 8), c8 = i % (CP / 8);
    st_cs(dst + (size_t)row * CP + 8 * c8,
          *reinterpret_cast<const uint4*>(tile + swz(row, c8, SLAB)));
  }
}

// LayerNorm of the two rows this thread holds in an accumulator layout
// (x: 64 x 192, its padded columns exactly 0) over the first C channels,
// written as bf16 into the K-major tile xn (padded channels 0: g, b are
// zero there; rows at or past n 0); mu and rs: the rows' mean and 1/std
__device__ __forceinline__ void layer_norm(const float (&x)[96],
                                           const float* g, const float* b,
                                           int C, int n, unsigned char* xn,
                                           float (&mu)[2], float (&rs)[2]) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int q4 = lane & 3;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) s[h] += x[4 * j + 2 * h] + x[4 * j + 2 * h + 1];
  const float inv_c = 1.f / (float)C;
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
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
    v[h] -= (float)(CP - C) * mu[h] * mu[h];
    rs[h] = rsqrtf(fmaxf(v[h], 0.f) * inv_c + LN_EPS);
    ok[h] = 16 * w4 + (lane >> 2) + 8 * h < n;
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
      const float y0 = fmaf(x[4 * j + 2 * h], a0, fmaf(-mu[h], a0, bb.x));
      const float y1 =
          fmaf(x[4 * j + 2 * h + 1], a1, fmaf(-mu[h], a1, bb.y));
      *reinterpret_cast<uint32_t*>(xn + swz(row, j, SLAB) + 4 * q4) =
          ok[h] ? pack_bf16(y0, y1) : 0u;
    }
    if (j % 4 == 3) compiler_fence();
  }
}

// Softmax over the 64 keys of this thread's two rows of a score tile (+
// the relative bias of head hh, + the shift mask where `masked` has a
// bit), f32 in place; keys past n and rows past n get probability 0.
__device__ __forceinline__ void softmax(float (&sc)[32], int hh,
                                        uint32_t masked, int n) {
  const int t = threadIdx.x & 127, lane = t & 31;
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
    inv[h] = 16 * (t >> 5) + (lane >> 2) + 8 * h < n ? 1.f / sum[h] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[4 * j + 2 * h + e] *= inv[h];
}

// a 64 x 64 accumulator (rows of this thread) as bf16 into a one-slab
// K-major tile
__device__ __forceinline__ void acc64_to_tile(const float (&x)[32],
                                              unsigned char* tile) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w4 + (lane >> 2) + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + swz(row, j, 0) + 4 * (lane & 3)) =
          pack_bf16(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
    }
}

// 32 columns of an accumulator layout (x[4j + 2h + e], j < 4) as bf16
// into a (T, ld) pair at column c0, this window's rows from row 0 of dst,
// each value times s; and as two A fragments
__device__ __forceinline__ void half_out(const float (&x)[16], float s,
                                         bf16* dst,
                                         int ld, int c0,
                                         uint32_t (&f)[2][4]) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w4 + (lane >> 2) + 8 * h;
      const uint32_t v =
          pack_bf16(x[4 * j + 2 * h] * s, x[4 * j + 2 * h + 1] * s);
      f[j >> 1][(j & 1) * 2 + h] = v;
      st_cs(dst + (size_t)row * ld + c0 + 8 * j + 2 * (lane & 3), v);
    }
}

// one consumer warpgroup on window `win`. EVEN: C is even
template <bool EVEN>
__device__ __forceinline__ void consume(const Params& P, unsigned char* smem,
                                       Ring& ring, int win, int wg) {
  const int t = threadIdx.x & 127, lane = t & 31, q4 = lane & 3;
  const int rows[2] = {16 * (t >> 5) + (lane >> 2),
                       16 * (t >> 5) + (lane >> 2) + 8};
  const int bar = 2 + wg;
  const int ws = P.ws, n = ws * ws, C = P.C, heads = P.heads;
  unsigned char* R = smem + wg * REGION;
  float* rd = &red[wg][0][0];
  const size_t t0 = (size_t)win * NT;
  float* part = P.part + (size_t)win * (PV_BIAS + heads * n * n);

  // ---- the window's tables (the previous window's readers are done)
  bar_sync(bar, 128);
  if (t < NT) {
    const int nwx = P.W / ws, nwin_img = (P.H / ws) * nwx;
    const int bimg = win / nwin_img, wi = win % nwin_img;
    const int ty = t / ws, tx = t % ws;
    const int y = (wi / nwx) * ws + ty, xx = (wi % nwx) * ws + tx;
    const bool ok = t < n;
    T.tok[wg][t] = ok ? (((long long)bimg * P.H + y) * P.W + xx) * C : -1;
    T.reg[wg][t] = P.shift > 0 && ok ? region(y, P.H, ws, P.shift) * 3 +
                                           region(xx, P.W, ws, P.shift)
                                     : 0;
  }
  bar_sync(bar, 128);
  const long long tok[2] = {T.tok[wg][rows[0]], T.tok[wg][rows[1]]};
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

  // ================= pass 1: the forward recompute
  float mu1[2], rs1[2], mu2[2], rs2[2];
  float x1[96];
  load_map<EVEN>(P.x, tok, C, x1);
  layer_norm(x1, V + V_G1, V + V_B1, C, n, R, mu1, rs1);
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
  tile_to_pair(R, P.xn + t0 * CP);
  {   // the o pair's empty head slots
    const int per = (MAX_HEADS - heads) * (HD / 8);
    for (int i = t; i < NT * per; i += 128)
      *reinterpret_cast<uint4*>(P.o + (t0 + i / per) * CP + HD * heads +
                                8 * (i % per)) = make_uint4(0, 0, 0, 0);
  }
  unsigned char* kt = R + R_KT;
  unsigned char* vt = R + R_VT;
  for (int hh = 0; hh < heads; ++hh) {
    float acc[48];   // [q_h | k_h | v_h]: 64 x 96
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] = 0.f;
    int st[3];
#pragma unroll
    for (int kc = 0; kc < CP / KC; ++kc) {
      const unsigned char* b = ring.acquire(st[kc]);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        wgmma_m64n96k16<0>(acc, kdesc(R + kc * SLAB + 32 * k),
                           kdesc(b + 32 * k), 1);
      wgmma_commit();
      fence_regs(acc);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < CP / KC; ++kc) ring.release(st[kc]);

    // q_h (scaled, + bias) as A fragments; k_h and v_h^T to their tiles
    // once every warp's products of the previous head have read them; q,
    // k, v into the dqkv pair's slots (pass 3 reads them back)
    bar_sync(bar, 128);
    const float* bq = V + V_BQKV + HD * hh;
    bf16* qkv_dst = P.dqkv + t0 * QKV + HD * hh;
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
        const uint32_t qv = pack_bf16(acc[4 * j + 2 * h] * P.scale + b0.x,
                                      acc[4 * j + 2 * h + 1] * P.scale + b0.y);
        const uint32_t kv = pack_bf16(acc[16 + 4 * j + 2 * h] + b1.x,
                                      acc[16 + 4 * j + 2 * h + 1] + b1.y);
        const __nv_bfloat162 v2 =
            __floats2bfloat162_rn(acc[32 + 4 * j + 2 * h] + b2.x,
                                  acc[32 + 4 * j + 2 * h + 1] + b2.y);
        qf[j >> 1][(j & 1) * 2 + h] = qv;
        *reinterpret_cast<uint32_t*>(kt + swz(r, j, 0) + 4 * q4) = kv;
        // v_h^T: dims d, d + 1 are rows, the token r a column
        *reinterpret_cast<bf16*>(vt + swz(d, r >> 3, 0) + 2 * (r & 7)) =
            v2.x;
        *reinterpret_cast<bf16*>(vt + swz(d + 1, r >> 3, 0) + 2 * (r & 7)) =
            v2.y;
        bf16* dst = qkv_dst + (size_t)r * QKV + d;
        *reinterpret_cast<uint32_t*>(dst) = qv;
        *reinterpret_cast<uint32_t*>(dst + CP) = kv;
        *reinterpret_cast<__nv_bfloat162*>(dst + 2 * CP) = v2;
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
    softmax(sc, hh, masked, n);
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pf[j >> 1][(j & 1) * 2 + h] =
            pack_bf16(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);

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

    // the o pair; x1 += bf16(o_h) @ wp[32h .. 32h + 31, :]
    uint32_t of[2][4];
    half_out(o, 1.f, P.o + t0 * CP, CP, HD * hh, of);
    int s;
    const unsigned char* b = ring.acquire(s);
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
    ring.release(s);
  }

  // ---- yn = LN2(x1) into the first tile (the last head's products have
  // read xn: the barrier before its k_h / v_h^T stores came after them);
  // x1 to dx (scratch, each element read back by the thread that wrote it)
  layer_norm(x1, V + V_G2, V + V_B2, C, n, R, mu2, rs2);
  store_map<EVEN>(P.dx, tok, C, x1);
  // ---- bf16(dy) into the second tile once every warp's S and o products
  // have read k_h and v_h^T; the fc2-bias partial
  bar_sync(bar, 128);
  {
    load_map<EVEN>(P.dy, tok, C, x1);   // x1's registers hold dy now
    to_tile(x1, R + R_DY);
    fence_proxy_async();
    colsum192(x1, rd, bar, [&](int col, float v) { part[PV_B2M + col] = v; });
  }
  tile_to_pair(R, P.yn + t0 * CP);
  tile_to_pair(R + R_DY, P.dyb + t0 * CP);

  // ================= pass 2: the MLP forward and backward, 64 hidden
  // columns at a time
  float dyn[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) dyn[i] = 0.f;
  for (int ch = 0; ch < NCH; ++ch) {
    float z[32], dh[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) z[i] = dh[i] = 0.f;
    int s1, s2;
    const unsigned char* w1 = ring.acquire(s1);   // W1[:, chunk]: 192 x 64
    wgmma_fence();
    fence_regs(z);
#pragma unroll
    for (int k = 0; k < CP / 16; ++k)
      wgmma_m64n64k16<1>(z, kdesc(R + (k >> 2) * SLAB + 32 * (k & 3)),
                         mdesc(w1 + 2048 * k), 1);
    wgmma_commit();
    fence_regs(z);
    const unsigned char* w2 = ring.acquire(s2);   // W2[chunk, :]: 64 x 192
    wgmma_fence();
    fence_regs(dh);
#pragma unroll
    for (int k = 0; k < CP / 16; ++k)
      wgmma_m64n64k16<0>(dh,
                         kdesc(R + R_DY + (k >> 2) * SLAB + 32 * (k & 3)),
                         kdesc(w2 + (k >> 2) * SLAB + 32 * (k & 3)), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);
    fence_regs(dh);
    // hdn = GELU(z + b1), dz1 = dh GELU'(z + b1) (0 on rows past n): their
    // pairs, dz1 in f32 in dh and in bf16 as A fragments
    const float* b1 = V + V_B1M + HCH * ch;
    uint32_t gf[HCH / 16][4];
#pragma unroll
    for (int j = 0; j < HCH / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = rows[h] < n;
        const float z0 = z[4 * j + 2 * h] + bb.x;
        const float z1 = z[4 * j + 2 * h + 1] + bb.y;
        float g0, g1;
        const float y0 = gelu(z0, g0), y1 = gelu(z1, g1);
        const float d0 = ok ? dh[4 * j + 2 * h] * g0 : 0.f;
        const float d1 = ok ? dh[4 * j + 2 * h + 1] * g1 : 0.f;
        dh[4 * j + 2 * h] = d0;
        dh[4 * j + 2 * h + 1] = d1;
        const uint32_t dz = pack_bf16(d0, d1);
        gf[j >> 1][(j & 1) * 2 + h] = dz;
        const size_t at = (t0 + rows[h]) * HIDP + HCH * ch + col;
        st_cs(P.hdn + at, ok ? pack_bf16(y0, y1) : 0u);
        st_cs(P.dz1 + at, dz);
      }
    }
    // dyn += bf16(dz1) @ W1[:, chunk]^T: the W1 stage as a K-major
    // 192-row B
    fence_frags(gf);
    wgmma_fence();
    fence_regs(dyn);
#pragma unroll
    for (int k = 0; k < HCH / 16; ++k)
      wgmma_m64n192k16_rs<0>(dyn, gf[k], kdesc(w1 + 32 * k), 1);
    wgmma_commit();
    fence_regs(dyn);
    {   // the fc1-bias partial while the product runs
      float c[16];
      fold<8>(dh, 0, c);
      colsum_part<8>(c, 0, rd);
      colsum_end(HCH, rd, bar,
                 [&](int col, float v) { part[PV_B1M + HCH * ch + col] = v; });
    }
    wgmma_wait<0>();
    fence_regs(dyn);
    fence_frags(gf);
    ring.release(s1);
    ring.release(s2);
  }

  // ---- LN2': dx1 = dy + rs2 (dyn g2 - mean(dyn g2) - xhat2 mean(dyn g2
  // xhat2)), x1 read back from dx; the LN2 and proj-bias partials
  {
    // the LN2-gain partial (dyn xhat2) reduced a chunk of 8 column groups
    // at a time
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float c[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * k + jj, col = 8 * j + 2 * q4;
        const float2 gg = *reinterpret_cast<const float2*>(V + V_G2 + col);
        c[2 * jj] = c[2 * jj + 1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 xv = ld_cols<EVEN>(P.dx, tok[h], col, C);
          const bool ok = tok[h] >= 0;
          const float xh0 = ok && col < C ? (xv.x - mu2[h]) * rs2[h] : 0.f;
          const float xh1 =
              ok && col + 1 < C ? (xv.y - mu2[h]) * rs2[h] : 0.f;
          const float g0 = dyn[4 * j + 2 * h] * gg.x;
          const float g1 = dyn[4 * j + 2 * h + 1] * gg.y;
          s1[h] += g0 + g1;
          s2[h] += g0 * xh0 + g1 * xh1;
          c[2 * jj] += dyn[4 * j + 2 * h] * xh0;
          c[2 * jj + 1] += dyn[4 * j + 2 * h + 1] * xh1;
        }
        if (jj % 4 == 3) compiler_fence();
      }
      colsum_part<8>(c, 8 * k, rd);
    }
    colsum_end(CP, rd, bar, [&](int col, float v) { part[PV_G2 + col] = v; });
    colsum192(dyn, rd, bar, [&](int col, float v) { part[PV_B2 + col] = v; });
    const float inv_c = 1.f / (float)C;
    float m1[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 1);
      s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 2);
      s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 1);
      s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 2);
      m1[h] = s1[h] * inv_c;
      m2[h] = s2[h] * inv_c;
    }
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      const float2 gg = *reinterpret_cast<const float2*>(V + V_G2 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 xv = ld_cols<EVEN>(P.dx, tok[h], col, C);
        const float2 dv = ld_cols<EVEN>(P.dy, tok[h], col, C);
        const bool ok0 = tok[h] >= 0 && col < C, ok1 = tok[h] >= 0 && col + 1 < C;
        const float xh0 = (xv.x - mu2[h]) * rs2[h];
        const float xh1 = (xv.y - mu2[h]) * rs2[h];
        float& a0 = dyn[4 * j + 2 * h];
        float& a1 = dyn[4 * j + 2 * h + 1];
        a0 = ok0 ? dv.x + rs2[h] * (a0 * gg.x - m1[h] - xh0 * m2[h]) : 0.f;
        a1 = ok1 ? dv.y + rs2[h] * (a1 * gg.y - m1[h] - xh1 * m2[h]) : 0.f;
      }
      if (j % 4 == 3) compiler_fence();
    }
  }
  float (&dx1)[96] = dyn;
  store_map<EVEN>(P.dx, tok, C, dx1);
  uint32_t xf[CP / 16][4];   // bf16(dx1): its pair and A fragments
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = pack_bf16(dx1[4 * j + 2 * h], dx1[4 * j + 2 * h + 1]);
      xf[j >> 1][(j & 1) * 2 + h] = v;
      st_cs(P.dx1 + (t0 + rows[h]) * CP + 8 * j + 2 * q4, v);
    }
  colsum192(dx1, rd, bar, [&](int col, float v) { part[PV_BP + col] = v; });

  // ---- do = bf16(dx1) @ wp^T for every head (wp's 192 rows, 64 of its
  // columns a stage: a K-major B), kept in the first tile as bf16
  {
    float dof[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) dof[i] = 0.f;
    int st[3];
#pragma unroll
    for (int kc = 0; kc < CP / KC; ++kc) {
      const unsigned char* b = ring.acquire(st[kc]);
      fence_frags(xf);
      wgmma_fence();
      fence_regs(dof);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        wgmma_m64n192k16_rs<0>(dof, xf[4 * kc + k], kdesc(b + 32 * k), 1);
      wgmma_commit();
      fence_regs(dof);
    }
    wgmma_wait<0>();
    fence_regs(dof);
    fence_frags(xf);
#pragma unroll
    for (int kc = 0; kc < CP / KC; ++kc) ring.release(st[kc]);
    // every warp's MLP products have read yn and dy
    bar_sync(bar, 128);
    to_tile(dof, R);
  }
  {   // the dqkv pair's empty head slots and their bias partials
    const int per = (MAX_HEADS - heads) * (HD / 8);
    for (int i = t; i < 3 * NT * per; i += 128) {
      const int p = i / (NT * per), r = (i / per) % NT, c = i % per;
      *reinterpret_cast<uint4*>(P.dqkv + (t0 + r) * QKV + p * CP +
                                HD * heads + 8 * c) = make_uint4(0, 0, 0, 0);
    }
    for (int i = t; i < 3 * (MAX_HEADS - heads) * HD; i += 128) {
      const int p = i / ((MAX_HEADS - heads) * HD);
      part[PV_BQKV + p * CP + HD * heads + i % ((MAX_HEADS - heads) * HD)] =
          0.f;
    }
  }

  // ================= pass 3: the attention backward, head by head
  float dxn[CP / KC][32];
#pragma unroll
  for (int kc = 0; kc < CP / KC; ++kc)
#pragma unroll
    for (int i = 0; i < 32; ++i) dxn[kc][i] = 0.f;
  unsigned char* qk = R + R_QK;
  unsigned char* vv = R + R_V;
  unsigned char* pl = R + R_PL;
  for (int hh = 0; hh < heads; ++hh) {
    unsigned char* doh = R + (hh >> 1) * SLAB;   // do_h's slab
    // q_h, k_h and v_h back from the dqkv pair: [q | k] and [v | -] tiles
    // (every warp's products of the previous head are done with them)
    bar_sync(bar, 128);
    {
      const bf16* src = P.dqkv + t0 * QKV + HD * hh;
      for (int i = t; i < NT * 12; i += 128) {
        const int r = i / 12, c = i % 12, p = c >> 2;
        const uint4 v = __ldcg(reinterpret_cast<const uint4*>(
            src + (size_t)r * QKV + p * CP + 8 * (c & 3)));
        unsigned char* dst = p < 2 ? qk + swz(r, c, 0) : vv + swz(r, c & 3, 0);
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    fence_proxy_async();
    bar_sync(bar, 128);

    // S = q k^T again, softmax: P (f32) and bf16 into its tile
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k)
      wgmma_m64n64k16<0>(sc, kdesc(qk + 32 * k), kdesc(qk + 64 + 32 * k), 1);
    wgmma_commit();
    fence_regs(sc);
    // dP = do_h v_h^T
    fence_regs(dp);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k)
      wgmma_m64n64k16<0>(dp, kdesc(doh + 64 * (hh & 1) + 32 * k),
                         kdesc(vv + 32 * k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    softmax(sc, hh, masked, n);
    acc64_to_tile(sc, pl);
    // dl = P (dP - rowsum(P dP)) in dp; its bias-table partial
    {
      float rs_[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            rs_[h] += sc[4 * j + 2 * h + e] * dp[4 * j + 2 * h + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs_[h] += __shfl_xor_sync(0xffffffffu, rs_[h], 1);
        rs_[h] += __shfl_xor_sync(0xffffffffu, rs_[h], 2);
      }
      float* pb = part + PV_BIAS + (size_t)hh * n * n;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            dp[i] = sc[i] * (dp[i] - rs_[h]);
          }
      // each pair of keys by one 8-byte store where rows are (n even)
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h, c = 8 * j + 2 * q4;
          float* dst = pb + rows[h] * n + c;
          if (rows[h] >= n || c >= n) continue;
          if (!(n & 1)) {
            __stcs(reinterpret_cast<float2*>(dst), make_float2(dp[i], dp[i + 1]));
          } else {
            __stcs(dst, dp[i]);
            if (c + 1 < n) __stcs(dst + 1, dp[i + 1]);
          }
        }
    }
    fence_proxy_async();
    bar_sync(bar, 128);

    // dv = P^T do_h: P's tile as an MN-major A, do's slab as an MN-major
    // B; half (hh & 1) of the 64 columns is head hh's
    // bf16 [dq scale | dk | dv]_h: the dxn product's A; the f32 column
    // sums of [dq | dk | dv]_h go to rd as each is made (column groups 0-3,
    // 4-7, 8-11)
    uint32_t af[6][4];
    {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < NT / 16; ++k)
        wgmma_m64n64k16<1, 1>(acc, mdesc(pl + 2048 * k),
                                 mdesc(doh + 2048 * k), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      float v[16];
      if (hh & 1) {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = acc[16 + i];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = acc[i];
      }
      uint32_t f2[2][4];
      half_out(v, 1.f, P.dqkv + t0 * QKV, QKV, 2 * CP + HD * hh, f2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        af[4][i] = f2[0][i];
        af[5][i] = f2[1][i];
      }
      float c[8];
      fold<4>(v, 0, c);
      colsum_part<4>(c, 8, rd);
    }
    // bf16(dl) over P once every warp's dv product has read P
    bar_sync(bar, 128);
    acc64_to_tile(dp, pl);
    fence_proxy_async();
    bar_sync(bar, 128);
    // dq = dl [q | k]: the right half (dl k); dk = dl^T [q | k]: the left
    // half (dl^T q)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      wgmma_fence();
      fence_regs(acc);
      if (p == 0) {
#pragma unroll
        for (int k = 0; k < NT / 16; ++k)
          wgmma_m64n64k16<1, 0>(acc, kdesc(pl + 32 * k),
                                   mdesc(qk + 2048 * k), 1);
      } else {
#pragma unroll
        for (int k = 0; k < NT / 16; ++k)
          wgmma_m64n64k16<1, 1>(acc, mdesc(pl + 2048 * k),
                                   mdesc(qk + 2048 * k), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = p == 0 ? acc[16 + i] : acc[i];
      uint32_t f2[2][4];
      half_out(v, p == 0 ? P.scale : 1.f, P.dqkv + t0 * QKV, QKV,
               p * CP + HD * hh, f2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        af[2 * p][i] = f2[0][i];
        af[2 * p + 1][i] = f2[1][i];
      }
      float c[8];
      fold<4>(v, 0, c);
      colsum_part<4>(c, 4 * p, rd);
    }
    // dxn += bf16([dq scale | dk | dv]_h) @ wqkv_hm[96 rows of h]: each
    // stage a 64-column slab of the 192 inputs, read MN-major
    int st[3];
#pragma unroll
    for (int kc = 0; kc < CP / KC; ++kc) {
      const unsigned char* b = ring.acquire(st[kc]);
      fence_frags(af);
      wgmma_fence();
      fence_regs(dxn[kc]);
#pragma unroll
      for (int k = 0; k < QKV_ROWS / 16; ++k)
        wgmma_m64n64k16_rs<1>(dxn[kc], af[k], mdesc(b + 2048 * k), 1);
      wgmma_commit();
      fence_regs(dxn[kc]);
    }
    // the q, k and v bias partials while the product runs
    colsum_end(3 * HD, rd, bar, [&](int col, float v) {
      part[PV_BQKV + (col >> 5) * CP + HD * hh + (col & 31)] = v;
    });
    wgmma_wait<0>();
#pragma unroll
    for (int kc = 0; kc < CP / KC; ++kc) fence_regs(dxn[kc]);
    fence_frags(af);
#pragma unroll
    for (int kc = 0; kc < CP / KC; ++kc) ring.release(st[kc]);
  }

  // ---- LN1': dx = dx1 + rs1 (dxn g1 - mean(dxn g1) - xhat1 mean(dxn g1
  // xhat1)), dx1 read back from dx; the LN1 partials (the gain's reduced
  // a chunk of 8 column groups, one dxn accumulator, at a time)
  {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < CP / KC; ++k) {
      float c[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * k + 8 * jj + 2 * q4;
        const float2 gg = *reinterpret_cast<const float2*>(V + V_G1 + col);
        c[2 * jj] = c[2 * jj + 1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 xv = ld_cols<EVEN>(P.x, tok[h], col, C);
          const bool ok = tok[h] >= 0;
          const float xh0 = ok && col < C ? (xv.x - mu1[h]) * rs1[h] : 0.f;
          const float xh1 =
              ok && col + 1 < C ? (xv.y - mu1[h]) * rs1[h] : 0.f;
          const float d0 = dxn[k][4 * jj + 2 * h];
          const float d1 = dxn[k][4 * jj + 2 * h + 1];
          const float g0 = d0 * gg.x, g1 = d1 * gg.y;
          s1[h] += g0 + g1;
          s2[h] += g0 * xh0 + g1 * xh1;
          c[2 * jj] += d0 * xh0;
          c[2 * jj + 1] += d1 * xh1;
        }
        if (jj % 4 == 3) compiler_fence();
      }
      colsum_part<8>(c, 8 * k, rd);
    }
    colsum_end(CP, rd, bar, [&](int col, float v) { part[PV_G1 + col] = v; });
#pragma unroll
    for (int k = 0; k < CP / KC; ++k) {
      float c[16];
      fold<8>(dxn[k], 0, c);
      colsum_part<8>(c, 8 * k, rd);
    }
    colsum_end(CP, rd, bar, [&](int col, float v) { part[PV_B1 + col] = v; });
    const float inv_c = 1.f / (float)C;
    float m1[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 1);
      s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 2);
      s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 1);
      s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 2);
      m1[h] = s1[h] * inv_c;
      m2[h] = s2[h] * inv_c;
    }
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      const float2 gg = *reinterpret_cast<const float2*>(V + V_G1 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = dxn[j >> 3][4 * (j & 7) + 2 * h];
        const float d1 = dxn[j >> 3][4 * (j & 7) + 2 * h + 1];
        const float2 xv = ld_cols<EVEN>(P.x, tok[h], col, C);
        const float2 a = ld_cols<EVEN>(P.dx, tok[h], col, C);
        const float xh0 = (xv.x - mu1[h]) * rs1[h];
        const float xh1 = (xv.y - mu1[h]) * rs1[h];
        st_cols<EVEN>(P.dx, tok[h], col, C,
                      a.x + rs1[h] * (d0 * gg.x - m1[h] - xh0 * m2[h]),
                      a.y + rs1[h] * (d1 * gg.y - m1[h] - xh1 * m2[h]));
      }
      if (j % 4 == 3) compiler_fence();
    }
  }
}

// ask L2 for the rows of x and dy of window `win` (the producer, a pair
// ahead)
__device__ __forceinline__ void prefetch_window(const Params& P, int win) {
  if (win >= P.nwin) return;
  const int ws = P.ws, nwx = P.W / ws, nwin_img = (P.H / ws) * nwx;
  const int bimg = win / nwin_img, wi = win % nwin_img;
  for (int ty = 0; ty < ws; ++ty) {
    const long long row = ((long long)bimg * P.H + (wi / nwx) * ws + ty) *
                              P.W + (wi % nwx) * ws;
    for (int m = 0; m < 2; ++m) {
      const uintptr_t a =
          reinterpret_cast<uintptr_t>((m ? P.dy : P.x) + row * P.C);
      const uintptr_t e = a + (uintptr_t)ws * P.C * 4;
      const uintptr_t a16 = (a + 15) & ~(uintptr_t)15,
                      e16 = e & ~(uintptr_t)15;
      if (e16 > a16)
        bulk_prefetch_l2(reinterpret_cast<const void*>(a16),
                         (uint32_t)(e16 - a16));
    }
  }
}

__global__ void __launch_bounds__(CTA_THREADS, 1)
swin_bwd_sm90(const __grid_constant__ Maps maps, const Params P) {
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
    const float* src[7] = {P.g1, P.b1, P.bp, P.g2, P.b2, P.b1m, P.bqkv};
    const int off[8] = {V_G1, V_B1, V_BP, V_G2, V_B2, V_B1M, V_BQKV, V_SIZE};
    for (int k = 0; k < 7; ++k)
      for (int i = off[k] + tid; i < off[k + 1]; i += CTA_THREADS)
        V[i] = src[k][i - off[k]];
  }
  // the relative bias by displacement (see csrc/swin_block_sm90.cu)
  {
    const int ws = P.ws, n = ws * ws, d = 2 * ws - 1;
    for (int i = tid; i < P.heads * d * d; i += CTA_THREADS) {
      const int h = i / (d * d), k = i % (d * d);
      const int dy = k / d - (ws - 1), dx = k % d - (ws - 1);
      const int r = max(dy, 0) * ws + max(dx, 0);
      const int c = max(-dy, 0) * ws + max(-dx, 0);
      btab[h * BTAB + k] = P.bias[((size_t)h * n + r) * n + c];
    }
    for (int h = tid; h < MAX_HEADS; h += CTA_THREADS)
      btab[h * BTAB + BT_NONE] = -INFINITY;
    if (tid < 128) fill_bidx(tid, ws);
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer: one thread issues every copy, a pair at a time, and
    // asks L2 for the next pair's x and dy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (warp == CONSUMERS * 4 && lane == 0) {
      int it = 0;
      for (int pair = blockIdx.x; pair < npair; pair += gridDim.x) {
        prefetch_window(P, 2 * (pair + gridDim.x));
        prefetch_window(P, 2 * (pair + gridDim.x) + 1);
        // pass 1: per head wqkv_hm's 96 rows in 3 K chunks, wp's 32 rows
        for (int h = 0; h < P.heads; ++h) {
          for (int kc = 0; kc < CP / KC; ++kc)
            load_stage(&maps.qkv, 1, QKV_BOX, kc * KC, h * QKV_ROWS, 0, 0,
                       ring, full, empty, it);
          load_stage(&maps.wp, CP / 64, WP_SLAB, 0, h * HD, 64, 0, ring, full,
                     empty, it);
        }
        // pass 2: per hidden chunk W1[:, chunk], W2[chunk, :]; then wp in
        // 3 column chunks of all 192 rows
        for (int ch = 0; ch < NCH; ++ch) {
          load_stage(&maps.w1, CP / KC, SLAB, ch * HCH, 0, 0, KC, ring, full,
                     empty, it);
          load_stage(&maps.w2, CP / 64, SLAB, 0, ch * HCH, 64, 0, ring, full,
                     empty, it);
        }
        for (int kc = 0; kc < CP / KC; ++kc)
          load_stage(&maps.wpt, 1, WPT_BOX, kc * KC, 0, 0, 0, ring, full,
                     empty, it);
        // pass 3: per head wqkv_hm's 96 rows again
        for (int h = 0; h < P.heads; ++h)
          for (int kc = 0; kc < CP / KC; ++kc)
            load_stage(&maps.qkv, 1, QKV_BOX, kc * KC, h * QKV_ROWS, 0, 0,
                       ring, full, empty, it);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    const int wg = warp >> 2;
    Ring r{smem, 0};
    for (int pair = blockIdx.x; pair < npair; pair += gridDim.x) {
      const int win = 2 * pair + wg;
      if (win >= P.nwin) {   // no window: take and free the pair's stages
        for (int i = stages_a_pair(P.heads); i > 0; --i) {
          int s;
          r.acquire(s);
          r.release(s);
        }
      } else if (P.C & 1) {
        consume<false>(P, smem, r, win, wg);
      } else {
        consume<true>(P, smem, r, win, wg);
      }
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

// ------------------------------------------------ the weight-gradient kernel
// dW = A^T B over the tokens for the four products (pair 2p is A, pair
// 2p + 1 is B), a CTA per 192 x 192 output tile (WG_TILES of them) and token
// chunk (blockIdx.y): one producer thread streams, 64 tokens a stage, the
// tile's A and B columns as 64 x 64 TMA boxes through a WG_STAGES ring;
// consumer warpgroup w takes the tile's output rows [64w, 64w + 64) as a
// 64 x 192 f32 accumulator, both operands MN-major (the pairs are
// token-major), and writes it to the chunk's partial row.
constexpr int WG_TILE = 192;
constexpr int WG_TILES = 8;    // Wqkv 1 x 3, Wp 1 x 1, W1 1 x 2, W2 2 x 1
constexpr int WG_CONSUMERS = WG_TILE / 64;
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 32;   // + a producer warp
constexpr int WG_STAGES = 4;
constexpr int WG_HALF = (WG_TILE / 64) * SLAB;   // 64 tokens x 192: 24 KB
constexpr int WG_STAGE = 2 * WG_HALF;            // A's, then B's
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8;
static_assert(WG_STAGE % 1024 == 0, "stages start on swizzle atoms");

struct WMaps {
  CUtensorMap pair[8];   // (T, width) bf16, boxes of 64 columns x 64 tokens
};

struct WParams {
  float* part;   // (splits, LD) f32
  int LD, T, chunk;
};

__global__ void __launch_bounds__(WG_THREADS, 1)
swin_wgrad_sm90(const __grid_constant__ WMaps maps, const WParams P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * WG_STAGE);
  uint64_t* empty = full + WG_STAGES;
  // the tile: product p, its tile row tm and column tn
  const int t = blockIdx.x;
  const int p = t < 3 ? 0 : (t < 4 ? 1 : (t < 6 ? 2 : 3));
  const int N = p == 0 ? QKV : (p == 2 ? HIDP : CP);
  const int off = p == 0 ? 0
                  : p == 1 ? CP * QKV
                  : p == 2 ? CP * QKV + CP * CP
                           : CP * QKV + CP * CP + CP * HIDP;
  const int local = t - (p == 0 ? 0 : (p == 1 ? 3 : (p == 2 ? 4 : 6)));
  const int tm = local / (N / WG_TILE), tn = local % (N / WG_TILE);
  // the chunk's tokens: whole stages (T and the chunk are multiples of 64)
  const int k0 = blockIdx.y * P.chunk;
  const int steps = k0 < P.T ? (min(P.T, k0 + P.chunk) - k0) / KC : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS * 4);   // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS * 4) {   // the producer
    if (lane == 0) {
      const CUtensorMap* a = &maps.pair[2 * p];
      const CUtensorMap* b = &maps.pair[2 * p + 1];
      for (int i = 0; i < steps; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES) mbar_wait(&empty[s], (i / WG_STAGES - 1) & 1);
        unsigned char* dst = smem + s * WG_STAGE;
        mbar_expect_tx(&full[s], WG_STAGE);
        for (int j = 0; j < WG_TILE / 64; ++j) {
          tma_load_2d(dst + j * SLAB, a, &full[s], tm * WG_TILE + 64 * j,
                      k0 + KC * i);
          tma_load_2d(dst + WG_HALF + j * SLAB, b, &full[s],
                      tn * WG_TILE + 64 * j, k0 + KC * i);
        }
      }
    }
    return;
  }

  // a consumer: rows [64 wg, 64 wg + 64) of the tile; each stage's group
  // is waited one stage later, then the stage is released
  const int wg = warp >> 2;
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % WG_STAGES;
    mbar_wait(&full[s], (i / WG_STAGES) & 1);
    const unsigned char* st = smem + s * WG_STAGE;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < KC / 16; ++k)
      wgmma_m64n192k16<1, 1>(acc, mdesc(st + wg * SLAB + 2048 * k),
                             mdesc(st + WG_HALF + 2048 * k), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % WG_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // d[4j + 2h + e]: row 16 (warp % 4) + lane / 4 + 8h, column 8j + 2 (lane
  // % 4) + e of the warpgroup's 64 x 192
  float* out = P.part + (size_t)blockIdx.y * P.LD + off +
               (size_t)(tm * WG_TILE + 64 * wg + 16 * (warp & 3) +
                        (lane >> 2)) * N +
               tn * WG_TILE + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < WG_TILE / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (size_t)8 * h * N + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// out[e] = the sum over windows of the window partials (e < lw), then the
// sum over chunks of the weight partials; fixed order
__global__ void swin_gsum_kernel(const float* pw, int nw, int lw,
                                 const float* pd, int ns, int ld,
                                 float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (e < lw) {
    for (int w = 0; w < nw; ++w) s += pw[(size_t)w * lw + e];
  } else if (e < lw + ld) {
    for (int i = 0; i < ns; ++i) s += pd[(size_t)i * ld + e - lw];
  } else {
    return;
  }
  out[e] = s;
}

}  // namespace

// ptrs: x, dy, g1, b1, wqkv_hm, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m,
// bias, dx, xn, dqkv, o, dx1, yn, dz1, hdn, dyb, part (b2m is not read)
extern "C" int swin_block_bwd(void* const* ptrs, int B, int H, int W, int C,
                              int heads, int ws, int shift, float scale,
                              void* stream) {
  static cudaError_t attr = allow_smem(swin_bwd_sm90, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (C < 1 || C > CP || heads < 1 || heads * HD > CP || C / heads > HD ||
      ws < 1 || ws * ws > NT || H % ws || W % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const long long nwin = (long long)B * (H / ws) * (W / ws);
  if (nwin < 1 || nwin > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  Params P;
  int k = 0;
  P.x = (const float*)ptrs[k++];
  P.dy = (const float*)ptrs[k++];
  P.g1 = (const float*)ptrs[k++];
  P.b1 = (const float*)ptrs[k++];
  const void* wqkv_hm = ptrs[k++];
  P.bqkv = (const float*)ptrs[k++];
  const void* wp = ptrs[k++];
  P.bp = (const float*)ptrs[k++];
  P.g2 = (const float*)ptrs[k++];
  P.b2 = (const float*)ptrs[k++];
  const void* w1 = ptrs[k++];
  P.b1m = (const float*)ptrs[k++];
  const void* w2 = ptrs[k++];
  k++;   // b2m: its gradient is dy's column sum
  P.bias = (const float*)ptrs[k++];
  P.dx = (float*)ptrs[k++];
  P.xn = (bf16*)ptrs[k++];
  P.dqkv = (bf16*)ptrs[k++];
  P.o = (bf16*)ptrs[k++];
  P.dx1 = (bf16*)ptrs[k++];
  P.yn = (bf16*)ptrs[k++];
  P.dz1 = (bf16*)ptrs[k++];
  P.hdn = (bf16*)ptrs[k++];
  P.dyb = (bf16*)ptrs[k++];
  P.part = (float*)ptrs[k++];
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
  if (!err) err = map_matrix(&m.wpt, wp, CP, CP, CP);
  if (err) return err;
  const long long npair = (nwin + 1) / 2;
  const long long grid = npair < sms ? npair : sms;
  swin_bwd_sm90<<<(unsigned)grid, CTA_THREADS, SMEM, (cudaStream_t)stream>>>(
      m, P);
  return (int)cudaGetLastError();
}

// ptrs: xn, dqkv, o, dx1, yn, dz1, hdn, dyb (T rows each, T a multiple of
// NT), part (splits, LD)
extern "C" int swin_block_wgrad(void* const* ptrs, int T, int splits,
                                void* stream) {
  static cudaError_t attr = allow_smem(swin_wgrad_sm90, WG_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (T < NT || T % NT || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int width[8] = {CP, QKV, CP, CP, CP, HIDP, HIDP, CP};
  WMaps m;
  for (int k = 0; k < 8; ++k) {
    const int err = map_matrix(&m.pair[k], ptrs[k], T, width[k], KC);
    if (err) return err;
  }
  WParams P;
  P.part = (float*)ptrs[8];
  P.LD = CP * QKV + CP * CP + CP * HIDP + HIDP * CP;
  P.T = T;
  P.chunk = ((T + splits - 1) / splits + KC - 1) / KC * KC;
  swin_wgrad_sm90<<<dim3(WG_TILES, splits), WG_THREADS, WG_SMEM,
                    (cudaStream_t)stream>>>(m, P);
  return (int)cudaGetLastError();
}

extern "C" int swin_block_gsum(const float* pw, int nw, int lw,
                               const float* pd, int ns, int ld, float* out,
                               void* stream) {
  if (nw < 1 || lw < 1 || ns < 1 || ld < 1) return (int)cudaErrorInvalidValue;
  const int total = lw + ld;
  swin_gsum_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      pw, nw, lw, pd, ns, ld, out);
  return (int)cudaGetLastError();
}
