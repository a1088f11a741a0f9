// K3 grid_decode on Hopper: the integer-scale dense-grid decoder with
// wgmma and TMA.
//
// Replaces ciaosr_tpu/ops/pallas/decoder_kernel.py::_grid_decode_halo
// (kernel _decode_kernel_halo, integer mode, entered from
// grid_decode_fused; at W % 8 != 0 also grid_decode_fused's stacked
// assembly, which computes the same function). For each LR pixel p, HR
// phase ph (s^2 of them) and local-ensemble shift i, with (dy, dx) = the
// shift's constant offset for this phase and q = the edge-clamped pixel
// p + (dy, dx):
//   h_k = MLP_k hidden layers of relu(g_k[q] + rely*w_ry + relx*w_rx + b0)
//   logit_i = wt_{dy,dx}[p] . h_k + ck_{dy,dx}[p]
//   h_v = MLP_v hidden layers of relu(g_v[q] + rel terms + b0)
//   pred_i = [u[q] | csa[q]] (.) (h_v @ W_vout + b_vout)       (DV wide)
// then softmax_i(logit_i / softmax_scale), outv = sum_i attn_i pred_i, and
// rgb = imnet_q(outv). Output: (B, s^2, H, W, 3) f32 phase images before
// the bilinear residual; b0 has the cell terms folded in (host side).
// Casts as the TPU kernel: h is rounded to bf16 before every product, h_k
// stays f32 for the logit, pred is rounded to bf16 (decoder_kernel.py:
// 930-933), the blend and the softmax are f32, outv is rounded to bf16
// before imnet_q (:949-954).
//
// Bound on the H100: 2*s^2*M*(4*(6*256^2 + 256*DV + 256) + DV*256
// + 3*256^2 + 256*3) = 3.05 TFLOP at s = 4, M = 192^2, DV = 640: 3.1 ms at
// the bf16 dense peak; 8.07 TFLOP (8.2 ms) for C = 180 on a 256^2 map.
// Compute-bound: the gathered inputs are L2-resident, the output small.
//
// Design. A CTA decodes 32 pixels of one phase with the (up to) 4 shifts
// of a group stacked into 128 rows: row = shift * 32 + pixel. Two consumer
// warpgroups own 64 rows each (shifts 2w, 2w + 1) as 64 x 256 f32 wgmma
// accumulators; a producer warpgroup (one thread issues; the others only
// hand their registers to the consumers, 240 each) streams every weight
// matrix through a 4-stage ring of 64-deep K chunks (four 64-column TMA
// boxes, 32 KB), read MN-major by wgmma straight from the (in, out)
// row-major matrices. Each weight chunk feeds all 128 rows. The schedule
// of chunks is fixed: kw[0..2] per group; then per group vw[0..2] and, per
// 128-column chunk of DV, W_vout[:, chunk] followed by W_q0[chunk, :];
// then qw[0..2].
// The activations `act` (128 x 256 bf16, K-major, 128-byte swizzle) are
// the A operand of every MLP layer; each warpgroup rewrites its own rows
// in place from its accumulator registers (bias, relu, bf16), ordered by
// its own named barrier only. The value is blended chunk by chunk: pred
// of a 128-column chunk is formed in registers (64 x 128 a warpgroup),
// the four shifts' attn * pred are added into an f32 32 x 128 chunk of
// outv in a fixed order (shift 0, 1, 2, 3, ordered by named barriers:
// reproducible), rounded to bf16 (`qin`) and multiplied at once by W_q0's
// rows of the chunk into an f32 sum that stays in registers (each
// warpgroup 128 of the 256 columns, an M = 64 wgmma of which 32 rows are
// real). Chunks of 128 and not 256 columns keep that sum (64 registers)
// and a chunk's pred (64) within a consumer's 240 registers with room for
// the gathers: at 256 columns the two took 192 and the kernel spilled.
// Rounding each chunk equals rounding the whole outv (elementwise), so
// only the order of the f32 sums differs from the TPU kernel. With more
// than 4 shifts (local_size 3: 9) each group of 4 is blended and rounded
// on its own before W_q0, which departs from the TPU's single rounding of
// the whole sum by the bf16 class. imnet_q's hidden layers run on the 32
// real rows (M = 64 tiles, each warpgroup 128 columns); its 256 -> 3 layer
// is reduced from registers.
// Compiled for (C, DC) = (64, 64), the flagship (DV = 640), (192, 0),
// SwinIR-CiaoSR's 180 channels zero-padded, without CSA (DV = 1728), and
// (192, 192), SwinIR-CiaoSR with CSA (config 001 swinir; its 180 CSA
// channels zero-padded too: DV = 1920, fifteen value chunks). At C = 192
// the DK = 1728 boundary falls in the middle of the 14th value chunk, on a
// 64-column slab boundary (27 slabs), as DK = 576 does in the flagship's
// 5th: each slab is gathered from the feature or from the CSA map alone.
// Without the unfold (feat_unfold=False: TAPS = 1; the TPU kernel with
// u_map = feature) u is the feature itself, DK = C: compiled so at
// (64, 64), DV = 128 is one blend chunk of two slabs, the first read
// from the feature at q, the second from the CSA map; imnet_q's first
// layer is K = 128. The MLP layers, the ring and the shared memory are
// the nine-tap instance's.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int HID = 256;
constexpr int PIX = 32;          // pixels a CTA
constexpr int SG = 4;            // shifts stacked a product
constexpr int ROWS = PIX * SG;   // 128 rows
constexpr int MAX_SHIFT = 9;
constexpr int KC = 64;           // K chunk: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int SLAB = KC * 128;          // 64 K rows x 64 columns: 8 KB
constexpr int STAGE_BYTES = 4 * SLAB;   // up to 256 columns
constexpr int ACT_SLAB = ROWS * 128;    // act: 64 K columns of 128 rows
constexpr int QIN_SLAB = PIX * 128;     // qin: 64 K columns of 32 rows
constexpr int VCH = 128;                // value columns a blend chunk
constexpr int LDO = VCH + 8;            // outv row stride (f32)
constexpr int CONSUMERS = 2;
// a whole producer warpgroup: setmaxnreg moves registers only between
// the warpgroups of one CTA; the consumers' 240 need its 128 x 144
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int OFF_RING = 4 * ACT_SLAB;
constexpr int OFF_QIN = OFF_RING + STAGES * STAGE_BYTES;
// qin's slabs are 32 rows apart, so the M = 64 operand's rows 32..63 read
// the next slab or outv: rows whose products are discarded. That read is a
// deliberate race: one warpgroup's wgmma may still read outv while the
// other starts the next chunk's blend into it. Only discarded rows see it,
// which saves 8 KB of zeroed padding the budget has no room for; a race
// checker reports it, so exclude these addresses in such a run.
constexpr int OFF_OUTV = OFF_QIN + (VCH / 64) * QIN_SLAB;
constexpr int OFF_BAR = OFF_OUTV + PIX * LDO * 4;
constexpr int SMEM = 1024 + OFF_BAR + 2 * STAGES * 8;
// named barriers: 1 = both consumer warpgroups, 2 + w = warpgroup w
constexpr int BAR_ALL = 1;

struct Maps {
  CUtensorMap kw, vw, qw, vout, qw0;
};

struct Params {
  const bf16 *feat, *csa, *gk, *gv, *wt;
  const float* ck;
  const float *kb, *vb, *vbout, *qb0, *qb;  // f32 biases
  const float *krel, *kb0, *vrel, *vb0;     // first-layer rel rows, bias
  const float *qwout, *qbout;               // (3, 256) and (3,)
  const int *dys, *dxs;                     // (n_phase, n_shift)
  const float *rely, *relx;                 // (n_phase, n_shift, H / W)
  float* out;
  int H, W, M, n_phase, n_shift;
  float inv_softmax_scale;
};

// the CTA's small tables: its pixels; the rows of the current shift group
// (each warpgroup writes and reads its own); logits, softmax weights and
// the two warpgroups' halves of the RGB sums
struct Tables {
  int row_p[PIX], row_b[PIX], row_y[PIX], row_x[PIX];
  int q[ROWS];        // key pixel (b, qy, qx) flattened; -1: no row
  int qy[ROWS], qx[ROWS];
  float ry[ROWS], rx[ROWS];
  size_t wt[ROWS];    // row of the wt planes (and of ck) at the query
  float logit[MAX_SHIFT * PIX], attn[MAX_SHIFT * PIX];
  float part[CONSUMERS][PIX][3];
};

// swizzled byte offset of element (row, 8 * c8 + 2 * quad) in a K-major
// tile whose 64-column slabs are `slab` bytes apart
__device__ __forceinline__ int swz(int row, int c8, int slab) {
  return (c8 >> 3) * slab + row * 128 + (((c8 & 7) ^ (row & 7)) << 4);
}

// one ring stage: `nslab` 64 x 64 boxes of map at (col0 + 64 j, row0)
__device__ __forceinline__ void load_stage(const CUtensorMap* map, int col0,
                                           int row0, int nslab,
                                           unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int& it) {
  const int s = it % STAGES;
  if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
  unsigned char* dst = ring + s * STAGE_BYTES;
  mbar_expect_tx(&full[s], nslab * SLAB);
  for (int j = 0; j < nslab; ++j)
    tma_load_2d(dst + j * SLAB, map, &full[s], col0 + 64 * j, row0);
  ++it;
}

// acc (64 x N) (+)= A (64 rows x 64 nk, K-major slabs `a_slab` apart) @
// nk ring stages (their columns from b_off); from zero unless ACC. Each
// warp releases a stage once its products are done.
template <int N, bool ACC>
__device__ __forceinline__ void gemm(float (&acc)[N / 2],
                                     const unsigned char* a, int a_slab,
                                     int nk, const unsigned char* ring,
                                     int b_off, uint64_t* full,
                                     uint64_t* empty, int& it) {
  const int lane = threadIdx.x & 31;
  // zeros instead of scale-d 0: the registers' old values are then dead
  // before the product, free for the code before it
  if (!ACC)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* b = ring + s * STAGE_BYTES + b_off;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      const uint64_t da = desc_sw128(a + kc * a_slab + 32 * k, 16, 1024);
      const uint64_t db = desc_sw128(b + 2048 * k, SLAB, 1024);
      if constexpr (N == 256)
        wgmma_m64n256k16<1>(acc, da, db, 1);
      else
        wgmma_m64n128k16<1>(acc, da, db, 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    ++it;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
}

// act[own rows, :] = bf16(relu(acc + bias)), in place of the layer's input
__device__ __forceinline__ void epi_act(const float (&acc)[128],
                                        const float* bias,
                                        unsigned char* act, int wg) {
  const int w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
#pragma unroll
  for (int j = 0; j < HID / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * w4 + (lane >> 2) + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(act + swz(r, j, ACT_SLAB) + 4 * q4) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h] + bb.x, 0.f),
                                fmaxf(acc[4 * j + 2 * h + 1] + bb.y, 0.f));
    }
  }
}

// imnet_q: act[rows 0..31, this warpgroup's 128 columns] =
// bf16(relu(acc + bias)) (warps 0-1 of each warpgroup hold the real rows)
__device__ __forceinline__ void epi_q(const float (&acc)[64],
                                      const float* bias, unsigned char* act,
                                      int wg) {
  const int w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  if (w4 >= 2) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c8 = 16 * wg + j;
    const float2 bb =
        *reinterpret_cast<const float2*>(bias + 8 * c8 + 2 * q4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w4 + (lane >> 2) + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(act + swz(r, c8, ACT_SLAB) + 4 * q4) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h] + bb.x, 0.f),
                                fmaxf(acc[4 * j + 2 * h + 1] + bb.y, 0.f));
    }
  }
}

// three hidden layers on this warpgroup's rows of act, each but the last
// written back in place; the last one's acc is left to the caller
__device__ __forceinline__ void hidden(float (&acc)[128], const float* b,
                                       unsigned char* act, int wg,
                                       const unsigned char* ring,
                                       uint64_t* full, uint64_t* empty,
                                       int& it) {
  for (int l = 0; l < 3; ++l) {
    gemm<256, false>(acc, act + wg * 64 * 128, ACT_SLAB, 4, ring, 0, full,
                     empty, it);
    if (l == 2) break;
    bar_sync(2 + wg, 128);  // every warp's products have read act
    epi_act(acc, b + l * HID, act, wg);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
  }
}

// outv[pix, chunk] (+)= acc's values of this thread's two rows; mode 0
// stores, 1 adds, 2 adds and writes the sum rounded to bf16 into qin
__device__ __forceinline__ void blend(const float (&acc)[64], int mode,
                                      int nc, int pix0,
                                      float* outv, unsigned char* qin) {
  const int q4 = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < VCH / 8; ++j) {
      if (8 * j < nc) {
        float2* o =
            reinterpret_cast<float2*>(outv + (pix0 + 8 * h) * LDO + 8 * j +
                                      2 * q4);
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (mode > 0) {
          const float2 old = *o;
          v.x = old.x + v.x;
          v.y = old.y + v.y;
        }
        if (mode < 2)
          *o = v;
        else
          *reinterpret_cast<__nv_bfloat162*>(
              qin + swz(pix0 + 8 * h, j, QIN_SLAB) + 4 * q4) =
              __floats2bfloat162_rn(v.x, v.y);
      }
    }
}

// the two consumer warpgroups: warpgroup wg owns rows 64 wg .. 64 wg + 63
template <int C, int DC, int TAPS>
__device__ __forceinline__ void consume(const Params& P, unsigned char* smem,
                                        Tables& T, int ph) {
  constexpr int DK = TAPS * C, DV = DK + DC;
  unsigned char* act = smem;
  const unsigned char* ring = smem + OFF_RING;
  unsigned char* qin = smem + OFF_QIN;
  float* outv = reinterpret_cast<float*>(smem + OFF_OUTV);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int H = P.H, W = P.W, M = P.M, NS = P.n_shift;
  const int tid = threadIdx.x, lane = tid & 31, t = tid & 127;
  const int wg = tid >> 7, w4 = (tid >> 5) & 3, q4 = lane & 3;
  const int bar_wg = 2 + wg;
  const unsigned char* act_wg = act + wg * 64 * 128;
  int it = 0;
  float acc[128];   // an MLP layer: 64 rows x 256
  float accv[64];   // a value chunk: 64 rows x VCH
  float qacc[64];   // imnet_q: 64 rows (32 real) x this warpgroup's 128

  // the rows of shift group g0 (each warpgroup its own)
  auto setup_rows = [&](int g0) {
    bar_sync(bar_wg, 128);
    if (t < 64) {
      const int row = 64 * wg + t, pix = row % PIX, s = g0 + row / PIX;
      const bool ok = s < NS && T.row_p[pix] >= 0;
      const int ps = ph * NS + (s < NS ? s : 0);
      const int dy = P.dys[ps], dx = P.dxs[ps];
      const int qy = clampi(T.row_y[pix] + dy, 0, H - 1);
      const int qx = clampi(T.row_x[pix] + dx, 0, W - 1);
      T.q[row] = ok ? (T.row_b[pix] * H + qy) * W + qx : -1;
      T.qy[row] = qy;
      T.qx[row] = qx;
      T.ry[row] = P.rely[(size_t)ps * H + T.row_y[pix]];
      T.rx[row] = P.relx[(size_t)ps * W + T.row_x[pix]];
      T.wt[row] = ((size_t)((dy + 1) * 3 + (dx + 1)) * M +
                   (ok ? T.row_p[pix] : 0)) * HID;
    }
    bar_sync(bar_wg, 128);
  };
  // act[own rows] = bf16(relu(g[q] + ry * rel0 + rx * rel1 + b0)): a
  // thread keeps one 8-column group; a warp reads 512 B of one g row
  auto first_layer = [&](const bf16* g, const float* rel, const float* b0) {
    const int c8 = t & 31;
    float r0[8], r1[8], bb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      r0[e] = rel[8 * c8 + e];
      r1[e] = rel[HID + 8 * c8 + e];
      bb[e] = b0[8 * c8 + e];
    }
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int row = 64 * wg + (t >> 5) + 4 * i;
      const int q = T.q[row];
      uint4 o = zero8();
      if (q >= 0) {
        uint4 gv = ld8(g + (size_t)q * HID + 8 * c8);
        const bf16* gg = reinterpret_cast<const bf16*>(&gv);
        const float ry = T.ry[row], rx = T.rx[row];
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = f2bf(fmaxf(bf2f(gg[e]) + ry * r0[e] + rx * r1[e] + bb[e],
                            0.f));
        o = *reinterpret_cast<uint4*>(v);
      }
      *reinterpret_cast<uint4*>(act + swz(row, c8, ACT_SLAB)) = o;
    }
    fence_proxy_async();
    bar_sync(bar_wg, 128);
  };

  // ---- k-paths: one logit per (pixel, shift)
  for (int g0 = 0; g0 < NS; g0 += SG) {
    setup_rows(g0);
    first_layer(P.gk, P.krel, P.kb0);
    hidden(acc, P.kb, act, wg, ring, full, empty, it);
    // h_k = relu(acc + b) stays f32: logit = wt . h_k + ck, a quad a row
    const float* bias = P.kb + 2 * HID;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * w4 + (lane >> 2) + 8 * h;
      const bf16* wrow = P.wt + T.wt[row];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < HID / 8; ++j) {
        const int col = 8 * j + 2 * q4;
        const float2 bb = *reinterpret_cast<const float2*>(bias + col);
        const float2 wv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(wrow + col));
        s += fmaxf(acc[4 * j + 2 * h] + bb.x, 0.f) * wv.x +
             fmaxf(acc[4 * j + 2 * h + 1] + bb.y, 0.f) * wv.y;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int si = g0 + row / PIX;
      if (q4 == 0 && si < NS)  // ck is (9, M): its index is R.wt's row
        T.logit[si * PIX + row % PIX] =
            T.q[row] >= 0 ? s + P.ck[T.wt[row] / HID] : 0.f;
    }
  }

  // ---- softmax over the shifts
  bar_sync(BAR_ALL, 256);
  if (tid < PIX) {
    float mx = -INFINITY;
    for (int i = 0; i < NS; ++i)
      mx = fmaxf(mx, T.logit[i * PIX + tid] * P.inv_softmax_scale);
    float den = 0.f;
    for (int i = 0; i < NS; ++i) {
      const float e = __expf(T.logit[i * PIX + tid] * P.inv_softmax_scale - mx);
      T.attn[i * PIX + tid] = e;
      den += e;
    }
    for (int i = 0; i < NS; ++i) T.attn[i * PIX + tid] /= den;
  }
  bar_sync(BAR_ALL, 256);

  // ---- v-paths, blended chunk by chunk into imnet_q's first layer
#pragma unroll
  for (int i = 0; i < 64; ++i) qacc[i] = 0.f;
  for (int g0 = 0; g0 < NS; g0 += SG) {
    setup_rows(g0);
    first_layer(P.gv, P.vrel, P.vb0);
    hidden(acc, P.vb, act, wg, ring, full, empty, it);
    bar_sync(bar_wg, 128);
    epi_act(acc, P.vb + 2 * HID, act, wg);
    fence_proxy_async();
    bar_sync(bar_wg, 128);
    // this thread's two rows row0 + 8 h: shift si, pixels pix0 + 8 h
    const int row0 = 64 * wg + 16 * w4 + (lane >> 2);
    const int pix0 = row0 % PIX;
    const int si = g0 + row0 / PIX;
    for (int n0 = 0; n0 < DV; n0 += VCH) {
      const int nc = min(VCH, DV - n0);
      gemm<128, false>(accv, act_wg, ACT_SLAB, 4, ring, 0, full, empty, it);
      // acc = attn * bf16(x (.) (acc + b_vout)), x from the 3 x 3 taps of
      // the feature at q (at one tap the feature at q itself; or csa[q]);
      // 0 for rows without a pixel. A 64-column slab lies in one tap (C is
      // a multiple of 64), so one row pointer serves it.
#pragma unroll
      for (int sl = 0; sl < VCH / 64; ++sl) {
        const int c0 = n0 + 64 * sl;
        if (64 * sl < nc) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = T.q[row0 + 8 * h];
            const float a = si < NS ? T.attn[si * PIX + pix0 + 8 * h] : 0.f;
            const bf16* xs = nullptr;
            if (q >= 0 && c0 >= DK) {
              xs = P.csa + (size_t)q * DC + (c0 - DK);
            } else if (q >= 0) {
              const int tap = TAPS == 9 ? c0 / C : 4;
              const int dy = tap / 3 - 1, dx = tap % 3 - 1;
              const int yy = T.qy[row0 + 8 * h] + dy;
              const int xx = T.qx[row0 + 8 * h] + dx;
              if (yy >= 0 && yy < H && xx >= 0 && xx < W)
                xs = P.feat + (size_t)(q + dy * W + dx) * C + c0 % C;
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = 8 * sl + jj, col = 8 * jj + 2 * q4;
              const float2 bb =
                  *reinterpret_cast<const float2*>(P.vbout + c0 + col);
              const float2 x =
                  xs ? __bfloat1622float2(
                           *reinterpret_cast<const __nv_bfloat162*>(xs + col))
                     : make_float2(0.f, 0.f);
              accv[4 * j + 2 * h] =
                  a * bfround(x.x * (accv[4 * j + 2 * h] + bb.x));
              accv[4 * j + 2 * h + 1] =
                  a * bfround(x.y * (accv[4 * j + 2 * h + 1] + bb.y));
            }
          }
        }
      }
      // outv = shift 0 + shift 1 + shift 2 + shift 3, in that order; the
      // last adds round to bf16 into qin
      if (wg == 0) {
        if (w4 < 2) blend(accv, 0, nc, pix0, outv, qin);
        bar_sync(bar_wg, 128);
        if (w4 >= 2) blend(accv, 1, nc, pix0, outv, qin);
        bar_sync(BAR_ALL, 256);
        bar_sync(BAR_ALL, 256);  // warpgroup 1 has written qin
      } else {
        bar_sync(BAR_ALL, 256);  // shifts 0 and 1 are in outv
        if (w4 < 2) blend(accv, 1, nc, pix0, outv, qin);
        bar_sync(bar_wg, 128);
        if (w4 >= 2) blend(accv, 2, nc, pix0, outv, qin);
        fence_proxy_async();
        bar_sync(BAR_ALL, 256);
      }
      // qacc (+)= bf16(outv chunk) @ W_q0[chunk, 128 wg .. 128 wg + 127]
      gemm<128, true>(qacc, qin, QIN_SLAB, nc / 64, ring, wg * 2 * SLAB,
                      full, empty, it);
    }
  }

  // ---- imnet_q on the 32 real rows: relu(qacc + b0), three hidden
  // layers, each warpgroup 128 columns of every layer
  bar_sync(BAR_ALL, 256);  // every product has read act
  epi_q(qacc, P.qb0, act, wg);
  fence_proxy_async();
  bar_sync(BAR_ALL, 256);
  for (int l = 0; l < 2; ++l) {
    gemm<128, false>(qacc, act, ACT_SLAB, 4, ring, wg * 2 * SLAB, full,
                     empty, it);
    bar_sync(BAR_ALL, 256);
    epi_q(qacc, P.qb + l * HID, act, wg);
    fence_proxy_async();
    bar_sync(BAR_ALL, 256);
  }
  gemm<128, false>(qacc, act, ACT_SLAB, 4, ring, wg * 2 * SLAB, full, empty,
                   it);
  // 256 -> 3 from registers: h = bf16(relu(acc + b)) of this thread's
  // columns, a quad's sum, then the two warpgroups' halves in order
  if (w4 < 2) {
    const float* bias = P.qb + 2 * HID;
    float s[2][3] = {};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 128 * wg + 8 * j + 2 * q4;
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float h0 = bfround(fmaxf(qacc[4 * j + 2 * h] + bb.x, 0.f));
        const float h1 = bfround(fmaxf(qacc[4 * j + 2 * h + 1] + bb.y, 0.f));
#pragma unroll
        for (int o = 0; o < 3; ++o)
          s[h][o] += h0 * P.qwout[o * HID + col] +
                     h1 * P.qwout[o * HID + col + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        float v = s[h][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q4 == 0)
          T.part[wg][16 * w4 + (lane >> 2) + 8 * h][o] = v;
      }
  }
  bar_sync(BAR_ALL, 256);
  if (tid < PIX && T.row_p[tid] >= 0) {
    float* dst = P.out + ((((size_t)T.row_b[tid] * P.n_phase + ph) * H +
                           T.row_y[tid]) * W + T.row_x[tid]) * 3;
#pragma unroll
    for (int o = 0; o < 3; ++o)
      dst[o] = T.part[0][tid][o] + T.part[1][tid][o] + P.qbout[o];
  }
}

template <int C, int DC, int TAPS>
__global__ void __launch_bounds__(THREADS, 1)
decode_sm90(const __grid_constant__ Maps maps, const Params P) {
  constexpr int DV = TAPS * C + DC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + OFF_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  __shared__ Tables T;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = P.H, W = P.W, M = P.M, NS = P.n_shift;
  // the n_phase phases of a pixel block are neighbours in launch order,
  // so they share its gathered rows in L2
  const int ph = blockIdx.x % P.n_phase;
  const int p0 = (blockIdx.x / P.n_phase) * PIX;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  if (tid < PIX) {
    const int p = p0 + tid;
    const bool ok = p < M;
    T.row_p[tid] = ok ? p : -1;
    T.row_x[tid] = ok ? p % W : 0;
    T.row_y[tid] = ok ? (p / W) % H : 0;
    T.row_b[tid] = ok ? p / (W * H) : 0;
  }
  __syncthreads();

  // one big if-else: the producer warpgroup gives registers to the
  // consumers, and one of its threads issues every copy
  if (warp >= CONSUMERS * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == CONSUMERS * 4 && lane == 0) {
      int it = 0;
      for (int g0 = 0; g0 < NS; g0 += SG)
        for (int l = 0; l < 3; ++l)
          for (int kc = 0; kc < 4; ++kc)
            load_stage(&maps.kw, 0, l * HID + kc * KC, 4, ring, full, empty,
                       it);
      for (int g0 = 0; g0 < NS; g0 += SG) {
        for (int l = 0; l < 3; ++l)
          for (int kc = 0; kc < 4; ++kc)
            load_stage(&maps.vw, 0, l * HID + kc * KC, 4, ring, full, empty,
                       it);
        for (int n0 = 0; n0 < DV; n0 += VCH) {
          const int nsl = min(VCH, DV - n0) / 64;
          for (int kc = 0; kc < 4; ++kc)
            load_stage(&maps.vout, n0, kc * KC, nsl, ring, full, empty, it);
          for (int kc = 0; kc < nsl; ++kc)
            load_stage(&maps.qw0, 0, n0 + kc * KC, 4, ring, full, empty, it);
        }
      }
      for (int l = 0; l < 3; ++l)
        for (int kc = 0; kc < 4; ++kc)
          load_stage(&maps.qw, 0, l * HID + kc * KC, 4, ring, full, empty,
                     it);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<C, DC, TAPS>(P, smem, T, ph);
  }
}

// a row-major (rows, cols) bf16 matrix as (cols, rows) in 64 x 64 boxes
int map_matrix(CUtensorMap* m, const void* p, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, KC};
  return tmap_encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, dims, strides,
                     box);
}

template <int C, int DC, int TAPS>
int launch(void* const* ptrs, int B, int H, int W, int n_phase, int n_shift,
           float softmax_scale, void* stream) {
  constexpr int DV = TAPS * C + DC;
  static cudaError_t attr = allow_smem(decode_sm90<C, DC, TAPS>, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // the host's limit: 9 shifts (local_size 3) at the flagship width only
  if (n_shift < 1 || n_shift > (C == 64 ? MAX_SHIFT : SG) || n_phase < 1)
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.feat = (const bf16*)ptrs[0];
  P.csa = (const bf16*)ptrs[1];
  P.gk = (const bf16*)ptrs[2];
  P.gv = (const bf16*)ptrs[3];
  P.wt = (const bf16*)ptrs[4];
  P.ck = (const float*)ptrs[5];
  const void *kw = ptrs[6], *vw = ptrs[7], *vout = ptrs[8], *qw0 = ptrs[9],
             *qw = ptrs[10];
  P.kb = (const float*)ptrs[11];
  P.vb = (const float*)ptrs[12];
  P.vbout = (const float*)ptrs[13];
  P.qb0 = (const float*)ptrs[14];
  P.qb = (const float*)ptrs[15];
  P.krel = (const float*)ptrs[16];
  P.kb0 = (const float*)ptrs[17];
  P.vrel = (const float*)ptrs[18];
  P.vb0 = (const float*)ptrs[19];
  P.qwout = (const float*)ptrs[20];
  P.qbout = (const float*)ptrs[21];
  P.dys = (const int*)ptrs[22];
  P.dxs = (const int*)ptrs[23];
  P.rely = (const float*)ptrs[24];
  P.relx = (const float*)ptrs[25];
  P.out = (float*)ptrs[26];
  P.H = H;
  P.W = W;
  P.M = B * H * W;
  P.n_phase = n_phase;
  P.n_shift = n_shift;
  P.inv_softmax_scale = 1.f / softmax_scale;
  Maps m;
  int err = map_matrix(&m.kw, kw, 3 * HID, HID);
  if (!err) err = map_matrix(&m.vw, vw, 3 * HID, HID);
  if (!err) err = map_matrix(&m.qw, qw, 3 * HID, HID);
  if (!err) err = map_matrix(&m.vout, vout, HID, DV);
  if (!err) err = map_matrix(&m.qw0, qw0, DV, HID);
  if (err) return err;
  const long long blocks = (long long)((P.M + PIX - 1) / PIX) * n_phase;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decode_sm90<C, DC, TAPS><<<(unsigned)blocks, THREADS, SMEM,
                             (cudaStream_t)stream>>>(m, P);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: feat, csa, gk, gv, wt, ck, kw, vw, vout, qw0, qw, kb, vb, vbout,
// qb0, qb, krel, kb0, vrel, vb0, qwout, qbout, dys, dxs, rely, relx, out
extern "C" int grid_decode(void* const* ptrs, int B, int H, int W, int C,
                           int DC, int taps, int n_phase, int n_shift,
                           float softmax_scale, void* stream) {
  if (C == 64 && DC == 64 && taps == 9)
    return launch<64, 64, 9>(ptrs, B, H, W, n_phase, n_shift, softmax_scale,
                             stream);
  if (C == 192 && DC == 0 && taps == 9)
    return launch<192, 0, 9>(ptrs, B, H, W, n_phase, n_shift, softmax_scale,
                             stream);
  if (C == 192 && DC == 192 && taps == 9)
    return launch<192, 192, 9>(ptrs, B, H, W, n_phase, n_shift,
                               softmax_scale, stream);
  if (C == 64 && DC == 64 && taps == 1)
    return launch<64, 64, 1>(ptrs, B, H, W, n_phase, n_shift, softmax_scale,
                             stream);
  return (int)cudaErrorInvalidValue;
}
