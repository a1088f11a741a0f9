// K3's rational mode: the dense-grid decoder at rational scales.
//
// Replaces ciaosr_tpu/ops/pallas/decoder_kernel.py::grid_decode_fused_rational
// (kernel _decode_kernel_halo in its rational mode). The integer mode,
// K3 itself, runs on csrc/grid_decode_sm90.cu (wgmma and TMA). For each
// output pixel p of a phase image, HR phase ph and local-ensemble shift i,
// the tables
// give the query pixel and the key pixel q (within one pixel of it) with
// its rel terms; then, with (dy, dx) = q - query:
//   h_k = MLP_k hidden layers of relu(g_k[q] + rely*w_ry + relx*w_rx + b0)
//   logit_i = wt_{dy,dx}[query] . h_k + ck_{dy,dx}[query]
//   h_v = MLP_v hidden layers of relu(g_v[q] + rel terms + b0)
//   pred_i = [u[q] | csa[q]] (.) (h_v @ W_vout + b_vout)        (640 wide)
// then softmax_i(logit_i / softmax_scale), outv = sum_i attn_i pred_i, and
// rgb = imnet_q(outv). Output: (B, py * px, OH, OW, 3) f32 phase images
// before the bilinear residual. b0 has the cell terms folded in (host side).
//
// Casts follow the TPU kernel so the result stays within bf16 tolerance
// of the f32 plain version: h is rounded to bf16 before every matmul,
// h_k stays f32 for the logit, pred is rounded to bf16 before the blend
// (decoder_kernel.py:930-933), the blend and the softmax are f32.
//
// Bound on the H100 at x2.5 on a 192 x 192 tile (25 phases of 96 x 96):
// 1.2 ms at the bf16 dense peak; it is compute-bound (the gathered inputs
// are L2-resident and the output is small).
// Design: a block decodes 32 pixels of one phase. Like the TPU kernel, it
// stacks the 4 shifts along the rows, so every k/v MLP layer is one
// 128 x 256 x 256 product: each weight tile is fetched once per 128 rows.
// Weight tiles (32 k-rows x 256) are staged in shared memory with
// cp.async, double-buffered, and shared by the 8 warps; each warp keeps a
// 64 x 64 f32 accumulator tile in registers (wmma bf16, f32 accumulate),
// so a layer's output overwrites its input in place. All four k-paths
// run first, so the four logits (and the softmax) are known before any
// value is blended; the v-paths then add attn_i * pred_i into an f32
// 32 x 640 accumulator in shared memory (80 KB). u is rebuilt from the
// raw feature (3x3 taps at q) where the value modulation needs it, so the
// 9C unfold never exists in memory. Any H and W; up to 9 shifts, taken
// 4 at a time.
//
// Widths: compiled for (C, DC) = (64, 64), the flagship (DV = 640), and
// (192, 0), SwinIR-CiaoSR's 180 channels zero-padded, without CSA
// (DV = 1728). At DV = 1728 the 32 x DV f32 value accumulator (221 KB)
// does not fit in shared memory, so this "wide" instantiation blends the
// value 256 columns at a time: the blend is linear, so imnet_q's first
// layer is sum over chunks of bf16(sum_i attn_i pred_i[:, chunk]) @
// W_q0[chunk, :]; each chunk's 32 x 256 blend (f32, rounded to bf16 as
// the flagship rounds the whole outv) is multiplied at once into a
// 32 x 256 f32 sum in shared memory (196 KB in all). It needs every
// shift's hidden rows at once, so it takes at most 4 shifts (one group:
// local_size 1 or 2), checked on the host. Bound at C = 180 on a 256 x 256
// map at x2.5: 3.2 ms.
#include "common.cuh"

namespace {

constexpr int HID = 256;
constexpr int PIX = 32;          // pixels per block
constexpr int SG = 4;            // shifts stacked per product
constexpr int ROWS = PIX * SG;   // 128 rows per k/v product
constexpr int MAX_SHIFT = 9;
constexpr int LDA = HID + 8;     // 264: activation row stride (128 rows)
constexpr int KC = 32;           // k-rows per staged weight tile
constexpr int LDW = HID + 8;     // 264
constexpr int THREADS = 256;
constexpr int OFF_W = ROWS * LDA * 2;  // act: 67584 B

// Shared-memory layout of the (C, DC) instantiation. After the act block
// and the weight ring (33792 B): the f32 value accumulator outv (PIX x DV;
// wide: one 32 x 256 chunk of it), in the wide one also the f32 imnet_q
// sum qacc (32 x 256) and its bf16 chunk input qin (32 x 264); then the
// warp scratch (8 KB), the logit partials (2 KB), logits and softmax.
template <int C, int DC>
struct Lay {
  static constexpr int DK = 9 * C, DV = DK + DC;
  static constexpr bool WIDE = PIX * DV * 4 > 96 * 1024;
  static constexpr int LDQ = DV + 16;  // narrow: imnet_q input row stride
  static constexpr int OFF_OUTV = OFF_W + 2 * KC * LDW * 2;
  static constexpr int OFF_QACC = OFF_OUTV + PIX * (WIDE ? HID : DV) * 4;
  static constexpr int OFF_QIN = OFF_QACC + (WIDE ? PIX * HID * 4 : 0);
  static constexpr int OFF_SCR = OFF_QIN + (WIDE ? PIX * LDA * 2 : 0);
  static constexpr int OFF_PART = OFF_SCR + 8 * 256 * 4;
  static constexpr int OFF_LOG = OFF_PART + ROWS * 4 * 4;
  static constexpr int SMEM = OFF_LOG + 2 * MAX_SHIFT * PIX * 4;
  static_assert(WIDE || PIX * LDQ * 2 <= OFF_W,
                "imnet_q input must fit in act");
  static_assert(DV % 8 == 0 && (DV % HID) % KC == 0, "DV chunks");
};

struct Params {
  const bf16 *feat, *csa, *gk, *gv, *wt;
  const float* ck;
  const bf16 *kw, *vw, *vout, *qw0, *qw;   // bf16 (in x out); kw/vw/qw (3,256,256)
  const float *kb, *vb, *vbout, *qb0, *qb;  // f32 biases
  const float *krel, *kb0, *vrel, *vb0;     // first-layer rel rows, bias
  const float *qwout, *qbout;               // (3, 256) and (3,)
  // (py, OH) and (px, OW) query, (py, n_shift, OH) and (px, n_shift, OW)
  // key indices
  const int *yq, *yk, *xq, *xk;
  const float *rely, *relx;                 // (py / px, n_shift, OH / OW)
  float* out;
  int H, W, M, n_phase, n_shift;
  int OH, OW, MO, px;  // phase image rows, columns, pixels; phase columns
  float inv_softmax_scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// k-rows [k0, k0 + KC) x columns [n0, n0 + ncols) of w into a ring slot
__device__ __forceinline__ void stage_w(const bf16* w, int ldw, int k0,
                                        int n0, int ncols, bf16* dst) {
  const int vpr = ncols / 8;
  for (int idx = threadIdx.x; idx < KC * vpr; idx += THREADS) {
    const int r = idx / vpr, v = idx % vpr;
    cp_async16(dst + r * LDW + v * 8, w + (size_t)(k0 + r) * ldw + n0 + v * 8);
  }
}

// acc = act[rows x K] @ w[K x ldw][:, n0 : n0 + ncols]. Warp w owns the
// RF x CF fragment tile at row (w / WC) * 16RF, column (w % WC) * 16CF of
// the pass; warps whose columns lie past ncols idle (but keep the
// barriers). Ends with a barrier: act may be overwritten afterwards.
template <int RF, int CF, int WC>
__device__ void gemm(const bf16* act, int lda, int K, const bf16* w, int ldw,
                     int n0, int ncols, bf16* ring, FragC (&acc)[RF][CF]) {
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp / WC) * RF * 16, col0 = (warp % WC) * CF * 16;
  const bool active = col0 < ncols;
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < CF; ++j) wm::fill_fragment(acc[i][j], 0.f);
  const int nch = K / KC;
  stage_w(w, ldw, 0, n0, ncols, ring);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch)
      stage_w(w, ldw, (c + 1) * KC, n0, ncols, ring + ((c + 1) & 1) * KC * LDW);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (active) {
      const bf16* wb = ring + (c & 1) * KC * LDW;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        FragB fb[CF];
#pragma unroll
        for (int j = 0; j < CF; ++j)
          wm::load_matrix_sync(fb[j], wb + kk * LDW + col0 + 16 * j, LDW);
#pragma unroll
        for (int i = 0; i < RF; ++i) {
          FragA fa;
          wm::load_matrix_sync(fa, act + (row0 + 16 * i) * lda + c * KC + kk,
                               lda);
#pragma unroll
          for (int j = 0; j < CF; ++j) wm::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

// act[:, cols] = bf16(relu(acc + bias)), in place of the product's input
template <int RF, int CF, int WC>
__device__ void epi_hidden(FragC (&acc)[RF][CF], float* scr,
                           const float* bias, bf16* act, int lda) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp / WC) * RF * 16, col0 = (warp % WC) * CF * 16;
  float* ws = scr + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < CF; ++j) {
      wm::store_matrix_sync(ws, acc[i][j], 16, wm::mem_row_major);
      __syncwarp();
      const int col = col0 + 16 * j + c;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = f2bf(fmaxf(ws[r * 16 + c + e] + bias[col + e], 0.f));
      st8(act + (row0 + 16 * i + r) * lda + col, *reinterpret_cast<uint4*>(v));
      __syncwarp();
    }
}

// query and key pixels, and their rel terms, from the rational tables
template <int C, int DC>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params P) {
  using L = Lay<C, DC>;
  constexpr int DK = L::DK, DV = L::DV;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + OFF_W);
  float* outv = reinterpret_cast<float*>(smem + L::OFF_OUTV);
  float* qacc = reinterpret_cast<float*>(smem + L::OFF_QACC);  // wide only
  bf16* qin = reinterpret_cast<bf16*>(smem + L::OFF_QIN);      // wide only
  float* scr = reinterpret_cast<float*>(smem + L::OFF_SCR);
  float* part = reinterpret_cast<float*>(smem + L::OFF_PART);  // [ROWS][4]
  float* logit = reinterpret_cast<float*>(smem + L::OFF_LOG);  // [shift][PIX]
  float* attn = logit + MAX_SHIFT * PIX;
  __shared__ int row_p[PIX], row_b[PIX], row_y[PIX], row_x[PIX];
  __shared__ int r_q[ROWS], r_qy[ROWS], r_qx[ROWS];
  __shared__ size_t r_wt[ROWS];
  __shared__ int row_q[PIX];                // LR query pixel
  __shared__ float r_ry[ROWS], r_rx[ROWS];  // rel of each row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * PIX;
  const int ph = blockIdx.y;
  const int H = P.H, W = P.W, M = P.M, NS = P.n_shift;
  // output pixels p enumerate (b, row, col) of one phase image
  const int OH = P.OH, OW = P.OW, MO = P.MO;
  const int pa = ph / P.px, pb = ph % P.px;
  FragC acc[4][4];

  if (tid < PIX) {
    const int p = p0 + tid;
    const bool ok = p < MO;
    row_p[tid] = ok ? p : -1;
    row_x[tid] = ok ? p % OW : 0;
    row_y[tid] = ok ? (p / OW) % OH : 0;
    row_b[tid] = ok ? p / (OW * OH) : 0;
    row_q[tid] = (row_b[tid] * H + P.yq[pa * OH + row_y[tid]]) * W +
                 P.xq[pb * OW + row_x[tid]];
  }
  __syncthreads();

  // rows of a shift group: row = si * PIX + pixel, shift g0 + si
  auto setup_rows = [&](int g0) {
    if (tid < ROWS) {
      const int si = tid / PIX, pix = tid % PIX, s = g0 + si;
      const bool ok = s < NS && row_p[pix] >= 0;
      // key and query pixels from the tables; d = key - query
      const int sy = (pa * NS + (s < NS ? s : 0)) * OH + row_y[pix];
      const int sx = (pb * NS + (s < NS ? s : 0)) * OW + row_x[pix];
      const int qy = P.yk[sy], qx = P.xk[sx];
      const int dy = qy - P.yq[pa * OH + row_y[pix]];
      const int dx = qx - P.xq[pb * OW + row_x[pix]];
      const int query = row_q[pix];
      r_ry[tid] = P.rely[sy];
      r_rx[tid] = P.relx[sx];
      r_q[tid] = ok ? (row_b[pix] * H + qy) * W + qx : -1;
      r_qy[tid] = qy;
      r_qx[tid] = qx;
      // row of the wt plane (and of ck) for this shift at the query pixel
      r_wt[tid] = ((size_t)((dy + 1) * 3 + (dx + 1)) * M +
                   (ok ? query : 0)) * HID;
    }
    __syncthreads();
  };
  // relu(g[q] + rely*w_ry + relx*w_rx + b0) -> act (bf16)
  auto first_layer = [&](const bf16* g, const float* rel, const float* b0) {
    for (int idx = tid; idx < ROWS * HID; idx += THREADS) {
      const int r = idx / HID, j = idx % HID;
      float v = 0.f;
      if (r_q[r] >= 0) {
        v = fmaxf(bf2f(g[(size_t)r_q[r] * HID + j]) + r_ry[r] * rel[j] +
                      r_rx[r] * rel[HID + j] + b0[j], 0.f);
      }
      act[r * LDA + j] = f2bf(v);
    }
    __syncthreads();
  };
  auto hidden = [&](const bf16* w, const float* b, int n_layers) {
    for (int l = 0; l < n_layers; ++l) {
      gemm<4, 4, 4>(act, LDA, HID, w + (size_t)l * HID * HID, HID, 0, HID,
                    ring, acc);
      epi_hidden<4, 4, 4>(acc, scr, b + l * HID, act, LDA);
      __syncthreads();
    }
  };

  // ---- k-paths: one logit per (pixel, shift)
  for (int g0 = 0; g0 < NS; g0 += SG) {
    setup_rows(g0);
    first_layer(P.gk, P.krel, P.kb0);
    hidden(P.kw, P.kb, 2);
    gemm<4, 4, 4>(act, LDA, HID, P.kw + (size_t)2 * HID * HID, HID, 0, HID,
                  ring, acc);
    {  // last hidden layer: h_k stays f32; partial wt . h_k per 64 columns
      const int row0 = (warp / 4) * 64, col0 = (warp % 4) * 64;
      float* ws = scr + warp * 256;
      const int r = lane >> 1, c = (lane & 1) * 8;
      const float* bias = P.kb + 2 * HID;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 16 * i + r;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wm::store_matrix_sync(ws, acc[i][j], 16, wm::mem_row_major);
          __syncwarp();
          if (r_q[row] >= 0) {
            const int col = col0 + 16 * j + c;
            __align__(16) bf16 wv[8];
            *reinterpret_cast<uint4*>(wv) = ld8(P.wt + r_wt[row] + col);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              s += fmaxf(ws[r * 16 + c + e] + bias[col + e], 0.f) * bf2f(wv[e]);
          }
          __syncwarp();
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if ((lane & 1) == 0) part[row * 4 + warp % 4] = s;
      }
    }
    __syncthreads();
    if (tid < ROWS) {
      const int si = tid / PIX, pix = tid % PIX;
      if (g0 + si < NS) {
        float v = 0.f;
        if (r_q[tid] >= 0)  // ck is (9, M): its index is r_wt's row
          v = part[tid * 4] + part[tid * 4 + 1] + part[tid * 4 + 2] +
              part[tid * 4 + 3] + P.ck[r_wt[tid] / HID];
        logit[(g0 + si) * PIX + pix] = v;
      }
    }
    __syncthreads();
  }

  // ---- softmax over the shifts
  if (tid < PIX) {
    float mx = -INFINITY;
    for (int i = 0; i < NS; ++i)
      mx = fmaxf(mx, logit[i * PIX + tid] * P.inv_softmax_scale);
    float den = 0.f;
    for (int i = 0; i < NS; ++i) {
      const float e = __expf(logit[i * PIX + tid] * P.inv_softmax_scale - mx);
      attn[i * PIX + tid] = e;
      den += e;
    }
    for (int i = 0; i < NS; ++i) attn[i * PIX + tid] /= den;
  }
  if constexpr (!L::WIDE)
    for (int idx = tid; idx < PIX * DV; idx += THREADS) outv[idx] = 0.f;
  __syncthreads();

  // ---- v-paths: outv += attn_i * bf16([u | csa] (.) wv_i); wide: outv
  // holds one column chunk, ldo = 256, and goes into imnet_q at once
  constexpr int LDO = L::WIDE ? HID : DV;
  for (int g0 = 0; g0 < NS; g0 += SG) {
    setup_rows(g0);
    first_layer(P.gv, P.vrel, P.vb0);
    hidden(P.vw, P.vb, 3);
    for (int n0 = 0; n0 < DV; n0 += HID) {
      const int nc = min(HID, DV - n0);
      const int o0 = L::WIDE ? n0 : 0;  // outv column of value column n0
      if constexpr (L::WIDE)
        for (int idx = tid; idx < PIX * HID; idx += THREADS) outv[idx] = 0.f;
      gemm<4, 4, 4>(act, LDA, HID, P.vout, DV, n0, nc, ring, acc);
      const int wr = warp / 4, row0 = wr * 64, col0 = (warp % 4) * 64;
      float* ws = scr + warp * 256;
      const int r = lane >> 1, c = (lane & 1) * 8;
      // the two row halves (shifts 0-1, 2-3) add into the same outv
      // entries: one half after the other keeps the sum order fixed
      for (int half = 0; half < 2; ++half) {
        if (half == wr && col0 < nc) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wm::store_matrix_sync(ws, acc[i][j], 16, wm::mem_row_major);
              __syncwarp();
              const int row = row0 + 16 * i + r, pix = row % PIX;
              const int jg = n0 + col0 + 16 * j + c;
              if (r_q[row] >= 0) {
                __align__(16) bf16 xv[8];
                *reinterpret_cast<uint4*>(xv) = zero8();
                if (jg < DK) {
                  const int t = jg / C;
                  const int yy = r_qy[row] + t / 3 - 1, xx = r_qx[row] + t % 3 - 1;
                  if (yy >= 0 && yy < H && xx >= 0 && xx < W)
                    *reinterpret_cast<uint4*>(xv) = ld8(
                        P.feat + ((size_t)(row_b[pix] * H + yy) * W + xx) * C +
                        jg % C);
                } else {
                  *reinterpret_cast<uint4*>(xv) =
                      ld8(P.csa + (size_t)r_q[row] * DC + (jg - DK));
                }
                const float a = attn[(g0 + row / PIX) * PIX + pix];
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  outv[pix * LDO + jg - o0 + e] +=
                      a * bfround(bf2f(xv[e]) * (ws[r * 16 + c + e] + P.vbout[jg + e]));
              }
              __syncwarp();
            }
        }
        __syncthreads();
      }
      if constexpr (L::WIDE) {
        // this chunk's blend, rounded to bf16, times W_q0's rows of the
        // chunk, summed into qacc (warp w owns its columns [32w, 32w + 32))
        for (int idx = tid; idx < PIX * nc; idx += THREADS)
          qin[(idx / nc) * LDA + idx % nc] = f2bf(outv[(idx / nc) * HID + idx % nc]);
        __syncthreads();
        FragC accq[2][2];
        gemm<2, 2, 8>(qin, LDA, nc, P.qw0 + (size_t)n0 * HID, HID, 0, HID,
                      ring, accq);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* dst = qacc + 16 * i * HID + warp * 32 + 16 * j;
            if (n0 > 0) {
              FragC old;
              wm::load_matrix_sync(old, dst, HID, wm::mem_row_major);
#pragma unroll
              for (int t = 0; t < old.num_elements; ++t)
                accq[i][j].x[t] += old.x[t];
            }
            wm::store_matrix_sync(dst, accq[i][j], HID, wm::mem_row_major);
          }
      }
    }
  }

  // ---- imnet_q: DV -> 256, three 256 -> 256 hidden layers, 256 -> 3
  FragC accq[2][2];
  if constexpr (L::WIDE) {  // its first layer is summed in qacc already
    __syncthreads();
    for (int idx = tid; idx < PIX * HID; idx += THREADS)
      act[(idx / HID) * LDA + idx % HID] =
          f2bf(fmaxf(qacc[idx] + P.qb0[idx % HID], 0.f));
  } else {
    for (int idx = tid; idx < PIX * DV; idx += THREADS)
      act[(idx / DV) * L::LDQ + idx % DV] = f2bf(outv[idx]);
    __syncthreads();
    gemm<2, 2, 8>(act, L::LDQ, DV, P.qw0, HID, 0, HID, ring, accq);
    epi_hidden<2, 2, 8>(accq, scr, P.qb0, act, LDA);
  }
  __syncthreads();
  for (int l = 0; l < 3; ++l) {
    gemm<2, 2, 8>(act, LDA, HID, P.qw + (size_t)l * HID * HID, HID, 0, HID,
                  ring, accq);
    epi_hidden<2, 2, 8>(accq, scr, P.qb + l * HID, act, LDA);
    __syncthreads();
  }
  for (int rr = 0; rr < PIX / 8; ++rr) {
    const int r = warp * (PIX / 8) + rr;
    float s[3] = {0.f, 0.f, 0.f};
    for (int j = lane; j < HID; j += 32) {
      const float h = bf2f(act[r * LDA + j]);
#pragma unroll
      for (int o = 0; o < 3; ++o) s[o] += h * P.qwout[o * HID + j];
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) s[o] = warp_sum(s[o]);
    if (lane == 0 && row_p[r] >= 0) {
      float* dst = P.out + ((((size_t)row_b[r] * P.n_phase + ph) * OH +
                             row_y[r]) * OW + row_x[r]) * 3;
#pragma unroll
      for (int o = 0; o < 3; ++o) dst[o] = s[o] + P.qbout[o];
    }
  }
}

// the 22 pointers the entry point takes first: feat, csa, gk, gv, wt, ck,
// kw, vw, vout, qw0, qw, kb, vb, vbout, qb0, qb, krel, kb0, vrel, vb0,
// qwout, qbout
Params common_params(void* const* ptrs, int B, int H, int W, int n_phase,
                     int n_shift, float softmax_scale) {
  Params P = {};
  int k = 0;
  P.feat = (const bf16*)ptrs[k++];
  P.csa = (const bf16*)ptrs[k++];
  P.gk = (const bf16*)ptrs[k++];
  P.gv = (const bf16*)ptrs[k++];
  P.wt = (const bf16*)ptrs[k++];
  P.ck = (const float*)ptrs[k++];
  P.kw = (const bf16*)ptrs[k++];
  P.vw = (const bf16*)ptrs[k++];
  P.vout = (const bf16*)ptrs[k++];
  P.qw0 = (const bf16*)ptrs[k++];
  P.qw = (const bf16*)ptrs[k++];
  P.kb = (const float*)ptrs[k++];
  P.vb = (const float*)ptrs[k++];
  P.vbout = (const float*)ptrs[k++];
  P.qb0 = (const float*)ptrs[k++];
  P.qb = (const float*)ptrs[k++];
  P.krel = (const float*)ptrs[k++];
  P.kb0 = (const float*)ptrs[k++];
  P.vrel = (const float*)ptrs[k++];
  P.vb0 = (const float*)ptrs[k++];
  P.qwout = (const float*)ptrs[k++];
  P.qbout = (const float*)ptrs[k++];
  P.H = H;
  P.W = W;
  P.M = B * H * W;
  P.n_phase = n_phase;
  P.n_shift = n_shift;
  P.inv_softmax_scale = 1.f / softmax_scale;
  return P;
}

template <int C, int DC>
int launch(const Params& P, dim3 grid, void* stream) {
  using L = Lay<C, DC>;
  static cudaError_t attr = allow_smem(decode_kernel<C, DC>, L::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (P.n_shift < 1 || P.n_shift > (L::WIDE ? SG : MAX_SHIFT))
    return (int)cudaErrorInvalidValue;
  decode_kernel<C, DC>
      <<<grid, THREADS, L::SMEM, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

int dispatch(int C, int DC, const Params& P, dim3 grid, void* stream) {
  if (C == 64 && DC == 64) return launch<64, 64>(P, grid, stream);
  if (C == 192 && DC == 0) return launch<192, 0>(P, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ptrs: the 22 common pointers, then yq, yk, xq, xk, rely, relx, out.
// Phases p = a * px + b, n_phase = py * px; out (B, n_phase, OH, OW, 3).
extern "C" int grid_decode_rational(void* const* ptrs, int B, int H, int W,
                                    int C, int DC, int OH, int OW, int py,
                                    int px, int n_shift, float softmax_scale,
                                    void* stream) {
  if (py < 1 || px < 1 || py * px > 65535) return (int)cudaErrorInvalidValue;
  Params P = common_params(ptrs, B, H, W, py * px, n_shift, softmax_scale);
  P.yq = (const int*)ptrs[22];
  P.yk = (const int*)ptrs[23];
  P.xq = (const int*)ptrs[24];
  P.xk = (const int*)ptrs[25];
  P.rely = (const float*)ptrs[26];
  P.relx = (const float*)ptrs[27];
  P.out = (float*)ptrs[28];
  P.OH = OH;
  P.OW = OW;
  P.MO = B * OH * OW;
  P.px = px;
  return dispatch(C, DC, P, dim3((P.MO + PIX - 1) / PIX, py * px),
                        stream);
}
