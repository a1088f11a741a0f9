// The paste of row 8 of the kernel table, csa_attention_overlap_add: the
// (3s, 3s) stride-s overlap-add of per-pixel kernels that lie in the
// plane-major column order. Row 8 is row 7's flagship kernel
// (csa_flash.cu::csa_attention) on the plane-major value bank v_pm, which
// writes k_pm (B, P, 2304) f32, then this kernel.
//
// Replaces the paste of ciaosr_tpu/ops/pallas/csa_attention.py::
// csa_attention_overlap_add (_attn_oa_kernel's jblk column masks and the
// strip halos that _combine_strips adds): with P = Hp * Wp query pixels
// and k_pm's columns in nine tap planes (t, r) of s^2 C = 256, each
// (a, b, c),
//   out[b, s y + a, s x + be, c] = sum over (t, r) = (0, 0) .. (2, 2) of
//     k_pm[b, (y - t + 1) Wp + (x - r + 1), ((3t + r) s + a) s C + be C + c]
// over the sources with 0 <= y - t + 1 < Hp and 0 <= x - r + 1 < Wp, into
// (B, s Hp, s Wp, C) f32 (s = 2, C = 64). That is
// ciaosr_tpu/models/csa.py::_overlap_add of the tap-major columns.
//
// Bound on the H100: bytes. It reads each value of k_pm once (47.8 MB at
// 72 x 72) and writes the output once (5.3 MB): 0.016 ms at 3.35 TB/s;
// 2304 / 256 = 9 additions a pasted value are nothing beside that.
//
// Design. One thread owns four output channels (a float4) of one output
// pixel and adds its up-to-nine sources in the fixed order above, from
// 0, and stores the sum once: no atomic, no zeroing of the output, and
// two launches give the same bits. Threads run along the channels, then
// the output columns, so a warp's loads for one (t, r) are the 128
// contiguous floats (be = 0, 1; all c) of one source pixel's plane row.
// Every value of k_pm feeds exactly one output element (or none, off the
// grid), so k_pm is read once, coalesced, and the output written once.
#include "common.cuh"

namespace {

constexpr int S = 2, C = 64;
constexpr int DV = 9 * S * S * C;  // 2304 columns of k_pm
constexpr int V4 = C / 4;          // float4 vectors an output pixel
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    paste_kernel(const float* __restrict__ k_pm, float* __restrict__ out,
                 int Hp, int Wp, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int v = (int)(i % V4);
  long long rest = i / V4;
  const int ox = (int)(rest % (S * Wp));
  rest /= S * Wp;
  const int oy = (int)(rest % (S * Hp));
  const int b = (int)(rest / (S * Hp));
  const int y = oy / S, a = oy % S, x = ox / S, be = ox % S;
  const float4* src = reinterpret_cast<const float4*>(k_pm);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int ys = y - t + 1;
    if (ys < 0 || ys >= Hp) continue;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int xs = x - r + 1;
      if (xs < 0 || xs >= Wp) continue;
      const size_t col = (size_t)((3 * t + r) * S + a) * S * C + be * C;
      const float4 w = __ldg(
          src + (((size_t)b * Hp + ys) * Wp + xs) * (DV / 4) + col / 4 + v);
      acc.x += w.x;
      acc.y += w.y;
      acc.z += w.z;
      acc.w += w.w;
    }
  }
  reinterpret_cast<float4*>(out)[i] = acc;
}

}  // namespace

// k_pm (B, Hp*Wp, 2304) f32, plane-major -> out (B, 2Hp, 2Wp, 64) f32,
// every element written
extern "C" int plane_overlap_add(const void* k_pm, void* out, int B, int Hp,
                                 int Wp, void* stream) {
  if (B <= 0 || Hp <= 0 || Wp <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * S * Hp * S * Wp * V4;
  paste_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>((const float*)k_pm, (float*)out,
                                         Hp, Wp, n);
  return (int)cudaGetLastError();
}
