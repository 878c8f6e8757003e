// The forward body shared by the DCN sources of the explicit-offset layer
// (dcn_fwd.cu, dcn_sel_fwd.cu, dcn_wide_fwd.cu). The fused bfloat16 layer's
// forward has its own, in dcn_fused.cuh and dcn_fused_fwd.cu, and every
// backward runs the tensor-core sampling kernels of dcn_sample_bwd.cuh. The
// body is a template over the geometry layout (`OffsetMask`,
// dcn_common.cuh), the output type, `kClampDx` (the wide forward's
// horizontal clamp) and a tag that only names the instantiation (`Select`
// for dcn_sel_fwd.cu). Each source notes what bounds its kernel.
//
// dcn_fwd_kernel: one block per (image, tile of 64 output pixels, tile of
//   64 output channels), looping over the 9 taps and over Cin in chunks of
//   32. Each chunk is sampled into shared memory (x is read channels-last,
//   so a corner is a contiguous run of channels), rounded to bf16, and
//   contracted with the bf16 W chunk by FMAs into a 4x4 f32 register tile
//   per thread. The bias is added in f32 before the output is stored.
#pragma once

#include "dcn_common.cuh"

namespace dcn {

constexpr int kPix = 64;  // output pixels per block
constexpr int kCo = 64;   // output channels per block
constexpr int kCk = 32;   // input channels per staged chunk

template <typename Geom, typename OutT, bool kClampDx = false,
          typename Tag = void>
__global__ void __launch_bounds__(kThreads)
    dcn_fwd_kernel(const __nv_bfloat16* __restrict__ x, const Geom geom,
                   const __nv_bfloat16* __restrict__ wt,  // (9, Cin, Cout)
                   const float* __restrict__ bias,        // (Cout)
                   OutT* __restrict__ out,                // (B, Cout, H, W)
                   int H, int W, int Cin, int Cout, float max_shift) {
  __shared__ float s_col[kCk][kPix + 1];  // sampled chunk, [channel][pixel]
  __shared__ float s_w[kCk][kCo];         // W[t] chunk, [channel][cout]
  __shared__ int s_idx[4][kPix];
  __shared__ float s_cw[4][kPix];  // corner weight with the mask folded in

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kPix;
  const int co0 = blockIdx.y * kCo;
  const int HW = H * W;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    __syncthreads();  // the previous tap's sampling has read s_idx/s_cw
    if (tid < kPix) {
      const int p = p0 + tid;
      if (p < HW) {
        const Sample s = sample_at<Geom, kClampDx>(geom, b, t, p / W, p % W,
                                                   H, W, max_shift);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = s.idx[k];
          s_cw[k][tid] = s.m * s.c[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = -1;
          s_cw[k][tid] = 0.f;
        }
      }
    }
    for (int c0 = 0; c0 < Cin; c0 += kCk) {
      __syncthreads();  // s_idx is written; the last chunk's FMAs are done
      {
        const int cc = tid & (kCk - 1);
        const int c = c0 + cc;
        for (int pp = tid / kCk; pp < kPix; pp += kThreads / kCk) {
          float v = 0.f;
          if (c < Cin) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int i = s_idx[k][pp];
              if (i >= 0) v += s_cw[k][pp] * bf16_load(xb + (size_t)i * Cin + c);
            }
          }
          s_col[cc][pp] = bf16_round(v);
        }
      }
      for (int e = tid; e < kCk * kCo; e += kThreads) {
        const int cc = e / kCo;
        const int oo = e % kCo;
        float v = 0.f;
        if (c0 + cc < Cin && co0 + oo < Cout)
          v = bf16_load(wt + ((size_t)t * Cin + c0 + cc) * Cout + co0 + oo);
        s_w[cc][oo] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kCk; ++cc) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_col[cc][tx + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = s_w[cc][ty + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + ty + 16 * j;
    if (co >= Cout) continue;
    const float bv = bias[co];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + tx + 16 * i;
      if (p < HW) store(out + ((size_t)b * Cout + co) * HW + p, acc[i][j] + bv);
    }
  }
}

}  // namespace dcn
