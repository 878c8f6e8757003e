// Kernel bodies shared by the DCN sources of the explicit-offset layer
// (dcn_fwd.cu, dcn_bwd.cu, dcn_sel_fwd.cu, dcn_sel_bwd.cu, dcn_wide_fwd.cu;
// the fused bfloat16 layer has its own, in dcn_fused.cuh and its two
// sources). The sampling kernels are templates over the geometry layout
// (`OffsetMask`, dcn_common.cuh) and over the types of g and of the output;
// the forward also over `kClampDx`, the wide forward's horizontal clamp.
// Each source notes what bounds its kernels and why they are built this
// way.
//
// dcn_fwd_kernel: one block per (image, tile of 64 output pixels, tile of
//   64 output channels), looping over the 9 taps and over Cin in chunks of
//   32. Each chunk is sampled into shared memory (x is read channels-last,
//   so a corner is a contiguous run of channels), rounded to bf16, and
//   contracted with the bf16 W chunk by FMAs into a 4x4 f32 register tile
//   per thread. The bias is added in f32 before the output is stored.
// dcn_bwd_data_kernel: one block per (image, tile of 64 output pixels),
//   looping over the 9 taps. Per tap it recomputes the sampling, forms
//   gcol_t = g . W_t^T (bf16 operands, f32 accumulation, rounded to bf16)
//   in shared memory, then per (pixel, channel):
//   - dx += m * corner weight * gcol by f32 atomicAdd into a zeroed
//     channels-last scratch (corners of weight 0 are skipped; they add 0);
//   - e_k += x_corner_k * gcol, the corner contraction, reduced over the
//     channels with warp shuffles; from it dmask = sum_k c_k e_k and the
//     offset gradient with the bilinear-weight derivatives, times m. Both
//     y-corners enter even when fy == 0 (the one-sided derivative of the
//     TPU kernels and of autograd through floor), and d(dy) = 0 wherever
//     |dy_raw| >= max_shift. `Geom::write_grads` stores them.
// dcn_bwd_weight_kernel: dW[t] = sum over pixels of (m * u_t)^T g, a GEMM
//   with the B*H*W pixels as the reduction axis. One block per (tap, Cin
//   tile of 64, Cout tile of 64, slice of pixels) samples its columns into
//   shared memory (rounded to bf16), contracts them with bf16 g by FMAs,
//   and adds its f32 partial into dW with atomicAdd.
//
// dx and dW are sums of atomics whose order changes from run to run; they
// agree with the plain versions to f32 rounding of the summation order.
#pragma once

#include "dcn_common.cuh"

namespace dcn {

constexpr int kPix = 64;  // forward and data kernels: output pixels per block
constexpr int kCo = 64;   // forward: output channels per block
constexpr int kCk = 32;   // forward: input channels per staged chunk
constexpr int kCc = 64;   // data kernel: input channels per gcol chunk
constexpr int kCoK = 32;  // data kernel: output channels per reduction step
constexpr int kWc = 64;   // weight kernels: input channels per block
constexpr int kWo = 64;   // weight kernel: output channels per block
constexpr int kKp = 32;   // weight kernels: pixels per reduction step

// The last template parameter of the sampling kernels only names an
// instantiation: dcn_sel_fwd.cu and dcn_sel_bwd.cu pass `Select`, so a
// profile tells their launches from the lanes kernels' (same bodies).
struct Select {};

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

template <typename Geom, typename GT, typename Tag = void>
__global__ void __launch_bounds__(kThreads)
    dcn_bwd_data_kernel(const __nv_bfloat16* __restrict__ x, const Geom geom,
                        const __nv_bfloat16* __restrict__ wt_t,  // (9,Cout,Cin)
                        const GT* __restrict__ g,  // (B, Cout, H, W)
                        float* __restrict__ dx,    // (B, H, W, Cin), zeroed
                        int H, int W, int Cin, int Cout, float max_shift) {
  __shared__ float s_g[kCoK][kPix];         // bf16 g, [cout][pixel]
  __shared__ float s_w[kCoK][kCc];          // W_t^T chunk, [cout][channel]
  __shared__ float s_gcol[kCc][kPix + 1];   // bf16-rounded gcol, [chan][pix]
  __shared__ int s_idx[4][kPix];
  __shared__ float s_c[4][kPix];
  __shared__ float s_fy[kPix], s_fx[kPix], s_m[kPix];
  __shared__ int s_live[kPix];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPix;
  const int HW = H * W;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Cin;
  float* dxb = dx + (size_t)b * HW * Cin;
  constexpr int kPixPerWarp = kPix / (kThreads / 32);  // 8

  for (int t = 0; t < kTaps; ++t) {
    __syncthreads();  // the previous tap's readers of the pixel tables are done
    if (tid < kPix) {
      const int p = p0 + tid;
      if (p < HW) {
        const Sample s = sample_at(geom, b, t, p / W, p % W, H, W, max_shift);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = s.idx[k];
          s_c[k][tid] = s.c[k];
        }
        s_fy[tid] = s.fy;
        s_fx[tid] = s.fx;
        s_m[tid] = s.m;
        s_live[tid] = s.dy_live ? 1 : 0;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = -1;
          s_c[k][tid] = 0.f;
        }
        s_fy[tid] = s_fx[tid] = s_m[tid] = 0.f;
        s_live[tid] = 0;
      }
    }

    float e[kPixPerWarp][4];
#pragma unroll
    for (int q = 0; q < kPixPerWarp; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) e[q][k] = 0.f;

    for (int c0 = 0; c0 < Cin; c0 += kCc) {
      // gcol[p][c] = sum_o g[p][o] * W_t[c][o] for this channel chunk
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int o0 = 0; o0 < Cout; o0 += kCoK) {
        __syncthreads();  // the last step's reads of s_g/s_w are done
        for (int el = tid; el < kCoK * kPix; el += kThreads) {
          const int oo = el / kPix;
          const int pp = el % kPix;
          float v = 0.f;
          if (o0 + oo < Cout && p0 + pp < HW)
            v = load_as_bf16(g + ((size_t)b * Cout + o0 + oo) * HW + p0 + pp);
          s_g[oo][pp] = v;
        }
        for (int el = tid; el < kCoK * kCc; el += kThreads) {
          const int oo = el / kCc;
          const int cc = el % kCc;
          float v = 0.f;
          if (o0 + oo < Cout && c0 + cc < Cin)
            v = bf16_load(wt_t + ((size_t)t * Cout + o0 + oo) * Cin + c0 + cc);
          s_w[oo][cc] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int oo = 0; oo < kCoK; ++oo) {
          float a[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = s_g[oo][tx + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = s_w[oo][ty + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
      }
      // s_gcol's readers from the previous chunk finished before the
      // __syncthreads() that opened this chunk's last reduction step
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s_gcol[ty + 16 * j][tx + 16 * i] = bf16_round(acc[i][j]);
      __syncthreads();

      // corner contraction and dx scatter: a warp owns 8 pixels, a lane
      // owns the channels lane and lane + 32 of the chunk
#pragma unroll
      for (int q = 0; q < kPixPerWarp; ++q) {
        const int pp = warp * kPixPerWarp + q;
        if (p0 + pp >= HW) continue;
        const float m = s_m[pp];
#pragma unroll
        for (int h2 = 0; h2 < kCc / 32; ++h2) {
          const int cc = lane + 32 * h2;
          const int c = c0 + cc;
          if (c >= Cin) continue;
          const float gv = s_gcol[cc][pp];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = s_idx[k][pp];
            if (i < 0) continue;
            const size_t at = (size_t)i * Cin + c;
            e[q][k] = fmaf(bf16_load(xb + at), gv, e[q][k]);
            const float wk = m * s_c[k][pp];
            if (wk != 0.f) atomicAdd(dxb + at, wk * gv);
          }
        }
      }
    }

    // reduce the corner contractions over the warp's lanes and write the
    // sampling gradients of this tap
#pragma unroll
    for (int q = 0; q < kPixPerWarp; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = e[q][k];
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
        e[q][k] = v;
      }
      const int pp = warp * kPixPerWarp + q;
      const int p = p0 + pp;
      if (lane == 0 && p < HW) {
        const float fy = s_fy[pp], fx = s_fx[pp];
        const float e00 = e[q][0], e01 = e[q][1], e10 = e[q][2], e11 = e[q][3];
        const float dm = s_c[0][pp] * e00 + s_c[1][pp] * e01 +
                         s_c[2][pp] * e10 + s_c[3][pp] * e11;
        // corners outside the map have e_k == 0, so the derivative
        // coefficients need no validity factor
        const float gy = -(1.f - fx) * e00 - fx * e01 + (1.f - fx) * e10 + fx * e11;
        const float gx = -(1.f - fy) * e00 + (1.f - fy) * e01 - fy * e10 + fy * e11;
        geom.write_grads(b, t, (size_t)HW, (size_t)p, s_live[pp] != 0,
                         s_m[pp], gy, gx, dm);
      }
    }
  }
}

template <typename Geom, typename GT, typename Tag = void>
__global__ void __launch_bounds__(kThreads)
    dcn_bwd_weight_kernel(const __nv_bfloat16* __restrict__ x,
                          const Geom geom,
                          const GT* __restrict__ g,  // (B, Cout, H, W)
                          float* __restrict__ dw,  // (9, Cin, Cout), zeroed
                          int B, int H, int W, int Cin, int Cout,
                          float max_shift, int pix_per_block) {
  __shared__ float s_col[kKp][kWc];      // sampled columns, [pixel][channel]
  __shared__ float s_g[kKp][kWo + 1];    // bf16 g, [pixel][cout]
  __shared__ int s_idx[4][kKp];          // corner index into the B*H*W pixels
  __shared__ float s_cw[4][kKp];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int t = blockIdx.z;
  const int n_co_tiles = (Cout + kWo - 1) / kWo;
  const int ci0 = (blockIdx.y / n_co_tiles) * kWc;
  const int co0 = (blockIdx.y % n_co_tiles) * kWo;
  const int HW = H * W;
  const long long n_total = (long long)B * HW;
  const long long n_begin = (long long)blockIdx.x * pix_per_block;
  const long long n_end =
      n_begin + pix_per_block < n_total ? n_begin + pix_per_block : n_total;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long n0 = n_begin; n0 < n_end; n0 += kKp) {
    __syncthreads();  // the last step's FMAs are done with s_col/s_g/s_idx
    if (tid < kKp) {
      const long long n = n0 + tid;
      if (n < n_end) {
        const int b = (int)(n / HW);
        const int p = (int)(n % HW);
        const Sample s = sample_at(geom, b, t, p / W, p % W, H, W, max_shift);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k][tid] = s.idx[k] < 0 ? -1 : b * HW + s.idx[k];
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
    for (int el = tid; el < kKp * kWo; el += kThreads) {
      const int pp = el % kKp;
      const int oo = el / kKp;
      const long long n = n0 + pp;
      float v = 0.f;
      if (n < n_end && co0 + oo < Cout) {
        const int b = (int)(n / HW);
        const int p = (int)(n % HW);
        v = load_as_bf16(g + ((size_t)b * Cout + co0 + oo) * HW + p);
      }
      s_g[pp][oo] = v;
    }
    __syncthreads();
    for (int el = tid; el < kKp * kWc; el += kThreads) {
      const int cc = el % kWc;
      const int pp = el / kWc;
      const int c = ci0 + cc;
      float v = 0.f;
      if (c < Cin) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = s_idx[k][pp];
          if (i >= 0) v += s_cw[k][pp] * bf16_load(x + (size_t)i * Cin + c);
        }
      }
      s_col[pp][cc] = bf16_round(v);
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < kKp; ++pp) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_col[pp][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = s_g[pp][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ci0 + ty + 16 * i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < Cout)
        atomicAdd(dw + ((size_t)t * Cin + c) * Cout + co, acc[i][j]);
    }
  }
}

}  // namespace dcn
