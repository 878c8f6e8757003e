// DCNv2 backward for Hopper (sm_90a): two kernels, launched back to back.
//
// Replaces the TPU kernel `_dcn_bwd_params_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by `_bwd_params_call` /
// `dcn_v2_pallas_bwd_lanes`), which produces every gradient in one pass with
// the whole-image dx accumulator resident in VMEM. TPU grid steps run in
// order on one core, so that accumulator needs no atomics; Hopper blocks run
// in parallel, so the work splits in two:
//
// dcn_bwd_data_kernel: one block per (image, tile of 64 output pixels),
//   looping over the 9 taps. Per tap it recomputes the sampling, forms
//   gcol_t = g . W_t^T (bf16 operands, f32 accumulation, rounded to bf16 as
//   the TPU kernel does) in shared memory, then per (pixel, channel):
//   - dx += m * corner weight * gcol by f32 atomicAdd into a zeroed
//     channels-last scratch (corners of weight 0 are skipped; they add 0);
//   - e_k += x_corner_k * gcol, the corner contraction, reduced over the
//     channels with warp shuffles; from it dmask = sum_k c_k e_k and the
//     offset gradient with the bilinear-weight derivatives, times m. Both
//     y-corners enter even when fy == 0 (the one-sided derivative of the
//     TPU kernel and of autograd through floor), and d(dy) = 0 wherever
//     |dy_raw| >= max_shift.
// dcn_bwd_weight_kernel: dW[t] = sum over pixels of (m * u_t)^T g, a GEMM
//   with the B*H*W pixels as the reduction axis. One block per (tap, Cin
//   tile of 64, Cout tile of 64, slice of pixels) samples its columns into
//   shared memory, contracts them with the bf16-rounded g by FMAs, and adds
//   its f32 partial into dW with atomicAdd.
//
// dx and dW are sums of atomics whose order changes from run to run; they
// agree with the plain version to f32 rounding of the summation order.
//
// Bound on the H100: as in the forward, the two contractions over the bf16
// tensor-core rate and the HBM traffic (x, offset, mask, g in; dx, doff,
// dmask out) are of the same order. This version runs both contractions on
// the f32 CUDA cores and recomputes the sampling in both kernels; it is
// compute-bound. The dx atomics are coalesced over channels (channels-last
// scratch), so one warp updates one 128-byte line per corner.
#include "dcn_common.cuh"

namespace dcn {

constexpr int kPix = 64;  // data kernel: output pixels per block
constexpr int kCc = 64;   // data kernel: input channels per gcol chunk
constexpr int kCoK = 32;  // data kernel: output channels per reduction step
constexpr int kWc = 64;   // weight kernel: input channels per block
constexpr int kWo = 64;   // weight kernel: output channels per block
constexpr int kKp = 32;   // weight kernel: pixels per reduction step

__global__ void __launch_bounds__(kThreads)
    dcn_bwd_data_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ offset,
                        const float* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ wt_t,  // (9,Cout,Cin)
                        const float* __restrict__ g,  // (B, Cout, H, W)
                        float* __restrict__ dx,       // (B, H, W, Cin), zeroed
                        float* __restrict__ doff,     // (B, 18, H, W)
                        float* __restrict__ dmask,    // (B, 9, H, W)
                        int H, int W, int Cin, int Cout, float max_shift) {
  __shared__ float s_g[kCoK][kPix];         // bf16-rounded g, [cout][pixel]
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
        const Sample s =
            sample_at(offset, mask, b, t, p / W, p % W, H, W, max_shift);
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
            v = g[((size_t)b * Cout + o0 + oo) * HW + p0 + pp];
          s_g[oo][pp] = bf16_round(v);
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
        const float fy = s_fy[pp], fx = s_fx[pp], m = s_m[pp];
        const float e00 = e[q][0], e01 = e[q][1], e10 = e[q][2], e11 = e[q][3];
        const float dm = s_c[0][pp] * e00 + s_c[1][pp] * e01 +
                         s_c[2][pp] * e10 + s_c[3][pp] * e11;
        // corners outside the map have e_k == 0, so the derivative
        // coefficients need no validity factor
        const float gy = -(1.f - fx) * e00 - fx * e01 + (1.f - fx) * e10 + fx * e11;
        const float gx = -(1.f - fy) * e00 + (1.f - fy) * e01 - fy * e10 + fy * e11;
        const size_t plane = (size_t)HW;
        dmask[((size_t)b * kTaps + t) * plane + p] = dm;
        doff[((size_t)b * 2 * kTaps + 2 * t) * plane + p] =
            s_live[pp] ? m * gy : 0.f;
        doff[((size_t)b * 2 * kTaps + 2 * t + 1) * plane + p] = m * gx;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dcn_bwd_weight_kernel(const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ offset,
                          const float* __restrict__ mask,
                          const float* __restrict__ g,  // (B, Cout, H, W)
                          float* __restrict__ dw,  // (9, Cin, Cout), zeroed
                          int B, int H, int W, int Cin, int Cout,
                          float max_shift, int pix_per_block) {
  __shared__ float s_col[kKp][kWc];      // sampled columns, [pixel][channel]
  __shared__ float s_g[kKp][kWo + 1];    // bf16-rounded g, [pixel][cout]
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
        const Sample s =
            sample_at(offset, mask, b, t, p / W, p % W, H, W, max_shift);
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
        v = g[((size_t)b * Cout + co0 + oo) * HW + p];
      }
      s_g[pp][oo] = bf16_round(v);
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

extern "C" {

// Launches both backward kernels on `stream`; returns the first
// cudaError_t. dx and dw must be zeroed by the caller.
int dcn_bwd(const void* x, const void* offset, const void* mask,
            const void* wt_t, const void* g, void* dx, void* doff,
            void* dmask, void* dw, int B, int H, int W, int Cin, int Cout,
            float max_shift, int pix_per_block, void* stream) {
  using namespace dcn;
  if (B == 0 || H == 0 || W == 0 || Cin == 0 || Cout == 0)
    return (int)cudaSuccess;
  if (pix_per_block <= 0 || pix_per_block % kKp != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = check_launch(dcn_bwd_data_kernel);
  if (err != cudaSuccess) return (int)err;
  err = check_launch(dcn_bwd_weight_kernel);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;

  const dim3 grid_d((H * W + kPix - 1) / kPix, B);
  if (grid_d.y > 65535) return (int)cudaErrorInvalidConfiguration;
  dcn_bwd_data_kernel<<<grid_d, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, (const float*)offset, (const float*)mask,
      (const __nv_bfloat16*)wt_t, (const float*)g, (float*)dx, (float*)doff,
      (float*)dmask, H, W, Cin, Cout, max_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n_total = (long long)B * H * W;
  const long long splits = (n_total + pix_per_block - 1) / pix_per_block;
  const long long tiles =
      (long long)((Cin + kWc - 1) / kWc) * ((Cout + kWo - 1) / kWo);
  if (splits > 0x7fffffffLL || tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid_w((unsigned)splits, (unsigned)tiles, kTaps);
  dcn_bwd_weight_kernel<<<grid_w, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, (const float*)offset, (const float*)mask,
      (const float*)g, (float*)dw, B, H, W, Cin, Cout, max_shift,
      pix_per_block);
  return (int)cudaGetLastError();
}

const char* dcn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
