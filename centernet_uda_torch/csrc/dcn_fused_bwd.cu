// DCNv2 backward with the offset conv fused in, for Hopper (sm_90a): the
// bfloat16 layer. Five kernels, launched back to back on one stream.
//
// Replaces the TPU kernel `_dcn_fused_bwd_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by
// `dcn_v2_pallas_bwd_lanes_fused`), which recomputes om, runs the sampling
// backward of `_dcn_bwd_params_kernel`, and then the offset conv's own
// backward, with one whole-image dx accumulator resident in VMEM across its
// sequential grid. Hopper blocks run in parallel, so the work splits by
// what each product reduces over:
//
// 1. dcn_om_kernel (dcn_kernels.cuh) recomputes om (B, 27, H, W) f32.
// 2. dcn_bwd_data_kernel over the `OffsetConv` geometry with bf16 g: the
//    sampling part of dx by f32 atomics into a zeroed channels-last f32
//    scratch, and dz = d(loss)/d(om) (B, 27, H, W) f32: the dy gradient
//    zeroed where |dy_raw| >= max_shift, the dx gradient, the mask gradient
//    times sigmoid (1 - sigmoid).
// 3. dcn_bwd_weight_kernel, the split-K dW of the layer's own weight.
// 4. dcn_om_wgrad_kernel: dW_om[t] = sum over pixels of x_t^T dz, split-K
//    over the B*H*W pixels with f32 atomics, as for dW; and db_om = sum dz.
// 5. dcn_om_dgrad_kernel: dx += conv_transpose(dz, W_om), a gather per
//    destination pixel, added into the same dx scratch after launch 2.
// dx is rounded to bf16 once, by the wrapper, after both parts are in. As
// on the TPU, dz is rounded to bf16 for the two offset-conv products and
// enters db_om unrounded, and the W_om operand is bf16.
//
// Bound on the H100: the contractions, 2*N*9*Cin*(2*Cout+2*27) FLOP, over
// the bf16 tensor-core rate, against the HBM traffic of x and g in and dx
// out; at the DLA-34 widths they are of the same order. This first version
// runs every product on the f32 CUDA cores and recomputes the sampling in
// launches 2 and 3, so it is compute-bound well above that bound.
#include "dcn_kernels.cuh"

namespace dcn {

constexpr int kOmOut = 7;  // offset-conv backward: outputs per thread

// One block per (tap, Cin tile of 64, slice of pixels). A thread owns one
// input channel and 7 of the 27 outputs.
__global__ void __launch_bounds__(kThreads)
    dcn_om_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ dz,  // (B, 27, H, W)
                        float* __restrict__ dwom,  // (9, Cin, 27), zeroed
                        float* __restrict__ dbom,  // (27), zeroed
                        int B, int H, int W, int Cin, int pix_per_block) {
  __shared__ float s_x[kKp][kWc];      // x at the tap's neighbour, [pix][chan]
  __shared__ float s_dz[kKp][kOm + 1]; // bf16-rounded dz, [pix][output]

  const int tid = threadIdx.x;
  const int cc = tid & (kWc - 1);
  const int o0 = (tid / kWc) * kOmOut;
  const int t = blockIdx.z;
  const int dy = t / 3 - 1;
  const int dx = t % 3 - 1;
  const int ci0 = blockIdx.y * kWc;
  const int HW = H * W;
  const long long n_total = (long long)B * HW;
  const long long n_begin = (long long)blockIdx.x * pix_per_block;
  const long long n_end =
      n_begin + pix_per_block < n_total ? n_begin + pix_per_block : n_total;
  // one column of blocks also sums dz, unrounded, for db_om
  const bool bias_block = t == 0 && blockIdx.y == 0;
  constexpr int kDzSteps = (kKp * kOm + kThreads - 1) / kThreads;  // 4

  float acc[kOmOut];
#pragma unroll
  for (int j = 0; j < kOmOut; ++j) acc[j] = 0.f;
  float db[kDzSteps];
#pragma unroll
  for (int k = 0; k < kDzSteps; ++k) db[k] = 0.f;

  for (long long n0 = n_begin; n0 < n_end; n0 += kKp) {
    __syncthreads();  // the last step's FMAs are done with s_x/s_dz
#pragma unroll
    for (int k = 0; k < kDzSteps; ++k) {
      const int el = tid + k * kThreads;
      if (el >= kKp * kOm) continue;
      const int o = el / kKp;
      const int pp = el % kKp;
      const long long n = n0 + pp;
      float v = 0.f;
      if (n < n_end) {
        const int b = (int)(n / HW);
        const int p = (int)(n % HW);
        v = dz[((size_t)b * kOm + o) * HW + p];
      }
      s_dz[pp][o] = bf16_round(v);
      db[k] += v;
    }
    for (int el = tid; el < kKp * kWc; el += kThreads) {
      const int c = ci0 + el % kWc;
      const int pp = el / kWc;
      const long long n = n0 + pp;
      float v = 0.f;
      if (n < n_end && c < Cin) {
        const int b = (int)(n / HW);
        const int p = (int)(n % HW);
        const int yy = p / W + dy;
        const int xx = p % W + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = bf16_load(x + ((size_t)b * HW + (size_t)yy * W + xx) * Cin + c);
      }
      s_x[pp][el % kWc] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < kKp; ++pp) {
      const float a = s_x[pp][cc];
#pragma unroll
      for (int j = 0; j < kOmOut; ++j)
        if (o0 + j < kOm) acc[j] = fmaf(a, s_dz[pp][o0 + j], acc[j]);
    }
  }

  const int c = ci0 + cc;
  if (c < Cin) {
#pragma unroll
    for (int j = 0; j < kOmOut; ++j)
      if (o0 + j < kOm)
        atomicAdd(dwom + ((size_t)t * Cin + c) * kOm + o0 + j, acc[j]);
  }
  if (bias_block) {
#pragma unroll
    for (int k = 0; k < kDzSteps; ++k) {
      const int el = tid + k * kThreads;
      if (el < kKp * kOm) atomicAdd(dbom + el / kKp, db[k]);
    }
  }
}

// One block per (image, tile of 64 destination pixels, Cin tile of 64):
// dx[p][c] += sum over taps t and outputs o of dz[p - shift_t][o] *
// W_om[t][c][o], a 4x4 register tile per thread (4 pixels x 4 channels,
// channels fastest across the threads so the read-modify-write of dx is
// coalesced). Each (pixel, channel) has one owner, and the data kernel's
// atomics into dx finished before this launch, so no atomics are needed.
__global__ void __launch_bounds__(kThreads)
    dcn_om_dgrad_kernel(const float* __restrict__ dz,  // (B, 27, H, W)
                        const __nv_bfloat16* __restrict__ wom,  // (9,Cin,27)
                        float* __restrict__ dx,  // (B, H, W, Cin)
                        int H, int W, int Cin) {
  __shared__ float s_dz[kOm][kPix + 1];  // bf16-rounded dz, [output][pixel]
  __shared__ float s_w[kOm][kWc];        // W_om[t] chunk, [output][chan]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kPix;
  const int ci0 = blockIdx.y * kWc;
  const int HW = H * W;

  float acc[4][4];  // [pixel ty + 16 i][channel tx + 16 j]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    // the forward read x at (y + dy, x + dx) for om at (y, x), so pixel p
    // of dx receives dz from (py - dy, px - dx)
    const int dy = t / 3 - 1;
    const int dx_ = t % 3 - 1;
    __syncthreads();  // the last tap's FMAs are done with s_dz/s_w
    for (int el = tid; el < kOm * kPix; el += kThreads) {
      const int o = el / kPix;
      const int pp = el % kPix;
      const int p = p0 + pp;
      float v = 0.f;
      if (p < HW) {
        const int yy = p / W - dy;
        const int xx = p % W - dx_;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = dz[((size_t)b * kOm + o) * HW + (size_t)yy * W + xx];
      }
      s_dz[o][pp] = bf16_round(v);
    }
    for (int el = tid; el < kWc * kOm; el += kThreads) {
      const int cc = el / kOm;
      const int o = el % kOm;
      s_w[o][cc] = ci0 + cc < Cin
                       ? bf16_load(wom + ((size_t)t * Cin + ci0 + cc) * kOm + o)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 3
    for (int o = 0; o < kOm; ++o) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_dz[o][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = s_w[o][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= HW) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = ci0 + tx + 16 * j;
      if (c < Cin) dx[((size_t)b * HW + p) * Cin + c] += acc[i][j];
    }
  }
}

}  // namespace dcn

extern "C" {

// Launches the five backward kernels on `stream`; returns the first
// cudaError_t. om and dz are scratch (B, 27, H, W) f32; dx, dw, dwom and
// dbom must be zeroed by the caller.
int dcn_fused_bwd(const void* x, const void* wom, const void* bom,
                  const void* wt_t, const void* g, void* om, void* dz,
                  void* dx, void* dw, void* dwom, void* dbom, int B, int H,
                  int W, int Cin, int Cout, float max_shift,
                  int pix_per_block, int om_pix_per_block, void* stream) {
  using namespace dcn;
  if (B == 0 || H == 0 || W == 0 || Cin == 0 || Cout == 0)
    return (int)cudaSuccess;
  if (pix_per_block <= 0 || pix_per_block % kKp != 0 ||
      om_pix_per_block <= 0 || om_pix_per_block % kKp != 0)
    return (int)cudaErrorInvalidValue;
  auto data_kernel = dcn_bwd_data_kernel<OffsetConv, __nv_bfloat16>;
  auto weight_kernel = dcn_bwd_weight_kernel<OffsetConv, __nv_bfloat16>;
  cudaError_t err = check_launch(dcn_om_kernel);
  if (err == cudaSuccess) err = check_launch(data_kernel);
  if (err == cudaSuccess) err = check_launch(weight_kernel);
  if (err == cudaSuccess) err = check_launch(dcn_om_wgrad_kernel);
  if (err == cudaSuccess) err = check_launch(dcn_om_dgrad_kernel);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const OffsetConv geom{(const float*)om, (float*)dz};

  const long long n_total = (long long)B * H * W;
  const long long splits = (n_total + pix_per_block - 1) / pix_per_block;
  const long long om_splits =
      (n_total + om_pix_per_block - 1) / om_pix_per_block;
  const long long tiles =
      (long long)((Cin + kWc - 1) / kWc) * ((Cout + kWo - 1) / kWo);
  const int ci_tiles = (Cin + kWc - 1) / kWc;
  if (B > 65535 || splits > 0x7fffffffLL || om_splits > 0x7fffffffLL ||
      tiles > 65535 || ci_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const unsigned pix_tiles = (H * W + kPix - 1) / kPix;

  dcn_om_kernel<<<dim3(pix_tiles, B), kThreads, 0, s>>>(
      xb, (const __nv_bfloat16*)wom, (const float*)bom, (float*)om, nullptr,
      H, W, Cin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  data_kernel<<<dim3(pix_tiles, B), kThreads, 0, s>>>(
      xb, geom, (const __nv_bfloat16*)wt_t, (const __nv_bfloat16*)g,
      (float*)dx, H, W, Cin, Cout, max_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  weight_kernel<<<dim3((unsigned)splits, (unsigned)tiles, kTaps), kThreads,
                  0, s>>>(xb, geom, (const __nv_bfloat16*)g, (float*)dw, B,
                          H, W, Cin, Cout, max_shift, pix_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dcn_om_wgrad_kernel<<<dim3((unsigned)om_splits, ci_tiles, kTaps), kThreads,
                        0, s>>>(xb, (const float*)dz, (float*)dwom,
                                (float*)dbom, B, H, W, Cin,
                                om_pix_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dcn_om_dgrad_kernel<<<dim3(pix_tiles, ci_tiles, B), kThreads, 0, s>>>(
      (const float*)dz, (const __nv_bfloat16*)wom, (float*)dx, H, W, Cin);
  return (int)cudaGetLastError();
}

const char* dcn_fused_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
