// Shared device code of the DCNv2 kernels (3x3 / stride 1 / pad 1 /
// dilation 1, deformable_groups 1).
//
// Operand contract, identical for the forward and the backward:
//   x       (B, H, W, Cin)  bf16, channels-last staging of the f32 input, so
//                           each bilinear corner is one contiguous Cin vector
//   offset  (B, 18, H, W)   f32, channel 2t = dy of tap t, 2t+1 = dx
//   mask    (B, 9, H, W)    f32, post-sigmoid modulation
// Tap t = 3*ti + tj samples at (y + ti - 1 + clamp(dy, +-max_shift),
// x + tj - 1 + dx): only the vertical offset is clamped, horizontal sampling
// is exact, and corners outside [0, H-1] x [0, W-1] read zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace dcn {

constexpr int kThreads = 256;  // every kernel: 16 x 16 threads
constexpr int kTaps = 9;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float bf16_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Bilinear geometry of one output pixel and tap.
struct Sample {
  int idx[4];   // corner (00, 01, 10, 11) as y*W+x in the H*W plane, -1 outside
  float c[4];   // bilinear corner weights, 0 outside the map (mask not folded)
  float fy, fx; // fractional position: weight of the y0+1 row / x0+1 column
  float m;      // mask
  bool dy_live; // |dy_raw| < max_shift: the clamp passes the dy gradient
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ offset,
                                            const float* __restrict__ mask,
                                            int b, int t, int y, int x, int H,
                                            int W, float max_shift) {
  const size_t plane = (size_t)H * W;
  const size_t pix = (size_t)y * W + x;
  const float dy_raw = offset[((size_t)b * 2 * kTaps + 2 * t) * plane + pix];
  const float dx = offset[((size_t)b * 2 * kTaps + 2 * t + 1) * plane + pix];
  Sample s;
  s.m = mask[((size_t)b * kTaps + t) * plane + pix];
  s.dy_live = fabsf(dy_raw) < max_shift;
  const float dy = fminf(fmaxf(dy_raw, -max_shift), max_shift);
  const float py = (float)(y + t / 3 - 1) + dy;
  const float px = (float)(x + t % 3 - 1) + dx;
  const float y0f = floorf(py);
  const float x0f = floorf(px);
  s.fy = py - y0f;
  s.fx = px - x0f;
  // a corner can only be inside when y0 is in [-1, H-1] and x0 in [-1, W-1];
  // testing in float first keeps a huge or non-finite dx away from the
  // int conversion
  const bool near = y0f >= -1.f && y0f <= (float)(H - 1) && x0f >= -1.f &&
                    x0f <= (float)(W - 1);
  const int y0 = near ? (int)y0f : -2;
  const int x0 = near ? (int)x0f : -2;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yk = y0 + (k >> 1);
    const int xk = x0 + (k & 1);
    const bool valid = yk >= 0 && yk < H && xk >= 0 && xk < W;
    const float wy = (k >> 1) ? s.fy : 1.f - s.fy;
    const float wx = (k & 1) ? s.fx : 1.f - s.fx;
    s.c[k] = valid ? wy * wx : 0.f;
    s.idx[k] = valid ? yk * W + xk : -1;
  }
  return s;
}

// Rejects a launch the device cannot run: too many threads for the compiled
// kernel, or more static shared memory than one block may hold.
template <typename Kernel>
__host__ cudaError_t check_launch(Kernel kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int dev = 0, smem_max = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlock,
                               dev);
  if (err != cudaSuccess) return err;
  if (attr.maxThreadsPerBlock < kThreads) return cudaErrorInvalidConfiguration;
  if (attr.sharedSizeBytes > (size_t)smem_max)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace dcn
