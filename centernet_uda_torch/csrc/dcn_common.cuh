// Shared device code of the DCNv2 kernels (3x3 / stride 1 / pad 1 /
// dilation 1, deformable_groups 1).
//
// Operand contract, identical for every kernel:
//   x       (B, H, W, Cin)  bf16, channels-last, so each bilinear corner is
//                           one contiguous Cin vector
// and the sampling geometry of tap t at each output pixel, read from one of
// two layouts (the `Geom` parameter of `sample_at`):
//   OffsetMask  offset (B, 18, H, W) f32, channel 2t = dy of tap t, 2t+1 =
//               dx, and mask (B, 9, H, W) f32, post-sigmoid;
//   OffsetConv  om (B, 27, H, W) f32, the fused layer's offset-conv output:
//               channel 2t = dy, 2t+1 = dx, 18+t = the mask logit.
// Tap t = 3*ti + tj samples at (y + ti - 1 + clamp(dy, +-max_shift),
// x + tj - 1 + dx): only the vertical offset is clamped, horizontal sampling
// is exact, and corners outside [0, H-1] x [0, W-1] read zero. The wide
// forward (dcn_wide_fwd.cu) sets `kClampDx` and clamps dx the same way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace dcn {

constexpr int kThreads = 256;  // every kernel: 256 threads
constexpr int kTaps = 9;
constexpr int kOm = 27;  // offset-conv channels: 18 offsets + 9 mask logits

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The gradients of the sampling positions have one writer each: the
// backward's data kernel stores them, `part` elements past the geometry's
// pointers. Where that kernel splits Cin across blocks, slice s writes its
// share to its own plane (`part` = s times the plane's size) and a pass in
// slice order adds the planes (dcn_sample_bwd.cuh).

// Offsets and mask as two tensors (the explicit-offset layer). The backward
// writes doffset and dmask.
struct OffsetMask {
  static constexpr bool kOmGrads = false;  // no offset conv inside
  const float* offset;
  const float* mask;
  float* doff;
  float* dmask;

  __device__ __forceinline__ void read(int b, int t, size_t plane, size_t pix,
                                       float& dy, float& dx,
                                       float& m) const {
    const float* o = offset + (size_t)b * 2 * kTaps * plane + pix;
    dy = o[(size_t)(2 * t) * plane];
    dx = o[(size_t)(2 * t + 1) * plane];
    m = mask[((size_t)b * kTaps + t) * plane + pix];
  }

  // gy, gx: d(out)/d(sample position) times g, summed over the corners and
  // channels; dm: d(out)/d(mask) times g.
  __device__ __forceinline__ void write_grads(int b, int t, size_t plane,
                                              size_t pix, bool dy_live,
                                              float m, float gy, float gx,
                                              float dm,
                                              size_t part) const {
    float* o = doff + part + (size_t)b * 2 * kTaps * plane + pix;
    o[(size_t)(2 * t) * plane] = dy_live ? m * gy : 0.f;
    o[(size_t)(2 * t + 1) * plane] = m * gx;
    dmask[part + ((size_t)b * kTaps + t) * plane + pix] = dm;
  }
};

// The offset-conv output om (the bfloat16 layer, offsets fused into the
// layer), as the fused backward's om scratch holds it. The backward writes
// dz = d(loss)/d(om) (B, 27, H, W) f32, which its weight kernel then reads
// for dW_om and db_om (dcn_sample_bwd.cuh, dcn_fused_bwd.cu).
struct OffsetConv {
  static constexpr bool kOmGrads = true;  // dW_om, db_om from dz
  const float* om;
  float* dz;

  __device__ __forceinline__ void read(int b, int t, size_t plane, size_t pix,
                                       float& dy, float& dx,
                                       float& m) const {
    const float* o = om + (size_t)b * kOm * plane + pix;
    dy = o[(size_t)(2 * t) * plane];
    dx = o[(size_t)(2 * t + 1) * plane];
    m = 1.f / (1.f + expf(-o[(size_t)(2 * kTaps + t) * plane]));
  }

  // as OffsetMask's, through the sigmoid: dz = [m gy (0 where the clamp
  // holds), m gx, dm m (1 - m)]
  __device__ __forceinline__ void write_grads(int b, int t, size_t plane,
                                              size_t pix, bool dy_live,
                                              float m, float gy, float gx,
                                              float dm,
                                              size_t part) const {
    float* o = dz + part + (size_t)b * kOm * plane + pix;
    o[(size_t)(2 * t) * plane] = dy_live ? m * gy : 0.f;
    o[(size_t)(2 * t + 1) * plane] = m * gx;
    o[(size_t)(2 * kTaps + t) * plane] = dm * m * (1.f - m);
  }
};

// Names an instantiation only: dcn_sel_fwd.cu and dcn_sel_bwd.cu pass it as
// the last template parameter of their kernels, so a profile tells their
// launches from those of the lanes sources (same bodies).
struct Select {};

// Bilinear geometry of one output pixel and tap.
struct Sample {
  int idx[4];   // corner (00, 01, 10, 11) as y*W+x in the H*W plane, -1 outside
  float c[4];   // bilinear corner weights, 0 outside the map (mask not folded)
  float fy, fx; // fractional position: weight of the y0+1 row / x0+1 column
  float m;      // mask
  bool dy_live; // |dy_raw| < max_shift: the clamp passes the dy gradient
};

template <typename Geom, bool kClampDx = false>
__device__ __forceinline__ Sample sample_at(const Geom& geom, int b, int t,
                                            int y, int x, int H, int W,
                                            float max_shift) {
  const size_t plane = (size_t)H * W;
  const size_t pix = (size_t)y * W + x;
  float dy_raw, dx;
  Sample s;
  geom.read(b, t, plane, pix, dy_raw, dx, s.m);
  s.dy_live = fabsf(dy_raw) < max_shift;
  if (kClampDx) dx = fminf(fmaxf(dx, -max_shift), max_shift);
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

// Rejects a launch the device cannot run: more than `threads` threads for
// the compiled kernel, more static shared memory than one block may hold,
// or, with `dyn_smem` bytes of dynamic shared memory, more static plus
// dynamic than the opt-in limit of one block (cudaFuncSetAttribute raises
// a kernel's limit up to it).
template <typename Kernel>
__host__ cudaError_t check_launch(Kernel kernel, int threads = kThreads,
                                  size_t dyn_smem = 0) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int dev = 0, smem_max = 0, smem_optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlock,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (attr.maxThreadsPerBlock < threads) return cudaErrorInvalidConfiguration;
  if (attr.sharedSizeBytes > (size_t)smem_max)
    return cudaErrorInvalidConfiguration;
  if (attr.sharedSizeBytes + dyn_smem > (size_t)smem_optin)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace dcn
