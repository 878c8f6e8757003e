// DCNv2 forward for Hopper (sm_90a) with both offsets clamped: the JAX
// package's wide maps (W > 256) under a forced "lanes" kernel generation;
// x float32 or bfloat16.
//
// Replaces the TPU kernel `_dcn_kernel` in panel mode
// (centernet_uda_tpu/ops/dcn_pallas.py, `panel_wp > 0`, driven by
// `_dcn_v2_pallas_wide`). There the width is cut into overlapping 128-lane
// panels, each keeping its middle columns, and the horizontal offset is
// clamped to +-max_shift like the vertical one so no kept column samples
// outside its panel. The panels are a lane-width device of the TPU; the
// clamp is the function. This source runs the shared `dcn_fwd_kernel` body
// over the whole width with `kClampDx` set: dx is clamped to +-max_shift
// before the sample position is formed, exactly as dy is. Everything else
// is dcn_fwd.cu's: bf16 samples, bf16 W, f32 accumulation, the f32 bias,
// the output in x's dtype (`out_bf16`).
//
// The backward of this route is not a kernel on either side: the JAX
// package differentiates the exact op on clipped offsets there
// (centernet_uda_tpu/ops/dcn.py, `_dcn_pallas_bwd`), and so does the port
// (ops/dcn_cuda.py, `_DCNWideFn`).
//
// Bound on the H100: at DLA-34's 64 -> 64 @272x272, batch 4 (the 1088 px
// eval), the HBM traffic of x, offsets, mask and out is above the
// contraction's time at the bf16 tensor-core rate; this version runs the
// contraction as f32 FMAs on the CUDA cores and is compute-bound above it.
#include "dcn_kernels.cuh"

namespace {

template <typename OutT>
int launch(const void* x, const void* offset, const void* mask,
           const void* wt, const void* bias, void* out, int B, int H, int W,
           int Cin, int Cout, float max_shift, cudaStream_t stream) {
  using namespace dcn;
  auto kernel = dcn_fwd_kernel<OffsetMask, OutT, true>;
  cudaError_t err = check_launch(kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * W + kPix - 1) / kPix, (Cout + kCo - 1) / kCo, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const OffsetMask geom{(const float*)offset, (const float*)mask, nullptr,
                        nullptr};
  kernel<<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, geom, (const __nv_bfloat16*)wt,
      (const float*)bias, (OutT*)out, H, W, Cin, Cout, max_shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns the cudaError_t of the launch.
// Operands as dcn_sel_fwd's.
int dcn_wide_fwd(const void* x, const void* offset, const void* mask,
                 const void* wt, const void* bias, void* out, int B, int H,
                 int W, int Cin, int Cout, float max_shift, int out_bf16,
                 void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return launch<__nv_bfloat16>(x, offset, mask, wt, bias, out, B, H, W,
                                 Cin, Cout, max_shift, s);
  return launch<float>(x, offset, mask, wt, bias, out, B, H, W, Cin, Cout,
                       max_shift, s);
}

const char* dcn_wide_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
