// DCNv2 forward for Hopper (sm_90a) at the shapes the JAX package sends to
// its "select" generation: Cin > 512 (MobileNetV2's 1280-channel neck
// input), W > 256, W < 8; x float32 or bfloat16.
//
// Replaces the TPU kernel `_sel_fwd_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by `dcn_v2_pallas_select`).
// Same function as dcn_fwd.cu: per output pixel and tap, bilinearly sample
// x at the dy-clamped, dx-exact offset position, times the mask, staged in
// bf16; contract with the bf16 W[t] (Cin x Cout) with f32 accumulation; add
// the f32 bias; store in x's dtype. The TPU kernel exists because a Mosaic
// lane gather is costly: it resolves each tap's horizontal position with
// one-hot (W x W) select matmuls in the native NHWC layout, pads x on H
// only and keeps the whole image in VMEM, which bounds it by VMEM rather
// than by the lane width. None of that is a limit here: a Hopper block
// gathers a corner as one contiguous run of channels (x is staged
// channels-last), at any W and any Cin. So this source runs the shared
// `dcn_fwd_kernel` body over the `OffsetMask` geometry (instantiated under
// the `Select` tag, so profiles name it apart from dcn_fwd.cu's); what is
// its own is the operand contract, x and out in f32 or in bf16 (the bf16
// layer's explicit-offset route), chosen per call by `out_bf16`.
//
// Bound on the H100: at MobileNetV2's 1280 -> 256 @16x16, batch 32, the
// contraction (2*N*9*Cin*Cout = 48.3 GFLOP) over the bf16 tensor-core rate
// (0.049 ms) is above the HBM time of x, offsets, mask and out. This
// version runs it as f32 FMAs on the CUDA cores, so it is compute-bound
// far above that bound; the Cin loop is 40 chunks of 32 channels, with the
// sampling recomputed per Cout tile of 64.
#include "dcn_kernels.cuh"

namespace {

template <typename OutT>
int launch(const void* x, const void* offset, const void* mask,
           const void* wt, const void* bias, void* out, int B, int H, int W,
           int Cin, int Cout, float max_shift, cudaStream_t stream) {
  using namespace dcn;
  auto kernel = dcn_fwd_kernel<OffsetMask, OutT, false, Select>;
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
// x is the bf16 channels-last staging of the layer's input; `out_bf16`
// selects a bf16 (B, Cout, H, W) output, else f32.
int dcn_sel_fwd(const void* x, const void* offset, const void* mask,
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

const char* dcn_sel_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
