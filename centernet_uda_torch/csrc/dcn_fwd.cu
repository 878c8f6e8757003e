// DCNv2 forward for Hopper (sm_90a), the float32 layer.
//
// Replaces the TPU kernel `_dcn_kernel` (centernet_uda_tpu/ops/dcn_pallas.py,
// driven by `dcn_v2_pallas_lanes`). Same function: per output pixel and tap,
// bilinearly sample x at the (dy-clamped) offset position, times the mask,
// staged in bf16; contract with W[t] (Cin x Cout) with f32 accumulation; add
// the bias. The TPU restructurings (hat matrix, row-shift loop, lane packing,
// row blocks) are not carried over: a gather is cheap here. The kernel body
// is `dcn_fwd_kernel` in dcn_kernels.cuh, here over the `OffsetMask`
// geometry with an f32 output.
//
// Bound on the H100: at the DLA-34 widths the contraction (2*N*Cin*Cout*9
// FLOP) over the bf16 tensor-core rate and the HBM traffic (x, offset,
// mask, out) are of the same order; this first version runs the contraction
// on the f32 CUDA cores, so it is compute-bound well above that bound. The
// sampling is recomputed per Cout tile (Cout/64 times); wgmma on the staged
// bf16 tile is the next step.
#include "dcn_kernels.cuh"

extern "C" {

// Launches the forward on `stream`; returns the cudaError_t of the launch.
int dcn_fwd(const void* x, const void* offset, const void* mask,
            const void* wt, const void* bias, void* out, int B, int H, int W,
            int Cin, int Cout, float max_shift, void* stream) {
  using namespace dcn;
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return (int)cudaSuccess;
  auto kernel = dcn_fwd_kernel<OffsetMask, float>;
  cudaError_t err = check_launch(kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * W + kPix - 1) / kPix, (Cout + kCo - 1) / kCo, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const OffsetMask geom{(const float*)offset, (const float*)mask, nullptr,
                        nullptr};
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, geom, (const __nv_bfloat16*)wt,
      (const float*)bias, (float*)out, H, W, Cin, Cout, max_shift);
  return (int)cudaGetLastError();
}

const char* dcn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
