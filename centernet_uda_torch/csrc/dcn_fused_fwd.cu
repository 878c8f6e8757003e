// DCNv2 forward with the offset conv fused in, for Hopper (sm_90a): the
// bfloat16 layer.
//
// Replaces the TPU kernel `_dcn_fused_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by
// `dcn_v2_pallas_lanes_fused`). Same function: the 3x3 offset conv om =
// conv(x, W_om) + b_om (bf16 x and bf16-rounded W_om, f32 accumulation plus
// the f32 bias, om left in f32); per tap t, dy = om[2t] clamped to
// +-max_shift, dx = om[2t+1], mask = sigmoid(om[18+t]); bilinear samples of
// x times the mask, rounded to bf16, contracted with the bf16 W[t] in f32;
// the f32 bias; the output rounded to bf16 once. It also returns max |dy|
// over the B*H*W pixels, the clamp monitor. Offsets and mask never leave
// the layer.
//
// Design: two launches on the stream, both bodies in dcn_kernels.cuh.
//   1. dcn_om_kernel writes om (B, 27, H, W) f32 into a scratch the wrapper
//      allocates and folds max |dy| into one scalar by atomicMax, so the
//      forward has no host sync.
//   2. dcn_fwd_kernel over the `OffsetConv` geometry reads om, samples bf16
//      x directly and stores bf16.
// om is computed once, not per Cout tile: fusing launch 1 into launch 2
// would recompute the offset conv (2*9*Cin*27 FLOP a pixel) Cout/64 times,
// against 108 bytes a pixel of f32 om written and read back through L2/HBM.
//
// Bound on the H100: the two contractions, 2*N*9*Cin*(Cout+27) FLOP, over
// the bf16 tensor-core rate, against the HBM traffic of x in and out; at
// the DLA-34 widths they are of the same order. This first version runs
// both contractions on the f32 CUDA cores, so it is compute-bound well
// above that bound; wgmma on the staged bf16 tiles is the next step.
#include "dcn_kernels.cuh"

extern "C" {

// Launches both kernels on `stream`; returns the first cudaError_t. `stat`
// (one 32-bit word) must be zeroed by the caller; it receives the bits of
// max |dy| as a float.
int dcn_fused_fwd(const void* x, const void* wom, const void* bom,
                  const void* wt, const void* bias, void* om, void* out,
                  void* stat, int B, int H, int W, int Cin, int Cout,
                  float max_shift, void* stream) {
  using namespace dcn;
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return (int)cudaSuccess;
  auto fwd_kernel = dcn_fwd_kernel<OffsetConv, __nv_bfloat16>;
  cudaError_t err = check_launch(dcn_om_kernel);
  if (err != cudaSuccess) return (int)err;
  err = check_launch(fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;

  const dim3 grid_om((H * W + kPix - 1) / kPix, B);
  const dim3 grid((H * W + kPix - 1) / kPix, (Cout + kCo - 1) / kCo, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dcn_om_kernel<<<grid_om, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wom, (const float*)bom,
      (float*)om, (unsigned int*)stat, H, W, Cin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const OffsetConv geom{(const float*)om, nullptr};
  fwd_kernel<<<grid, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, geom, (const __nv_bfloat16*)wt,
      (const float*)bias, (__nv_bfloat16*)out, H, W, Cin, Cout, max_shift);
  return (int)cudaGetLastError();
}

const char* dcn_fused_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
