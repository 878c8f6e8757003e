// DCNv2 backward for Hopper (sm_90a), the float32 layer: two kernels,
// launched back to back.
//
// Replaces the TPU kernel `_dcn_bwd_params_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by `_bwd_params_call` /
// `dcn_v2_pallas_bwd_lanes`), which produces every gradient in one pass with
// the whole-image dx accumulator resident in VMEM. TPU grid steps run in
// order on one core, so that accumulator needs no atomics; Hopper blocks run
// in parallel, so the work splits in two (bodies in dcn_kernels.cuh, here
// over the `OffsetMask` geometry with f32 g, rounded to bf16 on load):
//
// dcn_bwd_data_kernel: the sampling gradients per (image, 64 pixels): dx by
//   f32 atomics into a zeroed channels-last scratch, doffset and dmask.
// dcn_bwd_weight_kernel: dW as a split-K GEMM over the B*H*W pixels, with
//   f32 atomics into dW.
//
// Bound on the H100: as in the forward, the two contractions over the bf16
// tensor-core rate and the HBM traffic (x, offset, mask, g in; dx, doff,
// dmask out) are of the same order. This version runs both contractions on
// the f32 CUDA cores and recomputes the sampling in both kernels; it is
// compute-bound. The dx atomics are coalesced over channels (channels-last
// scratch), so one warp updates one 128-byte line per corner.
#include "dcn_kernels.cuh"

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
  auto data_kernel = dcn_bwd_data_kernel<OffsetMask, float>;
  auto weight_kernel = dcn_bwd_weight_kernel<OffsetMask, float>;
  cudaError_t err = check_launch(data_kernel);
  if (err != cudaSuccess) return (int)err;
  err = check_launch(weight_kernel);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const OffsetMask geom{(const float*)offset, (const float*)mask,
                        (float*)doff, (float*)dmask};

  const dim3 grid_d((H * W + kPix - 1) / kPix, B);
  if (grid_d.y > 65535) return (int)cudaErrorInvalidConfiguration;
  data_kernel<<<grid_d, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, geom, (const __nv_bfloat16*)wt_t,
      (const float*)g, (float*)dx, H, W, Cin, Cout, max_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n_total = (long long)B * H * W;
  const long long splits = (n_total + pix_per_block - 1) / pix_per_block;
  const long long tiles =
      (long long)((Cin + kWc - 1) / kWc) * ((Cout + kWo - 1) / kWo);
  if (splits > 0x7fffffffLL || tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid_w((unsigned)splits, (unsigned)tiles, kTaps);
  weight_kernel<<<grid_w, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, geom, (const float*)g, (float*)dw, B, H, W,
      Cin, Cout, max_shift, pix_per_block);
  return (int)cudaGetLastError();
}

const char* dcn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
