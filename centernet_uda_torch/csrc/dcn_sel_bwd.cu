// DCNv2 backward for Hopper (sm_90a) at the "select" shapes (Cin > 512,
// W > 256, W < 8), for g in float32 or bfloat16: two kernels, launched back
// to back.
//
// Replaces the TPU kernel `_sel_bwd_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by
// `dcn_v2_pallas_bwd_select`), which produces every gradient in one pass:
// per (tap, row shift) three batched one-hot select matmuls share one
// modulated select matrix, dx accumulates in a whole-image f32 VMEM block
// across the image's sequential row blocks, and dW in a (9, Cin, Cout) VMEM
// accumulator across the grid. Hopper blocks run in parallel and in no
// order, so, as in dcn_bwd.cu, the work splits by what each product
// reduces over (bodies in dcn_kernels.cuh, over the `OffsetMask` geometry,
// under the `Select` tag):
//
// dcn_bwd_data_kernel: per (image, 64 pixels): gcol_t = g . W_t^T (g read
//   in its own dtype and rounded to bf16, as the TPU kernel stages it;
//   gcol rounded to bf16), dx by f32 atomics into a zeroed channels-last
//   scratch, and doffset / dmask from the corner contraction (both
//   y-corners enter d(dy) at integer positions; d(dy) = 0 where
//   |dy_raw| >= max_shift; dx is exact, so d(dx) is never gated).
// dcn_bwd_weight_kernel: dW as a split-K GEMM over the B*H*W pixels, f32
//   atomics into dW. At 9 x 1280 x 256 there are 720 (tap, Cin tile, Cout
//   tile) tiles; the wrapper's `_dw_pixels_per_block` splits the pixels so
//   about 2048 blocks are in flight.
//
// The wrapper rounds dx to x's dtype once, after every atomic is in, and
// returns dW in the weight's dtype (bf16 on the bf16 layer's route, as
// `dcn_v2_pallas_bwd_select` casts it).
//
// Bound on the H100: at MobileNetV2's 1280 -> 256 @16x16, batch 32, the two
// contractions (96.6 GFLOP) over the bf16 tensor-core rate, 0.098 ms. This
// version runs both on the f32 CUDA cores and recomputes the sampling in
// both kernels, so it is compute-bound far above that bound. With 256
// pixels an image, the data kernel has only B * 4 blocks, each looping over
// all 1280 channels in 20 chunks.
#include "dcn_kernels.cuh"

namespace {

template <typename GT>
int launch(const void* x, const void* offset, const void* mask,
           const void* wt_t, const void* g, void* dx, void* doff,
           void* dmask, void* dw, int B, int H, int W, int Cin, int Cout,
           float max_shift, int pix_per_block, cudaStream_t s) {
  using namespace dcn;
  auto data_kernel = dcn_bwd_data_kernel<OffsetMask, GT, Select>;
  auto weight_kernel = dcn_bwd_weight_kernel<OffsetMask, GT, Select>;
  cudaError_t err = check_launch(data_kernel);
  if (err == cudaSuccess) err = check_launch(weight_kernel);
  if (err != cudaSuccess) return (int)err;
  const OffsetMask geom{(const float*)offset, (const float*)mask,
                        (float*)doff, (float*)dmask};

  const long long n_total = (long long)B * H * W;
  const long long splits = (n_total + pix_per_block - 1) / pix_per_block;
  const long long tiles =
      (long long)((Cin + kWc - 1) / kWc) * ((Cout + kWo - 1) / kWo);
  if (B > 65535 || splits > 0x7fffffffLL || tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;

  const dim3 grid_d((H * W + kPix - 1) / kPix, B);
  data_kernel<<<grid_d, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, geom, (const __nv_bfloat16*)wt_t,
      (const GT*)g, (float*)dx, H, W, Cin, Cout, max_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_w((unsigned)splits, (unsigned)tiles, kTaps);
  weight_kernel<<<grid_w, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, geom, (const GT*)g, (float*)dw, B, H, W, Cin,
      Cout, max_shift, pix_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both backward kernels on `stream`; returns the first
// cudaError_t. dx (B, H, W, Cin) f32 and dw (9, Cin, Cout) f32 must be
// zeroed by the caller; `g_bf16` says g (B, Cout, H, W) is bf16, else f32.
int dcn_sel_bwd(const void* x, const void* offset, const void* mask,
                const void* wt_t, const void* g, void* dx, void* doff,
                void* dmask, void* dw, int B, int H, int W, int Cin,
                int Cout, float max_shift, int pix_per_block, int g_bf16,
                void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cin == 0 || Cout == 0)
    return (int)cudaSuccess;
  if (pix_per_block <= 0 || pix_per_block % dcn::kKp != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (g_bf16)
    return launch<__nv_bfloat16>(x, offset, mask, wt_t, g, dx, doff, dmask,
                                 dw, B, H, W, Cin, Cout, max_shift,
                                 pix_per_block, s);
  return launch<float>(x, offset, mask, wt_t, g, dx, doff, dmask, dw, B, H,
                       W, Cin, Cout, max_shift, pix_per_block, s);
}

const char* dcn_sel_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
