// DCNv2 forward with the offset conv fused in, for Hopper (sm_90a): the
// bfloat16 layer. One launch.
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
// the block.
//
// Design: the shared tensor-core forward of dcn_sample_fwd.cuh under the
// `OffsetConvTile` geometry (chunks of 32 channels, bf16 out): a block owns
// one 8 x 8 tile of output pixels of one image and a group of up to 256
// output channels; it computes the tile's om with the tensor-core routine
// `om_tile` (dcn_fused.cuh) and folds max |dy| there, builds the nine taps'
// sampling tables from om, then per tap and chunk gathers the samples (16-
// byte corner loads of channels-last x) into a shared A tile and adds A .
// W[t] on mma.sync, the W chunks arriving by cp.async, double-buffered. The
// sampled tile is gathered once per block and used for the block's whole
// channel group. Where B * tiles gives too few blocks for the card (512 ->
// 256 @16, batch 16: 64 tiles), the channel group narrows, down to 32, until
// about two blocks fall on every SM; each group then recomputes the tile's
// om, which costs 27 / group of the contraction (Cin cannot be split here:
// om needs all of it).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// the two contractions, 2*N*9*Cin*(Cout+27) FLOP, over the bf16
// tensor-core rate take 0.028 ms at 64 -> 64 @128, batch 16; the kernel
// takes 0.436 ms there (0.525 with the wrapper's staging), against 2.68
// for the CUDA-core version it replaces and 0.170 for cuDNN's bf16 conv of
// Cin -> Cout + 27. What bounds it is the gather, not the mma issue rate:
// four 16-byte corner loads per pixel, tap and 8 channels (1.2 GB a call
// from L1/L2 at that shape), and each of the 18 chunk steps closed by a
// barrier. PERF.md has every path shape.
#include "dcn_sample_fwd.cuh"

extern "C" {

// One launch on `stream`; returns its cudaError_t. x, wom and wt in the
// layouts of dcn_fused.cuh (Cp a multiple of 8). `stat` (one 32-bit word)
// must be zeroed by the caller; it receives the bits of max |dy| as a
// float.
int dcn_fused_fwd(const void* x, const void* wom, const void* bom,
                  const void* wt, const void* bias, void* out, void* stat,
                  int B, int H, int W, int Cp, int Cout, float max_shift,
                  void* stream) {
  using namespace dcn;
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return (int)cudaSuccess;
  if (Cp <= 0 || Cp % 8 != 0) return (int)cudaErrorInvalidValue;
  const OffsetConvTile geom{(const __nv_bfloat16*)wom, (const float*)bom,
                            (unsigned*)stat};
  return (int)launch_sample_fwd<OffsetConvTile, __nv_bfloat16, kKc>(
      (const __nv_bfloat16*)x, geom, (const __nv_bfloat16*)wt,
      (const float*)bias, (__nv_bfloat16*)out, nullptr, B, H, W, Cp, Cout,
      Cp, max_shift, (cudaStream_t)stream);
}

const char* dcn_fused_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
