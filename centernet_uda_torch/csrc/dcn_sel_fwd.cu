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
// tensor-core forward of dcn_sample_fwd.cuh over the `OffsetMask` geometry
// (instantiated under the `Select` tag, so profiles name it apart from
// dcn_fwd.cu's); what is its own is the operand contract, x and out in f32
// or in bf16 (the bf16 layer's explicit-offset route), chosen per call by
// `out_bf16`. A map under one 8 x 8 tile (W < 8) leaves the tile's other
// columns out of the tables and the stores.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): at
// MobileNetV2's 1280 -> 256 @16x16, batch 32, the contraction (2*N*9*Cin*
// Cout = 48.3 GFLOP) over the bf16 tensor-core rate (0.049 ms) is above the
// HBM time of x, offsets, mask and out. The grid is short there (4 tiles x
// 32 images for 132 SMs; 16 x 4 at the 800 px eval): the design splits Cin
// across blocks, so every sample is gathered once and the slices meet in
// their own f32 planes, added in slice order by a second launch, rather
// than narrow the channel group, which
// gathers the tile once per group (0.54 against 0.79 ms there, 0.26
// against 0.65 at the eval shape; tools/fwd_dcn_variants.py). The kernel
// then takes 0.43 ms on the card (113 TFLOP/s), bound by the gather of
// 1280 channels (four 16-byte corner loads per pixel, tap and 8 channels)
// and the 9 x 10 chunk steps of a slice, each closed by a barrier.
#include "dcn_sample_fwd.cuh"

extern "C" {

// Channels of Cin per block for this shape (a multiple of 8; less than Cp
// where Cin is split across blocks), or minus a cudaError_t.
int dcn_sel_fwd_cin_per_block(int B, int H, int W, int Cp, int Cout) {
  return dcn::fwd_cin_per_block(B, H, W, Cp, Cout);
}

// Launches the forward on `stream`; returns the first cudaError_t.
// Operands as dcn_fwd's, `parts` too; `out_bf16` selects a bf16 (B, Cout,
// H, W) output, else f32.
int dcn_sel_fwd(const void* x, const void* offset, const void* mask,
                const void* wt, const void* bias, void* out, void* parts,
                int B, int H, int W, int Cp, int Cout, int cin_per_block,
                float max_shift, int out_bf16, void* stream) {
  using namespace dcn;
  if (out_bf16)
    return launch_explicit_fwd<__nv_bfloat16, false, Select>(
        x, offset, mask, wt, bias, out, parts, B, H, W, Cp, Cout,
        cin_per_block, max_shift, stream);
  return launch_explicit_fwd<float, false, Select>(
      x, offset, mask, wt, bias, out, parts, B, H, W, Cp, Cout, cin_per_block,
      max_shift, stream);
}

const char* dcn_sel_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
