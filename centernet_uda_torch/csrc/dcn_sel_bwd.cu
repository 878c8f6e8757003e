// DCNv2 backward for Hopper (sm_90a) at the "select" shapes (Cin > 512,
// W > 256, W < 8), x and g in float32 or bfloat16: two kernels, launched
// back to back, every product on the tensor cores.
//
// Replaces the TPU kernel `_sel_bwd_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by
// `dcn_v2_pallas_bwd_select`), which produces every gradient in one pass:
// per (tap, row shift) three batched one-hot select matmuls share one
// modulated select matrix, dx accumulates in a whole-image f32 VMEM block
// across the image's sequential row blocks, and dW in a (9, Cin, Cout) VMEM
// accumulator across the grid. Hopper blocks run in parallel and in no
// order, so, as in dcn_bwd.cu, the work splits by what each product
// reduces over: the same two kernels of dcn_sample_bwd.cuh over the
// `OffsetMask` geometry, under the `Select` tag (so a profile names them
// apart from dcn_bwd.cu's):
//
// dcn_sample_data_kernel: per (8 x 8 pixel tile, image, slice of Cin):
//   gcol_t = g . W_t^T on mma.sync (g in bf16: the wrapper rounds a float32
//   g once, as the TPU kernel stages it), dx by 16-byte vector reductions
//   into a zeroed channels-last f32 scratch, and doffset / dmask from the
//   corner contraction (both y-corners enter d(dy) at integer positions;
//   d(dy) = 0 where |dy_raw| >= max_shift; dx is exact, so d(dx) is never
//   gated). At MobileNetV2's 1280 -> 256 the maps are small (16 x 16 at
//   512 px, 25 x 25 at 800 px), so Cin is split across blocks until about
//   two blocks fall on each SM, and the sampling gradients are then added
//   by atomics.
// dcn_sample_weight_kernel: dW as a split-K product over the B*H*W pixels
//   on mma.sync, a block covering all 256 output channels, f32 atomics into
//   dW.
//
// The wrapper rounds dx to x's dtype once, after every reduction is in, and
// returns dW in the weight's dtype (bf16 on the bf16 layer's route, as
// `dcn_v2_pallas_bwd_select` casts it).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// at 1280 -> 256 @16 x 16, batch 32, the two contractions (96.6 GFLOP)
// over the bf16 tensor-core rate, 0.098 ms. One call takes 1.90 ms in
// either dtype (a bf16 call: data kernel 1.04, weight kernel 0.60), against
// 12.8 for the CUDA-core kernels this replaced; at 25 x 25, batch 4, 0.87
// ms against the plain twin's 7.7. The data kernel is bound by its dx
// reductions, the weight kernel by the latency of its 64-pixel steps.
// PERF.md has every path shape.
#include "dcn_sample_bwd.cuh"

extern "C" {

// Launches both backward kernels on `stream`; returns the first
// cudaError_t. Operands as dcn_bwd's: x (B, H, W, Cp) and wt (9, Cp, Cop)
// bf16, g (B, Cout, H, W) bf16; dx (B, H, W, Cp), doff, dmask and dw (9,
// Cp, Cout) f32, all zeroed.
int dcn_sel_bwd(const void* x, const void* offset, const void* mask,
                const void* wt, const void* g, void* dx, void* doff,
                void* dmask, void* dw, int B, int H, int W, int Cp, int Cout,
                float max_shift, int pix_per_block, void* stream) {
  return dcn::launch_explicit_bwd<dcn::Select>(
      x, offset, mask, wt, g, dx, doff, dmask, dw, B, H, W, Cp, Cout,
      max_shift, pix_per_block, stream);
}

const char* dcn_sel_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
