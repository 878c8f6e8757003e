// DCNv2 backward for Hopper (sm_90a) at the "select" shapes (Cin > 512,
// W > 256, W < 8), x and g in float32 or bfloat16: four kernels and
// fixed-order sums, launched back to back, every product on the tensor
// cores, no float added by an atomic.
//
// Replaces the TPU kernel `_sel_bwd_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by
// `dcn_v2_pallas_bwd_select`), which produces every gradient in one pass:
// per (tap, row shift) three batched one-hot select matmuls share one
// modulated select matrix, dx accumulates in a whole-image f32 VMEM block
// across the image's sequential row blocks, and dW in a (9, Cin, Cout) VMEM
// accumulator across the grid. Hopper blocks run in parallel and in no
// order, so, as in dcn_bwd.cu, the work splits by what each product
// reduces over, and each sum gets one owner: the same kernels of
// dcn_sample_bwd.cuh over the `OffsetMask` geometry, under the `Select`
// tag (so a profile names them apart from dcn_bwd.cu's):
//
// dcn_sample_data_kernel: per (8 x 8 pixel tile, image, slice of Cin):
//   gcol_t = g . W_t^T on mma.sync (g in bf16: the wrapper rounds a float32
//   g once, as the TPU kernel stages it), stored to a bf16 scratch, and
//   doffset / dmask from the corner contraction (both y-corners enter d(dy)
//   at integer positions; d(dy) = 0 where |dy_raw| >= max_shift; dx is
//   exact, so d(dx) is never gated). At MobileNetV2's 1280 -> 256 the maps
//   are small (16 x 16 at 512 px, 25 x 25 at 800 px), so Cin is split
//   across blocks until about two blocks fall on each SM; each slice then
//   stores its share of the sampling gradients in its own plane, and
//   dcn_sum_planes_kernel adds the planes in slice order.
// dcn_sample_bucket_kernel and dcn_sample_dx_kernel: the samples in
//   segments by destination tile, then dx, each element written once by
//   the block that owns its (tile, 64 channels), the sum in segment order
//   (see dcn_sample_bwd.cuh).
// dcn_sample_weight_kernel: dW as a split-K product over the B*H*W pixels
//   on mma.sync, a block covering all 256 output channels, each slice of
//   pixels storing its own record, added in slice order by
//   dcn_sum_planes_kernel.
//
// The wrapper rounds dx to x's dtype once, after its sums are in, and
// returns dW in the weight's dtype (bf16 on the bf16 layer's route, as
// `dcn_v2_pallas_bwd_select` casts it).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// at 1280 -> 256 @16 x 16, batch 32, the two contractions (96.6 GFLOP)
// over the bf16 tensor-core rate, 0.098 ms. One call takes 1.91-1.94 ms
// (a bf16 call: data kernel 0.65, the sampling gradients' sum 0.003,
// bucket kernel 0.01, dx kernel 0.34, weight kernel 0.67, its sum 0.02);
// at 25 x 25, batch 4, 0.94 ms against the plain twin's 7.7. The data
// and weight kernels are bound by the latency of their steps. PERF.md has
// every path shape.
#include "dcn_sample_bwd.cuh"

extern "C" {

// Channels of Cin per block of the data kernel for this shape (less than Cp
// where it splits Cin, and the sampling gradients then go through
// `grads_parts`), or minus a cudaError_t.
int dcn_sel_bwd_data_cin_per_block(int B, int H, int W, int Cp) {
  return dcn::data_cin_per_block(B, H, W, Cp);
}

// 32-bit words of the bucket scratch for this shape, or -1 where max_shift
// is not a finite number below 2^20.
long long dcn_sel_bwd_bucket_words(int B, int H, int W, float max_shift) {
  return dcn::bucket_words(B, H, W, max_shift);
}

// Launches the backward on `stream`; returns the first cudaError_t. x (B,
// H, W, Cp) and wt (9, Cp, Cop) bf16 in the layouts of dcn_sample_bwd.cuh,
// g (B, Cout, H, W) bf16; dx (B, H, W, Cp) f32; grads (B * 27 * H * W f32:
// doffset, then dmask); grads_parts (a grads-sized plane per Cin slice,
// where the data kernel splits Cin); dw (9, Cp, Cout) f32 and dw_parts (one
// such record per slice of `pix_per_block` pixels, a multiple of 64); gcol
// (B, H, W, 9, Cp) bf16 scratch; bucket <name>_bucket_words 32-bit words
// of scratch. No output needs zeroing.
int dcn_sel_bwd(const void* x, const void* offset, const void* mask,
                const void* wt, const void* g, void* dx, void* grads,
                void* grads_parts, void* dw, void* dw_parts, void* gcol,
                void* bucket, int B, int H, int W, int Cp, int Cout,
                float max_shift, int pix_per_block, void* stream) {
  return dcn::launch_explicit_bwd<dcn::Select>(
      x, offset, mask, wt, g, dx, grads, grads_parts, dw, dw_parts, gcol,
      bucket, B, H, W, Cp, Cout, max_shift, pix_per_block, stream);
}

const char* dcn_sel_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
