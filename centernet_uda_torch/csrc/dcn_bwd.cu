// DCNv2 backward for Hopper (sm_90a), the float32 layer: four kernels and
// a fixed-order sum, launched back to back, every product on the tensor
// cores, and no float added by an atomic, so every call on the same inputs
// gives the same bits.
//
// Replaces the TPU kernel `_dcn_bwd_params_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by `_bwd_params_call` /
// `dcn_v2_pallas_bwd_lanes`), which produces every gradient in one pass with
// the whole-image dx accumulator resident in VMEM. TPU grid steps run in
// order on one core, so every sum there has one order; Hopper blocks run in
// parallel and in no order, so the work splits by what each product reduces
// over, and each sum gets one owner (dcn_sample_bwd.cuh, shared with the
// bfloat16 layer, here over the `OffsetMask` geometry):
//
// dcn_sample_data_kernel: per (8 x 8 pixel tile, image, slice of Cin),
//   gcol_t = g . W_t^T on mma.sync with g resident in shared memory, stored
//   to a bf16 scratch, and doffset / dmask from the corner contraction
//   (stored, or, where Cin is split across blocks, stored per slice and
//   added in slice order by dcn_sum_planes_kernel).
// dcn_sample_bucket_kernel: per (source 8 x 8 tile, image), its samples
//   in segments by the destination tiles of their corners, at ranks fixed
//   by the shape and the data.
// dcn_sample_dx_kernel: per (destination 8 x 8 tile, image, 64 channels),
//   dx as the sum, in segment order, of m * corner weight * gcol over the
//   segments' samples whose corners fall in the tile, the sample positions
//   recomputed from offset and mask; each element of dx is written once.
// dcn_sample_weight_kernel: dW as a split-K product over the B*H*W pixels
//   on mma.sync, each sample gathered once per (tap, Cin tile of 64), each
//   slice of pixels storing its own record; dcn_sum_planes_kernel adds the
//   records in slice order.
//
// The operands are the TPU kernel's: x, W and g in bf16 (the wrapper rounds
// the float32 g once, to nearest even, as the TPU kernel does on load), f32
// accumulation, gcol and the samples rounded to bf16. dx is rounded to x's
// dtype by the wrapper, once, after its sums are in.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// the bytes it must move (x, offset, mask, g in; dx, doffset, dmask, dW
// out) over HBM's rate, 0.077 ms at 64 -> 64 @128, batch 16, where one
// call takes 2.20 ms: the data kernel 0.71, the bucket kernel 0.07, the dx
// kernel 0.63, the weight kernel 0.51, the sum 0.005 and the wrapper's
// staging the rest, against 1.62 for cuDNN's f32 convolution backward. As in the fused layer, the dx
// kernel is bound by its gcol loads (one per corner) and the weight kernel
// by the latency of its 64-pixel steps. PERF.md has every path shape.
#include "dcn_sample_bwd.cuh"

extern "C" {

// Channels of Cin per block of the data kernel for this shape (less than Cp
// where it splits Cin, and the sampling gradients then go through
// `grads_parts`), or minus a cudaError_t.
int dcn_bwd_data_cin_per_block(int B, int H, int W, int Cp) {
  return dcn::data_cin_per_block(B, H, W, Cp);
}

// 32-bit words of the bucket scratch for this shape, or -1 where max_shift
// is not a finite number below 2^20.
long long dcn_bwd_bucket_words(int B, int H, int W, float max_shift) {
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
int dcn_bwd(const void* x, const void* offset, const void* mask,
            const void* wt, const void* g, void* dx, void* grads,
            void* grads_parts, void* dw, void* dw_parts, void* gcol,
            void* bucket, int B, int H, int W, int Cp, int Cout,
            float max_shift, int pix_per_block, void* stream) {
  return dcn::launch_explicit_bwd<void>(
      x, offset, mask, wt, g, dx, grads, grads_parts, dw, dw_parts, gcol,
      bucket, B, H, W, Cp, Cout, max_shift, pix_per_block, stream);
}

const char* dcn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
