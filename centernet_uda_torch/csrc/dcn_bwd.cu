// DCNv2 backward for Hopper (sm_90a), the float32 layer: two kernels,
// launched back to back, every product on the tensor cores.
//
// Replaces the TPU kernel `_dcn_bwd_params_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by `_bwd_params_call` /
// `dcn_v2_pallas_bwd_lanes`), which produces every gradient in one pass with
// the whole-image dx accumulator resident in VMEM. TPU grid steps run in
// order on one core, so that accumulator needs no atomics; Hopper blocks run
// in parallel, so the work splits by what each product reduces over. Both
// kernels are the bfloat16 layer's sampling backward (dcn_sample_bwd.cuh),
// here over the `OffsetMask` geometry:
//
// dcn_sample_data_kernel: per (8 x 8 pixel tile, image, slice of Cin),
//   gcol_t = g . W_t^T on mma.sync with g resident in shared memory, dx by
//   16-byte vector reductions into a zeroed channels-last f32 scratch, and
//   doffset / dmask from the corner contraction (stored, or added by
//   atomics into zeroed buffers where Cin is split across blocks).
// dcn_sample_weight_kernel: dW as a split-K product over the B*H*W pixels
//   on mma.sync, each sample gathered once per (tap, Cin tile of 64), f32
//   atomics into dW.
//
// The operands are the TPU kernel's: x, W and g in bf16 (the wrapper rounds
// the float32 g once, to nearest even, as the TPU kernel does on load), f32
// accumulation, gcol and the samples rounded to bf16. dx is rounded to x's
// dtype by the wrapper, once, after every reduction is in.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// the bytes it must move (x, offset, mask, g in; dx, doffset, dmask, dW
// out) over HBM's rate, 0.077 ms at 64 -> 64 @128, batch 16, where one
// call takes 2.42 ms: the data kernel 1.62, the weight kernel 0.49 and
// the wrapper's staging (x and g to bf16, zeroed scratch) about 0.3, against
// 4.83 for the CUDA-core kernels this replaced and 1.63 for cuDNN's f32
// convolution backward. As in the fused layer, the data kernel is bound by
// its dx reductions and the weight kernel by the latency of its 64-pixel
// steps. PERF.md has every path shape.
#include "dcn_sample_bwd.cuh"

extern "C" {

// Launches both backward kernels on `stream`; returns the first
// cudaError_t. x (B, H, W, Cp) and wt (9, Cp, Cop) bf16 in the layouts of
// dcn_sample_bwd.cuh, g (B, Cout, H, W) bf16; dx (B, H, W, Cp), doff, dmask
// and dw (9, Cp, Cout) f32, all zeroed. `pix_per_block` is the weight
// kernel's split-K slice, a multiple of 64.
int dcn_bwd(const void* x, const void* offset, const void* mask,
            const void* wt, const void* g, void* dx, void* doff, void* dmask,
            void* dw, int B, int H, int W, int Cp, int Cout, float max_shift,
            int pix_per_block, void* stream) {
  return dcn::launch_explicit_bwd<void>(x, offset, mask, wt, g, dx, doff,
                                        dmask, dw, B, H, W, Cp, Cout,
                                        max_shift, pix_per_block, stream);
}

const char* dcn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
