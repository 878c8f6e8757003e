// DCNv2 forward for Hopper (sm_90a), the float32 layer.
//
// Replaces the TPU kernel `_dcn_kernel` (centernet_uda_tpu/ops/dcn_pallas.py,
// driven by `dcn_v2_pallas_lanes`). Same function: per output pixel and tap,
// bilinearly sample x at the (dy-clamped) offset position, times the mask,
// staged in bf16; contract with the bf16 W[t] (Cin x Cout) with f32
// accumulation; add the f32 bias; the output stays f32. The TPU
// restructurings (hat matrix, row-shift loop, lane packing, row blocks) are
// not carried over: a gather is cheap here. The kernel is the shared
// tensor-core forward of dcn_sample_fwd.cuh over the `OffsetMask` geometry
// with an f32 output: per 8 x 8 pixel tile, 16-byte corner gathers of the
// channels-last bf16 x into a shared A tile, chunks of 64 channels of W[t]
// by cp.async, mma.sync m16n8k16 into f32 registers, the sampled tile
// gathered once for a group of up to 256 output channels; Cin split across
// blocks where the grid is short (DLA-34's 16 px layer at 512 px; its 25
// and 50 px layers at 800 px).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): at the
// DLA-34 widths the contraction (2*N*Cin*Cout*9 FLOP) over the bf16
// tensor-core rate and the HBM traffic (x, offset, mask, out) are of the
// same order, 0.41 ms over a 512 px step's 16 layers (batch 16); the kernel
// takes 4.75 ms there with the wrapper's staging (cuDNN's f32 conv of the
// same shapes 12.66). At 64 -> 64 @128 it spends 0.360 ms on the card
// against 0.020 for its products at the tensor-core rate: like the fused
// forward it is bound by the gather, four 16-byte corner loads per pixel,
// tap and 8 channels (1.2 GB from L1/L2 a call there), and the barrier
// that closes each chunk step; the staging of x and W adds a pass over x.
#include "dcn_sample_fwd.cuh"

extern "C" {

// Channels of Cin per block for this shape (a multiple of 8; less than Cp
// where Cin is split across blocks), or minus a cudaError_t.
int dcn_fwd_cin_per_block(int B, int H, int W, int Cp, int Cout) {
  return dcn::fwd_cin_per_block(B, H, W, Cp, Cout);
}

// Launches the forward on `stream`; returns the cudaError_t of the launch.
// x (B, H, W, Cp) and wt (9, Cp, Cop) bf16 as dcn_sample_fwd.cuh stages
// them; out (B, Cout, H, W) f32. Where `cin_per_block` < Cp, the slices add
// into `sums` (f32, zeroed; it may be `out`) instead.
int dcn_fwd(const void* x, const void* offset, const void* mask,
            const void* wt, const void* bias, void* out, void* sums, int B,
            int H, int W, int Cp, int Cout, int cin_per_block,
            float max_shift, void* stream) {
  return dcn::launch_explicit_fwd<float>(x, offset, mask, wt, bias, out,
                                         sums, B, H, W, Cp, Cout,
                                         cin_per_block, max_shift, stream);
}

const char* dcn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
