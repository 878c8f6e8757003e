// DCNv2 forward for Hopper (sm_90a) with both offsets clamped: the JAX
// package's wide maps (W > 256) under a forced "lanes" kernel generation;
// x float32 or bfloat16.
//
// Replaces the TPU kernel `_dcn_kernel` in panel mode
// (centernet_uda_tpu/ops/dcn_pallas.py, `panel_wp > 0`, driven by
// `_dcn_v2_pallas_wide`). There the width is cut into overlapping 128-lane
// panels, each keeping its middle columns, and the horizontal offset is
// clamped to +-max_shift like the vertical one so no kept column samples
// outside its panel. The panels are a lane-width device of the TPU; the
// clamp is the function. This source runs the shared tensor-core forward of
// dcn_sample_fwd.cuh over the whole width with `kClampDx` set: dx is
// clamped to +-max_shift before the sample position is formed, exactly as
// dy is, in the sampling tables. Everything else is dcn_fwd.cu's: bf16
// samples, bf16 W, f32 accumulation, the f32 bias, the output in x's dtype
// (`out_bf16`); a ragged last tile (W = 300) masks its columns.
//
// The backward of this route is not a kernel on either side: the JAX
// package differentiates the exact op on clipped offsets there
// (centernet_uda_tpu/ops/dcn.py, `_dcn_pallas_bwd`), and so does the port
// (ops/dcn_cuda.py, `_DCNWideFn`).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): at
// DLA-34's 64 -> 64 @272x272, batch 4 (the 1088 px eval), the HBM traffic
// of x, offsets, mask and out (0.055 ms) is above the contraction's time
// at the bf16 tensor-core rate. The grid is full there (1156 tiles x 4
// images), so Cin is not split and the channel group not narrowed; the
// kernel takes 0.51 ms a layer with the wrapper's staging, bound like
// dcn_fwd.cu by the gather (four 16-byte corner loads per pixel, tap and 8
// channels) and the staging passes over x.
#include "dcn_sample_fwd.cuh"

extern "C" {

// Channels of Cin per block for this shape (a multiple of 8; less than Cp
// where Cin is split across blocks), or minus a cudaError_t.
int dcn_wide_fwd_cin_per_block(int B, int H, int W, int Cp, int Cout) {
  return dcn::fwd_cin_per_block(B, H, W, Cp, Cout);
}

// Launches the forward on `stream`; returns the cudaError_t of the launch.
// Operands as dcn_sel_fwd's.
int dcn_wide_fwd(const void* x, const void* offset, const void* mask,
                 const void* wt, const void* bias, void* out, void* parts,
                 int B, int H, int W, int Cp, int Cout, int cin_per_block,
                 float max_shift, int out_bf16, void* stream) {
  using namespace dcn;
  if (out_bf16)
    return launch_explicit_fwd<__nv_bfloat16, true>(
        x, offset, mask, wt, bias, out, parts, B, H, W, Cp, Cout,
        cin_per_block, max_shift, stream);
  return launch_explicit_fwd<float, true>(x, offset, mask, wt, bias, out,
                                          parts, B, H, W, Cp, Cout,
                                          cin_per_block, max_shift, stream);
}

const char* dcn_wide_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
