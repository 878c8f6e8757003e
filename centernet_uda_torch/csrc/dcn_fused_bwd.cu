// DCNv2 backward with the offset conv fused in, for Hopper (sm_90a): the
// bfloat16 layer. Four kernels, launched back to back on one stream.
//
// Replaces the TPU kernel `_dcn_fused_bwd_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by
// `dcn_v2_pallas_bwd_lanes_fused`), which recomputes om, runs the sampling
// backward of `_dcn_bwd_params_kernel`, and then the offset conv's own
// backward, with one whole-image dx accumulator resident in VMEM across its
// sequential grid. Hopper blocks run in parallel, so the work splits by
// what each product reduces over. Every product runs on the tensor cores
// (ldmatrix + mma.sync m16n8k16, bf16 operands, f32 accumulators):
//
// 1. dcn_fused_om_kernel: om (B, 27, H, W) f32 by the tile routine of
//    dcn_fused.cuh, one block per 8 x 8 tile.
// 2. dcn_sample_data_kernel<OffsetConv> (dcn_sample_bwd.cuh, shared with
//    the explicit-offset backward): one block per (tile, image, slice of
//    Cin). The tile's g stays in shared memory; per tap and chunk of 64
//    channels, gcol_t = g . W_t^T on mma.sync, rounded to bf16; then the
//    corner contraction e_k = x_corner . gcol and dx += m * corner weight *
//    gcol by 16-byte vector reductions (red.global.add.v4.f32) into a
//    zeroed channels-last f32 scratch. From e_k, dz = d(loss)/d(om) (B, 27,
//    H, W) f32: the dy gradient zeroed where |dy_raw| >= max_shift, the dx
//    gradient, the mask gradient times sigmoid (1 - sigmoid). Where B *
//    tiles gives too few blocks, Cin is split across blocks and each adds
//    its share of dz into a zeroed dz by atomics.
// 3. dcn_sample_weight_kernel<OffsetConv>: split-K over the B*H*W pixels.
//    A block owns (tap, Cin tile of 64, slice of pixels) and a group of up
//    to 256 output channels, stages the sampled columns u_t = m * sample
//    (bf16), g, and, in the blocks of the first channel group, the
//    tap-shifted plain x and bf16-rounded dz, and runs u^T . g -> dW[t] and
//    x_t^T . dz -> dW_om[t]; the f32 partials go out by atomics. One column
//    of blocks sums dz, unrounded, for db_om.
// 4. dcn_fused_om_dgrad_kernel: dx += conv_transpose(dz, W_om), the
//    implicit GEMM [64 pixels x 9*32] . [9*32 x 64 channels] over a 10 x 10
//    halo of bf16-rounded dz, added into the same dx scratch after launch
//    2 (one owner per element, no atomics).
// dx is rounded to bf16 once, by the wrapper, after both parts are in. As
// on the TPU, dz is rounded to bf16 for the two offset-conv products and
// enters db_om unrounded, and the W_om operand is bf16.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// the contractions, 2*N*9*Cin*(2*Cout+2*27) FLOP, over the bf16
// tensor-core rate take 0.056 ms at 64 -> 64 @128, batch 16; the four
// launches take 0.10 (om), 1.62 (data), 0.96 (weight) and 0.16 (om
// dgrad) ms there, 3.11 ms with the wrapper's staging, against 8.13 for
// the CUDA-core version they replace and 0.38 for cuDNN's backward of the
// bf16 conv of Cin -> Cout + 27.
// - The data kernel is bound by its dx reductions: 151 M 16-byte
//   reductions a call at that shape (tools/fused_dcn_ablation.py times a
//   copy without them). Two ways to make fewer were tried and were slower
//   at 64 -> 64 @128 and 256 -> 256 @64: a shared f32 dx accumulator over
//   the tile and 3 pixels around it, filled by atomicAdd (a shared f32
//   atomicAdd compiles to a compare-and-swap loop, ATOMS.CAST.SPIN, on
//   sm_90a), and one whose channels each warp owns, its lanes taking turns
//   where they meet (its 8-byte corner loads and 32-channel blocks cost
//   more than the reductions saved). A third, merging into one reduction
//   the corners that neighbouring pixels of a warp share, saved under a
//   tenth of the kernel's time even with smooth offsets, and was dropped
//   too.
// - The weight kernel is bound by the latency of its 64-pixel steps
//   (tables, then staging and gather, then mma, each behind a barrier).
// PERF.md has every path shape.
#include "dcn_sample_bwd.cuh"

namespace dcn {

// ---------------------------------------------------------------------------
// 1. om recompute

constexpr size_t kOmKernelBytes = kTileOmBytes + 16 + kOmStageBytes;

__global__ void __launch_bounds__(kThreads)
    dcn_fused_om_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wom,
                        const float* __restrict__ bom,
                        float* __restrict__ om,  // (B, 27, H, W)
                        int H, int W, int Cp, int tiles_x) {
  DCN_DYNAMIC_SMEM(smem);
  float* s_om = (float*)smem;
  unsigned* s_max = (unsigned*)(smem + kTileOmBytes);
  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const size_t HW = (size_t)H * W;
  om_tile(x + (size_t)b * HW * Cp, wom, bom, y0, x0, H, W, Cp,
          smem + kTileOmBytes + 16, s_om, s_max, nullptr);
  for (int i = threadIdx.x; i < kOm * kTilePix; i += kThreads) {
    const int o = i / kTilePix, p = i % kTilePix;
    const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
    if (y < H && xx < W)
      om[((size_t)b * kOm + o) * HW + (size_t)y * W + xx] =
          s_om[p * kOmPitch + o];
  }
}

// ---------------------------------------------------------------------------
// 4. dx += conv_transpose(dz, W_om)

constexpr size_t kDgradHalo = (size_t)kHaloPix * kOmWPitch * 2;  // 8000
constexpr size_t kDgradBytes =
    kDgradHalo + (size_t)kTaps * kWc64 * kOmWPitch * 2;

// One block per (tile, Cin tile of 64, image); warps 4 along the pixels x
// 2 along the channels (32 each). Each (pixel, channel) of dx has one owner,
// and the data kernel's reductions finished before this launch.
__global__ void __launch_bounds__(kThreads)
    dcn_fused_om_dgrad_kernel(const float* __restrict__ dz,  // (B,27,H,W)
                              const __nv_bfloat16* __restrict__ wom,
                              float* __restrict__ dx,  // (B, H, W, Cp)
                              int H, int W, int Cp, int tiles_x) {
  DCN_DYNAMIC_SMEM(smem);
  __nv_bfloat16* s_dz = (__nv_bfloat16*)smem;  // [halo pixel][output]
  __nv_bfloat16* s_w = (__nv_bfloat16*)(smem + kDgradHalo);  // [t][c][o]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int ci0 = blockIdx.y * kWc64;
  const size_t HW = (size_t)H * W;

  for (int i = tid; i < kTaps * kWc64 * (kOmN / 8); i += kThreads) {
    const int v = i % (kOmN / 8);
    const int r = (i / (kOmN / 8)) % kWc64;
    const int t = i / (kWc64 * (kOmN / 8));
    const bool ok = ci0 + r < Cp;
    cp_async16(s_w + (t * kWc64 + r) * kOmWPitch + 8 * v,
               ok ? wom + ((size_t)t * Cp + ci0 + r) * kOmN + 8 * v : wom,
               ok);
  }
  cp_async_commit();
  // the forward read x at (y + ti - 1, x + tj - 1) for om at (y, x), so
  // pixel (y, x) of dx receives dz from (y - ti + 1, x - tj + 1): the halo
  // runs from y0 - 1 to y0 + 8
  for (int i = tid; i < kOmN * kHaloPix; i += kThreads) {
    const int o = i / kHaloPix, hp = i % kHaloPix;
    const int yy = y0 - 1 + hp / kHaloW, xx = x0 - 1 + hp % kHaloW;
    float v = 0.f;
    if (o < kOm && yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = dz[((size_t)b * kOm + o) * HW + (size_t)yy * W + xx];
    s_dz[hp * kOmWPitch + o] = __float2bfloat16(v);
  }
  cp_async_wait<0>();
  __syncthreads();

  const LdRows ld;
  const int pa = 16 * wm + ld.a_row();
  const int pay = pa / kTileW, pax = pa % kTileW;
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const __nv_bfloat16* arow =
        s_dz + ((pay + 2 - t / 3) * kHaloW + pax + 2 - t % 3) * kOmWPitch +
        ld.a_k();
    const __nv_bfloat16* brow =
        s_w + (t * kWc64 + 32 * wn + ld.bn_row()) * kOmWPitch + ld.bn_k();
#pragma unroll
    for (int ks = 0; ks < kOmN; ks += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + ks);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, brow + 16 * np * kOmWPitch + ks);
        mma_bf16_16816(acc[2 * np], a, bq[0], bq[1]);
        mma_bf16_16816(acc[2 * np + 1], a, bq[2], bq[3]);
      }
    }
  }

  const int g4 = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 16 * wm + g4 + 8 * (i >> 1);
      const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
      const int c = ci0 + 32 * wn + 8 * n + 2 * q + (i & 1);
      if (y < H && xx < W && c < Cp)
        dx[((size_t)b * HW + (size_t)y * W + xx) * Cp + c] += acc[n][i];
    }
}

}  // namespace dcn

extern "C" {

// Launches the four backward kernels on `stream`; returns the first
// cudaError_t. x, wom and wt in the layouts of dcn_fused.cuh (Cp a multiple
// of 8); om and dz are (B, 27, H, W) f32 scratch, dz zeroed; dx (B, H, W,
// Cp), dw (9, Cp, Cout), dwom (9, Cp, 27) and dbom (27) f32, zeroed.
// `pix_per_block` is the weight kernel's split-K slice, a multiple of 64.
int dcn_fused_bwd(const void* x, const void* wom, const void* bom,
                  const void* wt, const void* g, void* om, void* dz, void* dx,
                  void* dw, void* dwom, void* dbom, int B, int H, int W,
                  int Cp, int Cout, float max_shift, int pix_per_block,
                  void* stream) {
  using namespace dcn;
  if (B == 0 || H == 0 || W == 0 || Cp == 0 || Cout == 0)
    return (int)cudaSuccess;
  if (Cp % 8 != 0 || pix_per_block <= 0 || pix_per_block % kKp2 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const __nv_bfloat16* gb = (const __nv_bfloat16*)g;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  const int ci_tiles = (Cp + kWc64 - 1) / kWc64;
  if (tiles > 0x7fffffffLL || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const OffsetConv geom{(const float*)om, (float*)dz};

  cudaError_t err = prepare_launch(dcn_fused_om_kernel, kOmKernelBytes);
  if (err == cudaSuccess)
    err = prepare_launch(dcn_fused_om_dgrad_kernel, kDgradBytes);
  if (err != cudaSuccess) return (int)err;

  dcn_fused_om_kernel<<<dim3((unsigned)tiles, 1, B), kThreads, kOmKernelBytes,
                        s>>>(xb, (const __nv_bfloat16*)wom,
                             (const float*)bom, (float*)om, H, W, Cp,
                             tiles_x);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_sample_data(xb, geom, (const __nv_bfloat16*)wt, gb,
                             (float*)dx, B, H, W, Cp, Cout, max_shift, s);
  if (err == cudaSuccess)
    err = launch_sample_weight(xb, geom, gb, (float*)dw, (float*)dwom,
                               (float*)dbom, B, H, W, Cp, Cout, max_shift,
                               pix_per_block, s);
  if (err != cudaSuccess) return (int)err;

  dcn_fused_om_dgrad_kernel<<<dim3((unsigned)tiles, ci_tiles, B), kThreads,
                              kDgradBytes, s>>>(
      (const float*)dz, (const __nv_bfloat16*)wom, (float*)dx, H, W, Cp,
      tiles_x);
  return (int)cudaGetLastError();
}

const char* dcn_fused_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
