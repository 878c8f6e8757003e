// DCNv2 backward with the offset conv fused in, for Hopper (sm_90a): the
// bfloat16 layer. Six kernels and fixed-order sums, launched back to back
// on one stream; no float is added by an atomic, so every call on the same
// inputs gives the same bits.
//
// Replaces the TPU kernel `_dcn_fused_bwd_kernel`
// (centernet_uda_tpu/ops/dcn_pallas.py, driven by
// `dcn_v2_pallas_bwd_lanes_fused`), which recomputes om, runs the sampling
// backward of `_dcn_bwd_params_kernel`, and then the offset conv's own
// backward, with one whole-image dx accumulator resident in VMEM across its
// sequential grid. Hopper blocks run in parallel and in no order, so the
// work splits by what each product reduces over, and each sum gets one
// owner. Every product runs on the tensor cores (ldmatrix + mma.sync
// m16n8k16, bf16 operands, f32 accumulators):
//
// 1. dcn_fused_om_kernel: om (B, 27, H, W) f32 by the tile routine of
//    dcn_fused.cuh, one block per 8 x 8 tile.
// 2. dcn_sample_data_kernel<OffsetConv> (dcn_sample_bwd.cuh, shared with
//    the explicit-offset backward): one block per (tile, image, slice of
//    Cin). The tile's g stays in shared memory; per tap and chunk of 64
//    channels, gcol_t = g . W_t^T on mma.sync, rounded to bf16 and stored
//    to a (B, H, W, 9, Cp) scratch; then the corner contraction e_k =
//    x_corner . gcol, and from it dz = d(loss)/d(om) (B, 27, H, W) f32: the
//    dy gradient zeroed where |dy_raw| >= max_shift, the dx gradient, the
//    mask gradient times sigmoid (1 - sigmoid). Where B * tiles gives too
//    few blocks, Cin is split across blocks; each slice stores its share of
//    dz in its own plane and dcn_sum_planes_kernel adds them in order.
// 3. dcn_sample_bucket_kernel<OffsetConv>: each source tile's samples in
//    segments by the destination tiles of their corners, at ranks fixed by
//    the shape and the data.
// 4. dcn_sample_dx_kernel<OffsetConv>: dx into a channels-last f32
//    scratch, each element written once by the block that owns its (tile,
//    64 channels): m * corner weight * gcol added over its segments'
//    samples whose corners fall in the tile, in segment order.
// 5. dcn_sample_weight_kernel<OffsetConv>: split-K over the B*H*W pixels.
//    A block owns (tap, Cin tile of 64, slice of pixels) and a group of up
//    to 256 output channels, stages the sampled columns u_t = m * sample
//    (bf16), g, and, in the blocks of the first channel group, the
//    tap-shifted plain x and bf16-rounded dz, and runs u^T . g -> dW[t] and
//    x_t^T . dz -> dW_om[t]; one block a slice sums dz, unrounded, for
//    db_om. Each slice stores its record, and dcn_sum_planes_kernel adds the
//    records in slice order.
// 6. dcn_fused_om_dgrad_kernel: dx += conv_transpose(dz, W_om), the
//    implicit GEMM [64 pixels x 9*32] . [9*32 x 64 channels] over a 10 x 10
//    halo of bf16-rounded dz, added into the same dx scratch after launch
//    4 (one owner per element).
// dx is rounded to bf16 once, by the wrapper, after both parts are in. As
// on the TPU, dz is rounded to bf16 for the two offset-conv products and
// enters db_om unrounded, and the W_om operand is bf16.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// the contractions, 2*N*9*Cin*(2*Cout+2*27) FLOP, over the bf16
// tensor-core rate take 0.056 ms at 64 -> 64 @128, batch 16; the seven
// launches take 0.10 (om), 0.71 (data), 0.08 (bucket), 0.64 (dx), 0.97
// (weight), 0.008 (sum) and 0.16 (om dgrad) ms there, 2.87 ms with the
// wrapper's staging, against 0.38 for cuDNN's backward of the bf16 conv of
// Cin -> Cout + 27.
// - The dx kernel is bound by its adds: one 128-byte gcol load per corner
//   (tools/fused_dcn_ablation.py times a copy without the adds, and one
//   without the data kernel's gcol store). Its work does not grow with the
//   offsets' spread: 0.61-0.62 ms at std 2 to 8 px and 0.51 at 16
//   (tools/dcn_offset_spread.py). Slower designs (PERF.md): one hit at a
//   time on 8 lanes of 32 (2.35 ms), every source tile whose corners
//   reach the tile as candidates (0.88 ms at std 2, 1.92 at 16).
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
// and the dx kernel finished it before this launch.
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

// Channels of Cin per block of the data kernel for this shape (less than Cp
// where it splits Cin, and dz then goes through `dz_parts`), or minus a
// cudaError_t.
int dcn_fused_bwd_data_cin_per_block(int B, int H, int W, int Cp) {
  return dcn::data_cin_per_block(B, H, W, Cp);
}

// 32-bit words of the bucket scratch for this shape, or -1 where max_shift
// is not a finite number below 2^20.
long long dcn_fused_bwd_bucket_words(int B, int H, int W, float max_shift) {
  return dcn::bucket_words(B, H, W, max_shift);
}

// Launches the backward on `stream`; returns the first cudaError_t. x, wom
// and wt in the layouts of dcn_fused.cuh (Cp a multiple of 8); om and dz
// are (B, 27, H, W) f32 scratch, dz_parts one such plane per Cin slice
// where the data kernel splits Cin; dx (B, H, W, Cp) f32; dw receives dW
// (9, Cp, Cout), dW_om (9, Cp, 27) and db_om (27), f32, one after the
// other, and dw_parts one such record per slice of `pix_per_block` pixels
// (a multiple of 64); gcol (B, H, W, 9, Cp) bf16 scratch; bucket
// dcn_fused_bwd_bucket_words 32-bit words of scratch. No output needs
// zeroing.
int dcn_fused_bwd(const void* x, const void* wom, const void* bom,
                  const void* wt, const void* g, void* om, void* dz,
                  void* dz_parts, void* dx, void* dw, void* dw_parts,
                  void* gcol, void* bucket, int B, int H, int W, int Cp,
                  int Cout, float max_shift, int pix_per_block,
                  void* stream) {
  using namespace dcn;
  if (B == 0 || H == 0 || W == 0 || Cp == 0 || Cout == 0)
    return (int)cudaSuccess;
  if (Cp % 8 != 0 || pix_per_block <= 0 || pix_per_block % kKp2 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const __nv_bfloat16* gb = (const __nv_bfloat16*)g;
  __nv_bfloat16* gcolb = (__nv_bfloat16*)gcol;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  const int ci_tiles = (Cp + kWc64 - 1) / kWc64;
  if (tiles > 0x7fffffffLL || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int per_block = data_cin_per_block(B, H, W, Cp);
  if (per_block < 0) return -per_block;
  const bool split = per_block < Cp;
  if (split && dz_parts == nullptr) return (int)cudaErrorInvalidValue;
  const size_t n_dz = (size_t)B * kOm * H * W;
  // the data kernel writes dz, or its slices' planes; the rest read dz
  const OffsetConv geom{(const float*)om, (float*)dz};
  const OffsetConv to{(const float*)om, (float*)(split ? dz_parts : dz)};

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
    err = launch_sample_data(xb, to, (const __nv_bfloat16*)wt, gb, gcolb, B,
                             H, W, Cp, Cout, per_block, n_dz, max_shift, s);
  if (err == cudaSuccess && split)
    err = launch_sum_planes((const float*)dz_parts,
                            (Cp + per_block - 1) / per_block,
                            (long long)n_dz, (float*)dz, s);
  if (err == cudaSuccess)
    err = launch_sample_dx(geom, gcolb, (int*)bucket, (float*)dx, B, H, W,
                           Cp, max_shift, s);
  if (err == cudaSuccess)
    err = launch_sample_weight(xb, geom, gb, (float*)dw_parts, (float*)dw,
                               B, H, W, Cp, Cout, max_shift, pix_per_block,
                               s);
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
