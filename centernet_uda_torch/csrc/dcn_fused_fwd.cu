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
// Design: a block owns one 8 x 8 tile of output pixels of one image and a
// group of up to 256 output channels (all of Cout when the grid is full
// enough, see below).
//   1. It computes the tile's om into shared memory with the tensor-core
//      routine `om_tile` (dcn_fused.cuh), and folds max |dy| there.
//   2. It builds the tile's sampling tables for the nine taps (corner
//      indices, corner weights with the mask folded in).
//   3. Per tap and chunk of 32 channels, every thread gathers one pixel's 8
//      channels: each corner is one 16-byte load of channels-last x, the
//      four are blended in f32 and rounded to bf16 into a padded shared A
//      tile; the chunk of W[t] for the block's channels arrives by
//      cp.async, double-buffered; ldmatrix and mma.sync m16n8k16 add the
//      chunk into f32 accumulators in registers (8 warps: 4 along the 64
//      pixels x 2 along the channel group, up to 16 x 128 each).
//   4. The epilogue adds the bias, rounds to bf16, stages the tile as
//      [channel][pixel] in shared memory and stores NCHW rows of 8 pixels.
// The sampled tile is gathered once per block and used for the block's
// whole channel group. Where B * tiles gives too few blocks for the card
// (512 -> 256 @16, batch 16: 64 tiles), the channel group narrows, down to
// 32, until about two blocks fall on every SM; each group then recomputes
// the tile's om, which costs 27 / group of the contraction.
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
#include "dcn_fused.cuh"

namespace dcn {

// Shared layout of the forward with a channel group of 16 * kNT:
// [om | sampling tables | max word | region], the region holding in turn
// the om routine's stage, the A tile and two W chunks, and the output tile.
template <int kNT>
struct FwdSmem {
  static constexpr int kCg = 16 * kNT;
  static constexpr int kWPitch = kCg + kRowPad;
  static constexpr int kOutPitch = kTilePix + kRowPad;
  static constexpr size_t kIdx = kTileOmBytes;
  static constexpr size_t kCw = kIdx + (size_t)kTaps * 4 * kTilePix * 4;
  static constexpr size_t kMax = kCw + (size_t)kTaps * 4 * kTilePix * 4;
  static constexpr size_t kRegion = kMax + 16;
  static constexpr size_t kA = 0;
  static constexpr size_t kW = align16((size_t)kTilePix * kChunkPitch * 2);
  static constexpr size_t kWBuf = (size_t)kKc * kWPitch * 2;
  static constexpr size_t kMain = kW + 2 * kWBuf;
  static constexpr size_t kOut = (size_t)kCg * kOutPitch * 2;
  static constexpr size_t kRegionBytes =
      kOmStageBytes > kMain ? (kOmStageBytes > kOut ? kOmStageBytes : kOut)
                            : (kMain > kOut ? kMain : kOut);
  static constexpr size_t kBytes = kRegion + kRegionBytes;
};

template <int kNT>
__global__ void __launch_bounds__(kThreads)
    dcn_fused_fwd_kernel(const __nv_bfloat16* __restrict__ x,    // (B,H,W,Cp)
                         const __nv_bfloat16* __restrict__ wom,  // (9,Cp,32)
                         const float* __restrict__ bom,          // (27)
                         const __nv_bfloat16* __restrict__ wt,   // (9,Cp,Cop)
                         const float* __restrict__ bias,         // (Cout)
                         __nv_bfloat16* __restrict__ out,  // (B,Cout,H,W)
                         unsigned* __restrict__ stat,      // max |dy| bits
                         int H, int W, int Cp, int Cout, int tiles_x,
                         float max_shift) {
  using L = FwdSmem<kNT>;
  constexpr int kCg = L::kCg;
  DCN_DYNAMIC_SMEM(smem);
  float* s_om = (float*)smem;
  int* s_idx = (int*)(smem + L::kIdx);      // [tap][corner][pixel]
  float* s_cw = (float*)(smem + L::kCw);    // corner weight times the mask
  unsigned* s_max = (unsigned*)(smem + L::kMax);
  unsigned char* region = smem + L::kRegion;
  __nv_bfloat16* s_a = (__nv_bfloat16*)(region + L::kA);
  __nv_bfloat16* s_w = (__nv_bfloat16*)(region + L::kW);
  __nv_bfloat16* s_out = (__nv_bfloat16*)region;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int co0 = blockIdx.y * kCg;
  const int Cop = round_up16(Cout);
  const size_t HW = (size_t)H * W;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Cp;

  om_tile(xb, wom, bom, y0, x0, H, W, Cp, region, s_om, s_max, stat);

  for (int i = tid; i < kTaps * kTilePix; i += kThreads) {
    const int t = i / kTilePix, p = i % kTilePix;
    const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
    int* idx = s_idx + t * 4 * kTilePix + p;
    float* cw = s_cw + t * 4 * kTilePix + p;
    if (y < H && xx < W) {
      const Sample s = sample_at(TileOm{s_om + p * kOmPitch}, b, t, y, xx,
                                 H, W, max_shift);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        idx[k * kTilePix] = s.idx[k];
        cw[k * kTilePix] = s.m * s.c[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        idx[k * kTilePix] = -1;
        cw[k * kTilePix] = 0.f;
      }
    }
  }

  const int nchunks = (Cp + kKc - 1) / kKc;
  const int nsteps = kTaps * nchunks;
  // W[t] rows c0.. c0 + 31, the group's columns, into buffer `buf`
  auto load_w = [&](int step, int buf) {
    const int t = step / nchunks, c0 = (step % nchunks) * kKc;
    __nv_bfloat16* dst = s_w + (size_t)buf * kKc * L::kWPitch;
    for (int i = tid; i < kKc * (kCg / 8); i += kThreads) {
      const int r = i / (kCg / 8), v = i % (kCg / 8);
      const int c = c0 + r, co = co0 + 8 * v;
      const bool ok = c < Cp && co < Cop;
      cp_async16(dst + r * L::kWPitch + 8 * v,
                 ok ? wt + ((size_t)t * Cp + c) * Cop + co : wt, ok);
    }
  };

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const LdRows ld;
  const __nv_bfloat16* arow = s_a + (16 * wm + ld.a_row()) * kChunkPitch +
                              ld.a_k();
  const int bcol = 8 * kNT * wn + ld.bk_n();
  // the gather item of this thread: pixel gp, channels 8 * gv .. + 7
  const int gp = tid >> 2, gv = tid & 3;
  static_assert(kTilePix * (kKc / 8) == kThreads, "one gather item a thread");

  load_w(0, 0);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    const int t = s / nchunks;
    const int c = (s % nchunks) * kKc + 8 * gv;
    __syncthreads();  // the tables are written; the last step's mma are
                      // done with s_a and with the buffer loaded next
    if (s + 1 < nsteps) load_w(s + 1, (s + 1) & 1);
    cp_async_commit();
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    if (c < Cp) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = s_idx[(t * 4 + k) * kTilePix + gp];
        const float w = s_cw[(t * 4 + k) * kTilePix + gp];
        if (i < 0 || w == 0.f) continue;
        float xv[8];
        unpack_bf16x8(*(const uint4*)(xb + (size_t)i * Cp + c), xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = fmaf(w, xv[e], v[e]);
      }
    }
    *(uint4*)(s_a + gp * kChunkPitch + 8 * gv) = pack_bf16x8(v);
    cp_async_wait<1>();  // this step's W chunk is in
    __syncthreads();
    const __nv_bfloat16* brow =
        s_w + (size_t)(s & 1) * kKc * L::kWPitch + ld.bk_row() * L::kWPitch +
        bcol;
#pragma unroll
    for (int ks = 0; ks < kKc; ks += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, brow + ks * L::kWPitch + 16 * np);
        mma_bf16_16816(acc[2 * np], a, bq[0], bq[1]);
        mma_bf16_16816(acc[2 * np + 1], a, bq[2], bq[3]);
      }
    }
  }

  __syncthreads();  // every mma is done with the region
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 16 * wm + g + 8 * (i >> 1);
      const int col = 8 * kNT * wn + 8 * n + 2 * q + (i & 1);
      const int co = co0 + col;
      const float bv = co < Cout ? bias[co] : 0.f;
      s_out[col * L::kOutPitch + p] = __float2bfloat16(acc[n][i] + bv);
    }
  __syncthreads();
  for (int i = tid; i < kCg * kTilePix; i += kThreads) {
    const int col = i / kTilePix, p = i % kTilePix;
    const int co = co0 + col;
    const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
    if (co < Cout && y < H && xx < W)
      out[((size_t)b * Cout + co) * HW + (size_t)y * W + xx] =
          s_out[col * L::kOutPitch + p];
  }
}

template <int kNT>
__host__ int launch_fwd(const void* x, const void* wom, const void* bom,
                        const void* wt, const void* bias, void* out,
                        void* stat, int B, int H, int W, int Cp, int Cout,
                        int tiles_x, int tiles, float max_shift,
                        cudaStream_t s) {
  auto kernel = dcn_fused_fwd_kernel<kNT>;
  const size_t smem = FwdSmem<kNT>::kBytes;
  cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (Cout + 16 * kNT - 1) / (16 * kNT);
  kernel<<<dim3(tiles, groups, B), kThreads, smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wom, (const float*)bom,
      (const __nv_bfloat16*)wt, (const float*)bias, (__nv_bfloat16*)out,
      (unsigned*)stat, H, W, Cp, Cout, tiles_x, max_shift);
  return (int)cudaGetLastError();
}

}  // namespace dcn

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
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  int nt = cout_group_tiles(Cout);
  // narrow the channel group until about two blocks fall on every SM
  while (nt > 2 && too_few_blocks(tiles * B * ((Cout + 16 * nt - 1) /
                                               (16 * nt)), sms))
    nt /= 2;
  if (tiles > 0x7fffffffLL || B > 65535 ||
      (Cout + 16 * nt - 1) / (16 * nt) > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nt) {
    case 16:
      return launch_fwd<16>(x, wom, bom, wt, bias, out, stat, B, H, W, Cp,
                            Cout, tiles_x, (int)tiles, max_shift, s);
    case 8:
      return launch_fwd<8>(x, wom, bom, wt, bias, out, stat, B, H, W, Cp,
                           Cout, tiles_x, (int)tiles, max_shift, s);
    case 4:
      return launch_fwd<4>(x, wom, bom, wt, bias, out, stat, B, H, W, Cp,
                           Cout, tiles_x, (int)tiles, max_shift, s);
    default:
      return launch_fwd<2>(x, wom, bom, wt, bias, out, stat, B, H, W, Cp,
                           Cout, tiles_x, (int)tiles, max_shift, s);
  }
}

const char* dcn_fused_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
