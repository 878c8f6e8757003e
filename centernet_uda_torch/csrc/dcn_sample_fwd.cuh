// The sampling forward of DCNv2 on Hopper's tensor cores (sm_90a), shared by
// the four forward sources: dcn_fwd.cu (the float32 layer), dcn_sel_fwd.cu
// (the "select" shapes), dcn_wide_fwd.cu (dx clamped too) and
// dcn_fused_fwd.cu (the bfloat16 layer with its offset conv inside). One
// kernel, dcn_sample_fwd_kernel, a template over the geometry (`OffsetMask`:
// the explicit offset and mask tensors; `OffsetConvTile`: the offset conv
// computed per tile), the output type (f32 or bf16), the channels per
// staged chunk, `kClampDx` and a tag that only names the instantiation
// (`Select` for dcn_sel_fwd.cu).
//
// A block owns one 8 x 8 tile of output pixels of one image, a group of up
// to 256 output channels and a slice of Cin (all of it unless the grid is
// short, see below).
//   1. Under `OffsetConvTile` it computes the tile's om into shared memory
//      with the tensor-core routine `om_tile` (dcn_fused.cuh) and folds max
//      |dy| there; under `OffsetMask` that step and its shared memory are
//      compiled out.
//   2. It builds the tile's sampling tables for the nine taps (corner
//      indices, corner weights with the mask folded in), from om or from
//      the offset and mask tensors.
//   3. Per tap and chunk of channels, each gather item is one pixel's 8
//      channels: each corner is one 16-byte load of channels-last x, the
//      four are blended in f32 and rounded to bf16 into a padded shared A
//      tile; the chunk of W[t] for the block's channels arrives by
//      cp.async, double-buffered; ldmatrix and mma.sync m16n8k16 add the
//      chunk into f32 accumulators in registers (8 warps: 4 along the 64
//      pixels x 2 along the channel group, up to 16 x 128 each).
//   4. The epilogue adds the f32 bias and stores the output type: the tile
//      staged as [channel][pixel] in shared memory, NCHW rows of 8 pixels
//      out. An f32 output is never rounded to bf16, a bf16 one once.
// Where B * tiles gives too few blocks for the card, the explicit geometry
// first splits Cin across blocks (`fwd_cin_per_block`): each slice adds its
// partial sums, the bias with the first slice's, by f32 atomics into a
// zeroed (B, Cout, H, W) f32 buffer, which the wrapper rounds once where the
// output is bf16; every sample is still gathered once. Then, and alone for
// the fused geometry (its om needs all of Cin), the channel group narrows,
// down to 32, until about two blocks fall on every SM; each group then
// gathers the tile again.
//
// Operands (the wrappers stage them; Cp is Cin rounded up to a multiple of
// 8 with zero channels, so every channel run is whole 16-byte vectors):
//   x   (B, H, W, Cp)   bf16, channels-last
//   wt  (9, Cp, Cop)    bf16, tap-major, Cout padded with zeros to Cop, a
//                       multiple of 16
//   out (B, Cout, H, W) f32 or bf16
// and the geometry: offset (B, 18, H, W) and mask (B, 9, H, W) f32, or the
// offset conv's wom (9, Cp, 32) bf16 and bom (27) f32 (dcn_fused.cuh).
#pragma once

#include <type_traits>

#include "dcn_fused.cuh"

namespace dcn {

// channels per staged chunk of the explicit-offset forwards (the fused one
// keeps kKc, the om routine's chunk)
constexpr int kFwdChunk = 64;

// The fused layer's geometry in the forward: the tile's om comes from x and
// the offset conv's weights by `om_tile`, and max |dy| over the map goes to
// *stat (one zeroed 32-bit word, the bits of a float).
struct OffsetConvTile {
  const __nv_bfloat16* wom;  // (9, Cp, 32)
  const float* bom;          // (27)
  unsigned* stat;
};

template <typename Geom>
constexpr bool kTileOm = std::is_same<Geom, OffsetConvTile>::value;

__host__ __device__ constexpr size_t max_size(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared layout of the forward with a channel group of 16 * kNT and chunks
// of kKs channels: [om | sampling tables | max word | region], the om and
// the max word under the fused geometry only, the region holding in turn
// the om routine's stage, the A tile and two W chunks, and the output tile.
template <int kNT, int kKs, bool kOm, typename OutT>
struct FwdSmem {
  static constexpr int kCg = 16 * kNT;
  static constexpr int kAPitch = kKs + kRowPad;
  static constexpr int kWPitch = kCg + kRowPad;
  // an f32 row of 68 words puts the 4 channels of a fragment store on
  // distinct banks
  static constexpr int kOutPitch =
      kTilePix + (sizeof(OutT) == 4 ? 4 : kRowPad);
  static constexpr size_t kIdx = kOm ? kTileOmBytes : 0;
  static constexpr size_t kCw = kIdx + (size_t)kTaps * 4 * kTilePix * 4;
  static constexpr size_t kMax = kCw + (size_t)kTaps * 4 * kTilePix * 4;
  static constexpr size_t kRegion = kMax + (kOm ? 16 : 0);
  static constexpr size_t kA = 0;
  static constexpr size_t kW = align16((size_t)kTilePix * kAPitch * 2);
  static constexpr size_t kWBuf = (size_t)kKs * kWPitch * 2;
  static constexpr size_t kMain = kW + 2 * kWBuf;
  static constexpr size_t kOut = (size_t)kCg * kOutPitch * sizeof(OutT);
  static constexpr size_t kRegionBytes =
      max_size(kOm ? kOmStageBytes : 0, max_size(kMain, kOut));
  static constexpr size_t kBytes = kRegion + kRegionBytes;
};

template <typename Geom, bool kClampDx>
__device__ __forceinline__ Sample fwd_sample(const Geom& geom,
                                             const float* s_om, int b, int t,
                                             int p, int y, int x, int H,
                                             int W, float max_shift) {
  if constexpr (kTileOm<Geom>)
    return sample_at<TileOm, kClampDx>(TileOm{s_om + p * kOmPitch}, b, t, y,
                                       x, H, W, max_shift);
  else
    return sample_at<Geom, kClampDx>(geom, b, t, y, x, H, W, max_shift);
}

template <typename Geom, typename OutT, int kNT, int kKs,
          bool kClampDx = false, typename Tag = void>
__global__ void __launch_bounds__(kThreads)
    dcn_sample_fwd_kernel(const __nv_bfloat16* __restrict__ x,  // (B,H,W,Cp)
                          const Geom geom,
                          const __nv_bfloat16* __restrict__ wt,  // (9,Cp,Cop)
                          const float* __restrict__ bias,        // (Cout)
                          OutT* __restrict__ out,  // (B, Cout, H, W)
                          float* __restrict__ sums,  // the same, f32, zeroed
                          int H, int W, int Cp, int Cout, int tiles_x,
                          int groups, int cin_per_block, float max_shift) {
  constexpr bool kOm = kTileOm<Geom>;
  using L = FwdSmem<kNT, kKs, kOm, OutT>;
  constexpr int kCg = L::kCg;
  constexpr int kItems = kTilePix * (kKs / 8) / kThreads;
  static_assert(kItems >= 1 && kTilePix * (kKs / 8) == kItems * kThreads,
                "whole gather items a thread");
  DCN_DYNAMIC_SMEM(smem);
  float* s_om = (float*)smem;  // under the fused geometry only
  int* s_idx = (int*)(smem + L::kIdx);    // [tap][corner][pixel]
  float* s_cw = (float*)(smem + L::kCw);  // corner weight times the mask
  unsigned char* region = smem + L::kRegion;
  __nv_bfloat16* s_a = (__nv_bfloat16*)(region + L::kA);
  __nv_bfloat16* s_w = (__nv_bfloat16*)(region + L::kW);
  OutT* s_out = (OutT*)region;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int co0 = (blockIdx.y % groups) * kCg;
  const int slice = blockIdx.y / groups;
  const int cb = slice * cin_per_block;
  const int ce = cb + cin_per_block < Cp ? cb + cin_per_block : Cp;
  const int Cop = round_up16(Cout);
  const size_t HW = (size_t)H * W;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Cp;

  if constexpr (kOm)
    om_tile(xb, geom.wom, geom.bom, y0, x0, H, W, Cp, region, s_om,
            (unsigned*)(smem + L::kMax), geom.stat);

  for (int i = tid; i < kTaps * kTilePix; i += kThreads) {
    const int t = i / kTilePix, p = i % kTilePix;
    const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
    int* idx = s_idx + t * 4 * kTilePix + p;
    float* cw = s_cw + t * 4 * kTilePix + p;
    if (y < H && xx < W) {
      const Sample s = fwd_sample<Geom, kClampDx>(geom, s_om, b, t, p, y, xx,
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

  const int nchunks = (ce - cb + kKs - 1) / kKs;
  const int nsteps = kTaps * nchunks;
  // W[t] rows c0 .. c0 + kKs - 1 of the slice, the group's columns, into
  // buffer `buf`
  auto load_w = [&](int step, int buf) {
    const int t = step / nchunks, c0 = cb + (step % nchunks) * kKs;
    __nv_bfloat16* dst = s_w + (size_t)buf * kKs * L::kWPitch;
    for (int i = tid; i < kKs * (kCg / 8); i += kThreads) {
      const int r = i / (kCg / 8), v = i % (kCg / 8);
      const int c = c0 + r, co = co0 + 8 * v;
      const bool ok = c < ce && co < Cop;
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
  const __nv_bfloat16* arow =
      s_a + (16 * wm + ld.a_row()) * L::kAPitch + ld.a_k();
  const int bcol = 8 * kNT * wn + ld.bk_n();

  load_w(0, 0);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    const int t = s / nchunks;
    const int c0 = cb + (s % nchunks) * kKs;
    __syncthreads();  // the tables are written; the last step's mma are
                      // done with s_a and with the buffer loaded next
    if (s + 1 < nsteps) load_w(s + 1, (s + 1) & 1);
    cp_async_commit();
    // gather item: pixel gp, channels c0 + 8 * gv .. + 7
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int item = tid + r * kThreads;
      const int gp = item / (kKs / 8), gv = item % (kKs / 8);
      const int c = c0 + 8 * gv;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (c < ce) {
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
      *(uint4*)(s_a + gp * L::kAPitch + 8 * gv) = pack_bf16x8(v);
    }
    cp_async_wait<1>();  // this step's W chunk is in
    __syncthreads();
    const __nv_bfloat16* brow = s_w + (size_t)(s & 1) * kKs * L::kWPitch +
                                ld.bk_row() * L::kWPitch + bcol;
#pragma unroll
    for (int ks = 0; ks < kKs; ks += 16) {
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

  const int g = lane >> 2, q = lane & 3;
  if constexpr (!kOm) {
    if ((int)gridDim.y > groups) {  // Cin is split: add this slice's share
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 16 * wm + g + 8 * (i >> 1);
          const int co = co0 + 8 * kNT * wn + 8 * n + 2 * q + (i & 1);
          const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
          if (co < Cout && y < H && xx < W)
            atomicAdd(sums + ((size_t)b * Cout + co) * HW +
                          (size_t)y * W + xx,
                      acc[n][i] + (slice == 0 ? bias[co] : 0.f));
        }
      return;
    }
  }
  __syncthreads();  // every mma is done with the region
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 16 * wm + g + 8 * (i >> 1);
      const int col = 8 * kNT * wn + 8 * n + 2 * q + (i & 1);
      const int co = co0 + col;
      const float bv = co < Cout ? bias[co] : 0.f;
      store(s_out + col * L::kOutPitch + p, acc[n][i] + bv);
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

// ---------------------------------------------------------------------------
// host side

// Channels of Cin per block of the explicit-offset forward: all of Cp, or,
// while the B * tiles * channel-group blocks are short of about two per SM,
// a half, a quarter, ... (whole chunks of kFwdChunk, at least one). A
// negative value is a cudaError_t.
__host__ inline int fwd_cin_per_block(int B, int H, int W, int Cp,
                                      int Cout) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -(int)err;
  const int cg = 16 * cout_group_tiles(Cout);
  const long long blocks = (long long)((W + kTileW - 1) / kTileW) *
                           ((H + kTileH - 1) / kTileH) * B *
                           ((Cout + cg - 1) / cg);
  const int chunks = (Cp + kFwdChunk - 1) / kFwdChunk;
  int splits = 1;
  while (splits * 2 <= chunks && too_few_blocks(blocks * splits, sms))
    splits *= 2;
  return (chunks + splits - 1) / splits * kFwdChunk;
}

template <typename Geom, typename OutT, int kKs, bool kClampDx, typename Tag,
          int kNT>
__host__ cudaError_t launch_sample_fwd_group(
    const __nv_bfloat16* x, const Geom& geom, const __nv_bfloat16* wt,
    const float* bias, OutT* out, float* sums, int B, int H, int W, int Cp,
    int Cout, int tiles_x, int tiles, int slices, int cin_per_block,
    float max_shift, cudaStream_t s) {
  auto kernel = dcn_sample_fwd_kernel<Geom, OutT, kNT, kKs, kClampDx, Tag>;
  const size_t smem = FwdSmem<kNT, kKs, kTileOm<Geom>, OutT>::kBytes;
  cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  const int groups = (Cout + 16 * kNT - 1) / (16 * kNT);
  kernel<<<dim3(tiles, groups * slices, B), kThreads, smem, s>>>(
      x, geom, wt, bias, out, sums, H, W, Cp, Cout, tiles_x, groups,
      cin_per_block, max_shift);
  return cudaGetLastError();
}

// The forward on `s` over slices of `cin_per_block` channels (a multiple of
// 8; `sums` zeroed where that is less than Cp), its channel group fitted to
// Cout and narrowed while the grid is short.
template <typename Geom, typename OutT, int kKs, bool kClampDx = false,
          typename Tag = void>
__host__ cudaError_t launch_sample_fwd(const __nv_bfloat16* x,
                                       const Geom& geom,
                                       const __nv_bfloat16* wt,
                                       const float* bias, OutT* out,
                                       float* sums, int B, int H, int W,
                                       int Cp, int Cout, int cin_per_block,
                                       float max_shift, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  const int slices = (Cp + cin_per_block - 1) / cin_per_block;
  int nt = cout_group_tiles(Cout);
  // narrow the channel group until about two blocks fall on every SM
  while (nt > 2 && too_few_blocks(tiles * B * slices *
                                      ((Cout + 16 * nt - 1) / (16 * nt)),
                                  sms))
    nt /= 2;
  if (tiles > 0x7fffffffLL || B > 65535 ||
      (long long)slices * ((Cout + 16 * nt - 1) / (16 * nt)) > 65535)
    return cudaErrorInvalidConfiguration;
  switch (nt) {
    case 16:
      return launch_sample_fwd_group<Geom, OutT, kKs, kClampDx, Tag, 16>(
          x, geom, wt, bias, out, sums, B, H, W, Cp, Cout, tiles_x,
          (int)tiles, slices, cin_per_block, max_shift, s);
    case 8:
      return launch_sample_fwd_group<Geom, OutT, kKs, kClampDx, Tag, 8>(
          x, geom, wt, bias, out, sums, B, H, W, Cp, Cout, tiles_x,
          (int)tiles, slices, cin_per_block, max_shift, s);
    case 4:
      return launch_sample_fwd_group<Geom, OutT, kKs, kClampDx, Tag, 4>(
          x, geom, wt, bias, out, sums, B, H, W, Cp, Cout, tiles_x,
          (int)tiles, slices, cin_per_block, max_shift, s);
    default:
      return launch_sample_fwd_group<Geom, OutT, kKs, kClampDx, Tag, 2>(
          x, geom, wt, bias, out, sums, B, H, W, Cp, Cout, tiles_x,
          (int)tiles, slices, cin_per_block, max_shift, s);
  }
}

// The explicit-offset forward (dcn_fwd.cu, dcn_sel_fwd.cu,
// dcn_wide_fwd.cu): one launch over the `OffsetMask` geometry, with
// `cin_per_block` from fwd_cin_per_block. Where that is less than Cp, the
// slices add into `sums` ((B, Cout, H, W) f32, zeroed) and `out` is not
// written. Returns the cudaError_t.
template <typename OutT, bool kClampDx = false, typename Tag = void>
__host__ int launch_explicit_fwd(const void* x, const void* offset,
                                 const void* mask, const void* wt,
                                 const void* bias, void* out, void* sums,
                                 int B, int H, int W, int Cp, int Cout,
                                 int cin_per_block, float max_shift,
                                 void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return (int)cudaSuccess;
  if (Cp <= 0 || Cp % 8 != 0 || cin_per_block <= 0 ||
      cin_per_block % 8 != 0 || (cin_per_block < Cp && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  const OffsetMask geom{(const float*)offset, (const float*)mask, nullptr,
                        nullptr};
  return (int)launch_sample_fwd<OffsetMask, OutT, kFwdChunk, kClampDx, Tag>(
      (const __nv_bfloat16*)x, geom, (const __nv_bfloat16*)wt,
      (const float*)bias, (OutT*)out, (float*)sums, B, H, W, Cp, Cout,
      cin_per_block, max_shift, (cudaStream_t)stream);
}

}  // namespace dcn
