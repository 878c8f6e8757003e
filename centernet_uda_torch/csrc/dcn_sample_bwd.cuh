// The sampling backward of DCNv2 on Hopper's tensor cores (sm_90a), shared
// by the three backward sources: dcn_bwd.cu (the float32 layer),
// dcn_sel_bwd.cu (the "select" shapes) and dcn_fused_bwd.cu (the bfloat16
// layer with its offset conv inside). Four kernels, templates over the
// geometry layout of dcn_common.cuh and a tag that only names the
// instantiation (`Select` for dcn_sel_bwd.cu), and a fixed-order sum:
//
// dcn_sample_data_kernel: one block per (8 x 8 pixel tile, image, slice of
//   Cin). The tile's g (64 pixels x Cout, bf16) is loaded once and stays in
//   shared memory (in panels of 256 columns above Cout 256); per tap and
//   chunk of 64 channels, gcol_t = g . W_t^T on mma.sync, rounded to bf16 in
//   shared memory and stored to a (B, H, W, 9, Cp) bf16 buffer; then per
//   (pixel, 8 channels) the corner contraction e_k = x_corner . gcol on the
//   CUDA cores (a dot product, reduced over the 8 lanes of the pixel). From
//   e_k the geometry's `write_grads` writes the sampling gradients: d(dy)
//   (0 where |dy_raw| >= max_shift; both y-corners enter at integer
//   positions), d(dx) (never gated) and d(mask); `OffsetMask` as doffset
//   and dmask, `OffsetConv` as dz = d(loss)/d(om) through the sigmoid.
//   Where B * tiles gives too few blocks, Cin is split across blocks; the
//   gradients are linear in e_k, so each slice then stores its share in its
//   own plane and dcn_sum_planes_kernel adds the planes in slice order.
// dcn_sample_bucket_kernel: the samples of each source tile, bucketed by
//   the destination tiles their corners fall in. One block per (source
//   tile, image) takes its 576 (pixel, tap) samples, finds the distinct
//   destination tiles of their corners with a nonzero weight (the vertical
//   clamp keeps them within `bucket_rows` tile rows above and below; across
//   they may lie anywhere in the row), counts them per destination (integer
//   adds in shared memory, whose totals no order changes), takes the
//   exclusive prefix sum of the counts as its segment offsets, and writes
//   each sample's index into its destinations' segments at a rank fixed by
//   (round, corner, warp, lane): __match_any_sync ranks a warp's lanes, and
//   the earlier warps' counts place the warp.
// dcn_sample_dx_kernel: dx without atomics. One block per (destination
//   tile, chunk of 64 channels, image) owns those elements of dx. Its
//   candidates are the segments for this tile of the source tiles within
//   `bucket_rows` rows of it, in source-tile order, each in its rank order;
//   per batch of 1024 candidates the block recomputes their sampling
//   positions (`sample_at`, the data kernel's arithmetic), keeps their
//   corners in the tile, and each warp, owning one row of the tile, adds m
//   * corner weight * gcol for its row's corners in candidate order into
//   f32 registers (8 lanes a pixel, 8 channels a lane; each group of 8
//   lanes owns two columns and takes their hits with two gcol loads in
//   flight). Each element of dx is written once, so its sum has one order
//   whichever blocks run first, as the TPU kernel's whole-image
//   accumulator, walked in grid order, has; and each sample is a candidate
//   of at most 4 destination tiles, so the work does not grow with how far
//   the offsets reach.
// dcn_sample_weight_kernel: split-K over the B*H*W pixels. A block owns
//   (tap, Cin tile of 64, slice of pixels) and a group of up to 256 output
//   channels (all of Cout up to 256), so each sample is gathered once per
//   (tap, Cin tile). Per step of 64 pixels it builds tables of each pixel's
//   corners, image and plane index, stages the sampled columns u_t = m *
//   sample (bf16) and g (16-byte cp.async rows where the step lies in one
//   image), and runs u^T . g -> dW[t] on mma.sync; each slice of pixels
//   stores its f32 partials in its own record, which dcn_sum_planes_kernel
//   then adds in slice order. Under `OffsetConv` the blocks of the first
//   channel group also stage the tap-shifted plain x and bf16-rounded dz
//   and run x_t^T . dz -> dW_om[t], and one block a slice sums dz,
//   unrounded, for db_om, into the same record; under `OffsetMask` that
//   part and its shared memory are compiled out.
//
// Operands (the wrappers stage them; Cp is Cin rounded up to a multiple of
// 8 with zero channels, so every channel run is whole 16-byte vectors):
//   x     (B, H, W, Cp)     bf16, channels-last
//   wt    (9, Cp, Cop)      bf16, tap-major, Cout padded with zeros to
//                           Cop, a multiple of 16
//   g     (B, Cout, H, W)   bf16, 16-byte aligned
//   gcol  (B, H, W, 9, Cp)  bf16 scratch
//   dx    (B, H, W, Cp)     f32; dW (9, Cp, Cout) f32; every element
//                           written once, so none needs zeroing
//   bucket B * tiles * (bucket_dests + 1 + kBucketRecs) 32-bit words:
//                           per (image, source tile) its segment offsets,
//                           then per (image, source tile) its records
// As on the TPU, the products take bf16 operands and accumulate in f32: g
// is rounded to bf16 (by the wrapper, for the float32 layer), gcol and the
// samples u are rounded to bf16, and corners outside the map read 0. No
// float is added by an atomic: every sum has an order fixed by the shape
// and the data, so every launch on the same inputs gives the same bits.
#pragma once

#include "dcn_fused.cuh"

namespace dcn {

constexpr int kKn = 64;       // data kernel: channels per gcol chunk
constexpr int kGPanel = 256;  // data kernel: columns of g per shared panel
constexpr int kGcolPitch = kKn + kRowPad;  // 72
constexpr int kWc64 = 64;     // weight kernel: channels a block
constexpr int kKp2 = 64;      // weight kernel: pixels per reduction step
constexpr int kPPitch = kKp2 + kRowPad;    // 72: rows [n][pixel]
constexpr int kCPitch = kWc64 + kRowPad;   // 72: rows [pixel][channel]

// ---------------------------------------------------------------------------
// data kernel

// Shared layout for a g panel of `panel` columns.
struct DataSmem {
  size_t g, w, gcol, idx, c, fy, fx, m, live, e, bytes;
  __host__ __device__ explicit DataSmem(int panel) {
    const size_t rows = (size_t)kTilePix * (panel + kRowPad) * 2;
    g = 0;
    w = align16(g + rows);
    gcol = align16(w + rows);
    idx = align16(gcol + (size_t)kTilePix * kGcolPitch * 2);
    c = idx + 4 * kTilePix * 4;
    fy = c + 4 * kTilePix * 4;
    fx = fy + kTilePix * 4;
    m = fx + kTilePix * 4;
    live = m + kTilePix * 4;
    e = live + kTilePix * 4;
    bytes = e + 4 * kTilePix * 4;
  }
};

__host__ __device__ inline int g_panel(int Cop) {
  return Cop < kGPanel ? Cop : kGPanel;
}

template <typename Geom, typename Tag = void>
__global__ void __launch_bounds__(kThreads)
    dcn_sample_data_kernel(const __nv_bfloat16* __restrict__ x,  // (B,H,W,Cp)
                           const Geom geom,
                           const __nv_bfloat16* __restrict__ wt,  // (9,Cp,Cop)
                           const __nv_bfloat16* __restrict__ g,  // (B,Cout,H,W)
                           __nv_bfloat16* __restrict__ gcol,  // (B,H,W,9,Cp)
                           int H, int W, int Cp, int Cout, int tiles_x,
                           int cin_per_block, size_t part_stride,
                           float max_shift) {
  const int Cop = round_up16(Cout);
  const int panel = g_panel(Cop);
  const int pitch = panel + kRowPad;
  const int npanels = (Cop + panel - 1) / panel;
  const DataSmem L(panel);
  DCN_DYNAMIC_SMEM(smem);
  __nv_bfloat16* s_g = (__nv_bfloat16*)(smem + L.g);     // [pixel][cout]
  __nv_bfloat16* s_w = (__nv_bfloat16*)(smem + L.w);     // [chan][cout]
  __nv_bfloat16* s_gcol = (__nv_bfloat16*)(smem + L.gcol);  // [pixel][chan]
  int* s_idx = (int*)(smem + L.idx);  // [corner][pixel], y*W+x or -1
  float* s_c = (float*)(smem + L.c);  // [corner][pixel], without the mask
  float* s_fy = (float*)(smem + L.fy);
  float* s_fx = (float*)(smem + L.fx);
  float* s_m = (float*)(smem + L.m);
  int* s_live = (int*)(smem + L.live);
  float* s_e = (float*)(smem + L.e);  // [pixel][corner]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int cb = blockIdx.y * cin_per_block;
  const int ce = cb + cin_per_block < Cp ? cb + cin_per_block : Cp;
  // slice s of Cin stores its share of the sampling gradients in plane s
  const size_t part = blockIdx.y * part_stride;
  const size_t HW = (size_t)H * W;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Cp;
  __nv_bfloat16* gcolb = gcol + (size_t)b * HW * kTaps * Cp;

  auto load_g = [&](int o0) {
    for (int i = tid; i < kTilePix * panel; i += kThreads) {
      const int o = i / kTilePix, p = i % kTilePix;
      const int co = o0 + o;
      const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (co < Cout && y < H && xx < W)
        v = g[((size_t)b * Cout + co) * HW + (size_t)y * W + xx];
      s_g[p * pitch + o] = v;
    }
  };
  if (npanels == 1) load_g(0);  // resident for every tap and chunk

  const LdRows ld;
  const int g4 = lane >> 2, q = lane & 3;

  // this tap's sampling tables, by the first 64 threads
  auto write_tables = [&](int t) {
    if (tid < kTilePix) {
      const int p = tid;
      const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
      if (y < H && xx < W) {
        const Sample s = sample_at(geom, b, t, y, xx, H, W, max_shift);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k * kTilePix + p] = s.idx[k];
          s_c[k * kTilePix + p] = s.c[k];
        }
        s_fy[p] = s.fy;
        s_fx[p] = s.fx;
        s_m[p] = s.m;
        s_live[p] = s.dy_live ? 1 : 0;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k * kTilePix + p] = -1;
          s_c[k * kTilePix + p] = 0.f;
        }
        s_fy[p] = s_fx[p] = s_m[p] = 0.f;
        s_live[p] = 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s_e[p * 4 + k] = 0.f;
    }
  };

  for (int t = 0; t < kTaps; ++t) {
    __syncthreads();  // the last tap's readers of the tables are done
    for (int c0 = cb; c0 < ce; c0 += kKn) {
      // gcol[p][c] = sum_o g[p][o] * W_t[c][o]; a warp owns 16 pixels x 32
      // channels
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
      for (int o0 = 0; o0 < Cop; o0 += panel) {
        const int width = Cop - o0 < panel ? Cop - o0 : panel;
        const bool first = c0 == cb && o0 == 0;
        // s_g / s_w readers are done (for the tap's first step, since the
        // barrier that opened the tap)
        if (!first) __syncthreads();
        if (npanels > 1) load_g(o0);
        for (int i = tid; i < kKn * (width / 8); i += kThreads) {
          const int r = i / (width / 8), v = i % (width / 8);
          const bool ok = c0 + r < ce;
          cp_async16(s_w + r * pitch + 8 * v,
                     ok ? wt + ((size_t)t * Cp + c0 + r) * Cop + o0 + 8 * v
                        : wt,
                     ok);
        }
        cp_async_commit();
        if (first) write_tables(t);  // while the W chunk is in flight
        cp_async_wait<0>();
        __syncthreads();
        const __nv_bfloat16* arow =
            s_g + (16 * wm + ld.a_row()) * pitch + ld.a_k();
        const __nv_bfloat16* brow =
            s_w + (32 * wn + ld.bn_row()) * pitch + ld.bn_k();
        for (int ks = 0; ks < width; ks += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, arow + ks);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bq[4];
            ldmatrix_x4(bq, brow + 16 * np * pitch + ks);
            mma_bf16_16816(acc[2 * np], a, bq[0], bq[1]);
            mma_bf16_16816(acc[2 * np + 1], a, bq[2], bq[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s_gcol[(16 * wm + g4 + 8 * (i >> 1)) * kGcolPitch + 32 * wn +
                 8 * n + 2 * q + (i & 1)] = __float2bfloat16(acc[n][i]);
      __syncthreads();

      // gcol out, and the corner contraction: 8 lanes per pixel, a lane
      // owns 8 consecutive channels
#pragma unroll
      for (int r = 0; r < kTilePix * (kKn / 8) / kThreads; ++r) {
        const int item = tid + r * kThreads;
        const int p = item >> 3, v = item & 7;
        const int c = c0 + 8 * v;
        const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
        float e[4] = {0.f, 0.f, 0.f, 0.f};
        if (c < ce && y < H && xx < W) {
          const uint4 gq =
              *(const uint4*)(s_gcol + p * kGcolPitch + 8 * v);
          *(uint4*)(gcolb + ((size_t)y * W + xx) * kTaps * Cp +
                    (size_t)t * Cp + c) = gq;
          float gv[8];
          unpack_bf16x8(gq, gv);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = s_idx[k * kTilePix + p];
            if (i < 0) continue;
            float xv[8];
            unpack_bf16x8(*(const uint4*)(xb + (size_t)i * Cp + c), xv);
#pragma unroll
            for (int u = 0; u < 8; ++u) e[k] = fmaf(xv[u], gv[u], e[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int s = 1; s < 8; s <<= 1)
            e[k] += __shfl_xor_sync(0xffffffffu, e[k], s);
        }
        if (v == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) s_e[p * 4 + k] += e[k];
        }
      }
    }
    __syncthreads();  // s_e is complete for this tap

    if (tid < kTilePix) {
      const int p = tid;
      const int y = y0 + p / kTileW, xx = x0 + p % kTileW;
      if (y < H && xx < W) {
        const float fy = s_fy[p], fx = s_fx[p];
        const float e00 = s_e[p * 4], e01 = s_e[p * 4 + 1];
        const float e10 = s_e[p * 4 + 2], e11 = s_e[p * 4 + 3];
        const float dm = s_c[p] * e00 + s_c[kTilePix + p] * e01 +
                         s_c[2 * kTilePix + p] * e10 +
                         s_c[3 * kTilePix + p] * e11;
        // corners outside the map have e_k == 0, so the derivative
        // coefficients need no validity factor
        const float gy =
            -(1.f - fx) * e00 - fx * e01 + (1.f - fx) * e10 + fx * e11;
        const float gx =
            -(1.f - fy) * e00 + (1.f - fy) * e01 - fy * e10 + fy * e11;
        geom.write_grads(b, t, HW, (size_t)y * W + xx, s_live[p] != 0,
                         s_m[p], gy, gx, dm, part);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dx kernel

constexpr int kCandPerThread = 4;
constexpr int kCandBatch = kCandPerThread * kThreads;  // 1024
constexpr unsigned kNoCorners = 0xffffffffu;
// samples of a source tile, and records: each sample's corners lie in at
// most 4 destination tiles (2 x 2 adjacent pixels)
constexpr int kTileSamples = kTilePix * kTaps;  // 576
constexpr int kBucketRecs = 4 * kTileSamples;
constexpr int kBucketRounds = (kTileSamples + kThreads - 1) / kThreads;

// Tile rows above and below a source tile that the corners of its samples
// can lie in: a sample's row is within ceil(max_shift) + 1 of its pixel's
// (the clamp, the tap) and its lower corner one more.
__host__ __device__ inline int bucket_rows(float max_shift) {
  const int reach = (int)ceilf(max_shift) + 1;
  return (reach + kTileH) / kTileH;
}

// Destination tiles a source tile's segments cover: (2 * bucket_rows + 1)
// tile rows of the map's width, destination (ty, tx) of source tile row sty
// at (ty - sty + bucket_rows) * tiles_x + tx.
__host__ __device__ inline int bucket_dests(int tiles_x, float max_shift) {
  return (2 * bucket_rows(max_shift) + 1) * tiles_x;
}

// 32-bit words of the bucket scratch (dcn_sample_bucket_kernel), or -1
// where max_shift is not a finite number below 2^20.
__host__ inline long long bucket_words(int B, int H, int W,
                                       float max_shift) {
  if (!(max_shift >= 0.f && max_shift < 1048576.f)) return -1;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  return (long long)B * tiles *
         (bucket_dests(tiles_x, max_shift) + 1 + kBucketRecs);
}

// Exclusive prefix sum of `v` over the block's threads in thread order, and
// the block's total; `s_warp` holds kThreads / 32 ints, which the caller
// must not rewrite before a __syncthreads() that follows this call.
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp,
                                                   int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, s);
    if (lane >= s) inc += o;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int n = s_warp[w];
    before += w < warp ? n : 0;
    total += n;
  }
  return before + inc - v;
}

// acc[h] += w * gcol (8 channels) for the corner of kept candidate e in
// row `row` and column group col0 (its code `code`, its weights s_w[k][e]):
// h = 0 for column col0, 1 for col0 + 4
__device__ __forceinline__ void add_hit(float (&acc)[2][8], unsigned code,
                                        const float (*s_w)[kCandBatch],
                                        int e, int row, int col0,
                                        const uint4& q) {
  int k = 0;
  unsigned at = code & 0xffu;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const unsigned a = (code >> (8 * i)) & 0xffu;
    if (a != 0xffu && (int)(a >> 3) == row && (int)(a & 3) == col0) {
      k = i;
      at = a;
    }
  }
  const float w = s_w[k][e];
  float gv[8];
  unpack_bf16x8(q, gv);
  if (at & 4u) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[1][u] = fmaf(w, gv[u], acc[1][u]);
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[0][u] = fmaf(w, gv[u], acc[0][u]);
  }
}

// The destination tiles of sample `s` of source tile row `sty`, as local
// indices (bucket_dests), one slot a corner: -1 where the corner is outside
// the map, has weight 0, or falls in the tile of an earlier corner.
__device__ __forceinline__ void sample_dests(const Sample& s, int W,
                                             int sty, int rows, int tiles_x,
                                             int (&d)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = -1;
    if (s.idx[k] < 0 || s.m * s.c[k] == 0.f) continue;
    const int yk = s.idx[k] / W, xk = s.idx[k] - (s.idx[k] / W) * W;
    const int ld = (yk / kTileH - sty + rows) * tiles_x + xk / kTileW;
    bool seen = false;
#pragma unroll
    for (int j = 0; j < k; ++j) seen = seen || d[j] == ld;
    if (!seen) d[k] = ld;
  }
}

template <typename Geom, typename Tag = void>
__global__ void __launch_bounds__(kThreads)
    dcn_sample_bucket_kernel(const Geom geom,
                             int* __restrict__ bucket,  // bucket_words
                             int H, int W, int tiles_x, float max_shift) {
  const int rows = bucket_rows(max_shift);
  const int nl = (2 * rows + 1) * tiles_x;
  DCN_DYNAMIC_SMEM(smem);
  int* s_cnt = (int*)smem;      // [nl]: the tile's records per destination
  int* s_run = s_cnt + nl;      // [nl]: the next rank per destination
  int* s_wcnt = s_run + nl;     // [warps][nl]: a warp's records this step
  __shared__ int s_warp[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const size_t tiles = gridDim.x;
  const int sty = blockIdx.x / tiles_x, stx = blockIdx.x % tiles_x;
  const size_t src = (size_t)b * tiles + blockIdx.x;
  int* seg = bucket + src * (nl + 1);
  int* rec = bucket + (size_t)gridDim.z * tiles * (nl + 1) +
             src * kBucketRecs;

  for (int i = tid; i < nl * (kThreads / 32 + 2); i += kThreads)
    ((int*)smem)[i] = 0;
  // sample e = tap * 64 + pixel of the tile, for e = tid + 256 * round
  int dest[kBucketRounds][4];
#pragma unroll
  for (int r = 0; r < kBucketRounds; ++r) {
    const int e = tid + r * kThreads;
    const int t = e / kTilePix, p = e % kTilePix;
    const int y = sty * kTileH + p / kTileW, x = stx * kTileW + p % kTileW;
#pragma unroll
    for (int k = 0; k < 4; ++k) dest[r][k] = -1;
    if (e < kTileSamples && y < H && x < W)
      sample_dests(sample_at(geom, b, t, y, x, H, W, max_shift), W, sty,
                   rows, tiles_x, dest[r]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBucketRounds; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (dest[r][k] >= 0) atomicAdd(s_cnt + dest[r][k], 1);
  __syncthreads();

  // the segment offsets: an exclusive prefix sum of the counts
  int carry = 0;
  for (int base = 0; base < nl; base += kThreads) {
    const int i = base + tid;
    int total;
    const int before =
        block_exclusive_sum(i < nl ? s_cnt[i] : 0, s_warp, total);
    if (i < nl) {
      s_run[i] = carry + before;
      seg[i] = carry + before;
    }
    carry += total;
    __syncthreads();  // s_warp is read before it is written again
  }
  if (tid == 0) seg[nl] = carry;

  // each record at its segment's next rank: in (round, corner, warp, lane)
  // order, the warp's lanes ranked by __match_any_sync, the warp placed
  // after the earlier warps' records of the same step
#pragma unroll
  for (int r = 0; r < kBucketRounds; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = dest[r][k];
      const unsigned same = __match_any_sync(0xffffffffu, d);
      const bool leader = lane == __ffs(same) - 1;
      if (d >= 0 && leader) s_wcnt[warp * nl + d] = __popc(same);
      __syncthreads();
      if (d >= 0) {
        int at = s_run[d] + __popc(same & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) at += s_wcnt[w * nl + d];
        rec[at] = tid + r * kThreads;
      }
      __syncthreads();
      if (d >= 0 && leader) {
        atomicAdd(s_run + d, __popc(same));
        s_wcnt[warp * nl + d] = 0;
      }
      __syncwarp();
    }
  }
}

template <typename Geom, typename Tag = void>
__global__ void __launch_bounds__(kThreads)
    dcn_sample_dx_kernel(const Geom geom,
                         const __nv_bfloat16* __restrict__ gcol,
                         const int* __restrict__ bucket,
                         float* __restrict__ dx,  // (B, H, W, Cp)
                         int H, int W, int Cp, int tiles_x, int tiles_y,
                         float max_shift) {
  // the kept candidates of a batch: per corner k, byte k of s_code is the
  // corner's pixel in the tile (row * 8 + column) or 0xff, s_w[k] its
  // weight; s_row the candidate's (pixel, tap) row of gcol
  __shared__ unsigned s_code[kCandBatch];
  __shared__ float s_w[4][kCandBatch];
  __shared__ int s_row[kCandBatch];
  __shared__ int s_warp[kThreads / 32];
  // the segments of a round of source tiles: their first candidate, their
  // offset in their source tile's records, and that tile
  __shared__ int s_first[kThreads];
  __shared__ int s_off[kThreads];
  __shared__ int s_src[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // the tile row this warp owns
  const int b = blockIdx.z;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int Y0 = ty * kTileH, X0 = tx * kTileW;
  const int c = blockIdx.y * kKn + 8 * (lane & 7);
  const int col0 = lane >> 3;  // the lane's columns: col0 and col0 + 4
  const int rows = bucket_rows(max_shift);
  const int nl = (2 * rows + 1) * tiles_x;
  const size_t tiles = (size_t)tiles_x * tiles_y;
  const int sy0 = max(ty - rows, 0), sy1 = min(ty + rows, tiles_y - 1);
  const int n_src = (sy1 - sy0 + 1) * tiles_x;
  const int* segs = bucket + (size_t)b * tiles * (nl + 1);
  const int* recs = bucket + (size_t)gridDim.z * tiles * (nl + 1) +
                    (size_t)b * tiles * kBucketRecs;
  const size_t HW = (size_t)H * W;

  float acc[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[h][u] = 0.f;

  // the source tiles within reach down the map, a round of kThreads at a
  // time, in tile order; their segments for this tile, in order, are the
  // candidates, taken by batches
  for (int sbase = 0; sbase < n_src; sbase += kThreads) {
    const int si = sbase + tid;
    int n = 0, off = 0, src = 0;
    if (si < n_src) {
      const int sty = sy0 + si / tiles_x;
      src = sty * tiles_x + si % tiles_x;
      const int* seg = segs + (size_t)src * (nl + 1) +
                       (ty - sty + rows) * tiles_x + tx;
      off = seg[0];
      n = seg[1] - off;
    }
    int n_cand;
    const int first = block_exclusive_sum(n, s_warp, n_cand);
    s_first[tid] = first;
    s_off[tid] = off;
    s_src[tid] = src;
    __syncthreads();
    for (int base = 0; base < n_cand; base += kCandBatch) {
      // candidate base + 4 tid + j: the last segment that starts at or
      // before it (an empty one never does: the next starts at the same
      // place), its record there
      unsigned code[kCandPerThread];
      float w[kCandPerThread][4];
      int row[kCandPerThread];
      int kept = 0;
#pragma unroll
      for (int j = 0; j < kCandPerThread; ++j) {
        code[j] = kNoCorners;
        row[j] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) w[j][k] = 0.f;
        const int cand = base + kCandPerThread * tid + j;
        if (cand < n_cand) {
          int lo = 0;
#pragma unroll
          for (int step = kThreads / 2; step > 0; step >>= 1)
            if (lo + step < kThreads && s_first[lo + step] <= cand)
              lo += step;
          const int from = s_src[lo];
          const int e = recs[(size_t)from * kBucketRecs + s_off[lo] + cand -
                             s_first[lo]];
          const int t = e / kTilePix, p = e % kTilePix;
          const int y = (from / tiles_x) * kTileH + p / kTileW;
          const int xq = (from % tiles_x) * kTileW + p % kTileW;
          {
            const Sample s = sample_at(geom, b, t, y, xq, H, W, max_shift);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (s.idx[k] < 0) continue;
              const float wk = s.m * s.c[k];
              const int yk = s.idx[k] / W, xk = s.idx[k] - yk * W;
              if (wk != 0.f && yk >= Y0 && yk < Y0 + kTileH && xk >= X0 &&
                  xk < X0 + kTileW) {
                const unsigned at = (unsigned)((yk - Y0) * kTileW + xk - X0);
                code[j] = (code[j] & ~(0xffu << (8 * k))) | (at << (8 * k));
                w[j][k] = wk;
              }
            }
            row[j] = (int)(((size_t)b * HW + (size_t)y * W + xq) * kTaps + t);
          }
        }
        kept += code[j] != kNoCorners ? 1 : 0;
      }
      // the kept candidates, in candidate order (the previous batch's
      // readers passed the barrier inside the prefix sum)
      int total;
      int pos = block_exclusive_sum(kept, s_warp, total);
#pragma unroll
      for (int j = 0; j < kCandPerThread; ++j) {
        if (code[j] == kNoCorners) continue;
        s_code[pos] = code[j];
        s_row[pos] = row[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) s_w[k][pos] = w[j][k];
        ++pos;
      }
      __syncthreads();

      // each warp adds its row's corners, by 32 candidates: a candidate has
      // at most one corner in a (row, column group), so the lanes of
      // column group col0 take the candidates with a corner in columns col0
      // or col0 + 4, one after the other, two gcol loads in flight
      for (int g0 = 0; g0 < total; g0 += 32) {
        const unsigned mine =
            g0 + lane < total ? s_code[g0 + lane] : kNoCorners;
        unsigned in_groups = 0;  // bit j: a corner in column group j
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned at = (mine >> (8 * k)) & 0xffu;
          if (at != 0xffu && (int)(at >> 3) == warp)
            in_groups |= 1u << (at & 3);
        }
        unsigned hits = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned group =
              __ballot_sync(0xffffffffu, (in_groups >> j) & 1u);
          if (j == col0) hits = group;
        }
        if (c >= Cp) continue;
        while (hits) {
          const int e0 = g0 + __ffs(hits) - 1;
          hits &= hits - 1;
          const int e1 = hits ? g0 + __ffs(hits) - 1 : -1;
          if (hits) hits &= hits - 1;
          const uint4 q0 = *(const uint4*)(gcol + (size_t)s_row[e0] * Cp + c);
          uint4 q1 = q0;
          if (e1 >= 0)
            q1 = *(const uint4*)(gcol + (size_t)s_row[e1] * Cp + c);
          add_hit(acc, s_code[e0], s_w, e0, warp, col0, q0);
          if (e1 >= 0) add_hit(acc, s_code[e1], s_w, e1, warp, col0, q1);
        }
      }
    }
  }

  const int y = Y0 + warp;
  if (y >= H || c >= Cp) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int xq = X0 + col0 + 4 * h;
    if (xq >= W) continue;
    float4* d = (float4*)(dx + ((size_t)b * HW + (size_t)y * W + xq) * Cp + c);
    d[0] = make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
    d[1] = make_float4(acc[h][4], acc[h][5], acc[h][6], acc[h][7]);
  }
}

// ---------------------------------------------------------------------------
// the fixed-order sum of split parts

// out[i] = part[i] + part[n + i] + ... + part[(planes - 1) n + i], the
// planes added in order; each element by one thread.
__global__ void __launch_bounds__(kThreads)
    dcn_sum_planes_kernel(const float* __restrict__ part, int planes,
                          long long n, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float v = part[i];
    for (int s = 1; s < planes; ++s) v += part[s * n + i];
    out[i] = v;
  }
}

__host__ inline cudaError_t launch_sum_planes(const float* part, int planes,
                                              long long n, float* out,
                                              cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  cudaError_t err = check_launch(dcn_sum_planes_kernel);
  if (err != cudaSuccess) return err;
  const long long blocks = elementwise_blocks(n);
  if (blocks < 0) return (cudaError_t)(-blocks);
  dcn_sum_planes_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(part, planes,
                                                              n, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// weight kernel: dW (and, under OffsetConv, dW_om and db_om)

// Shared layout; without the offset conv's part (kOm false) the x_t and dz
// stages take no room.
// Floats of one slice's record of the weight kernel: dW, and under the
// offset conv dW_om and db_om.
__host__ __device__ inline size_t weight_record(int Cp, int Cout, bool om) {
  return (size_t)kTaps * Cp * Cout + (om ? (size_t)kTaps * Cp * kOm + kOm : 0);
}

template <int kNT, bool kOm>
struct WeightSmem {
  static constexpr int kCg = 16 * kNT;
  static constexpr size_t kStage = (size_t)kKp2 * kCPitch * 2;
  static constexpr size_t kU = 0;
  static constexpr size_t kXt = kU + kStage;
  static constexpr size_t kG = kXt + (kOm ? kStage : 0);
  static constexpr size_t kDz = kG + (size_t)kCg * kPPitch * 2;
  static constexpr size_t kIdx = kDz + (kOm ? (size_t)kOmN * kPPitch * 2 : 0);
  static constexpr size_t kCw = kIdx + 4 * kKp2 * 4;
  static constexpr size_t kImg = kCw + 4 * kKp2 * 4;
  static constexpr size_t kPix = kImg + kKp2 * 4;
  static constexpr size_t kXi = kPix + kKp2 * 4;
  static constexpr size_t kBytes = kXi + kKp2 * 4;
};

template <int kNT, typename Geom, typename Tag = void>
__global__ void __launch_bounds__(kThreads, 2)
    dcn_sample_weight_kernel(const __nv_bfloat16* __restrict__ x,
                             const Geom geom,
                             const __nv_bfloat16* __restrict__ g,
                             // a record per slice of pixels: dW (9, Cp,
                             // Cout), then under OffsetConv dW_om (9, Cp, 27)
                             // and db_om (27), all f32
                             float* __restrict__ parts,
                             int B, int H, int W, int Cp, int Cout,
                             float max_shift, int pix_per_block, int groups) {
  constexpr bool kOmPart = Geom::kOmGrads;
  using L = WeightSmem<kNT, kOmPart>;
  constexpr int kCg = L::kCg;
  constexpr int kDzItems = kOmN * (kKp2 / 4) / kThreads;  // 2
  constexpr int kColItems = kKp2 * (kWc64 / 8) / kThreads;  // 2
  DCN_DYNAMIC_SMEM(smem);
  __nv_bfloat16* s_u = (__nv_bfloat16*)(smem + L::kU);    // [pixel][chan]
  __nv_bfloat16* s_xt = (__nv_bfloat16*)(smem + L::kXt);  // [pixel][chan]
  __nv_bfloat16* s_g = (__nv_bfloat16*)(smem + L::kG);    // [cout][pixel]
  __nv_bfloat16* s_dz = (__nv_bfloat16*)(smem + L::kDz);  // [output][pixel]
  int* s_idx = (int*)(smem + L::kIdx);  // [corner][pixel], into B*H*W
  float* s_cw = (float*)(smem + L::kCw);
  int* s_img = (int*)(smem + L::kImg);  // the step's pixel: image, or -1
  int* s_pix = (int*)(smem + L::kPix);  // and its index in the H*W plane
  int* s_xi = (int*)(smem + L::kXi);    // x at the tap's shift, or -1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int t = blockIdx.z / groups;
  const int co0 = (blockIdx.z % groups) * kCg;
  const int ci0 = blockIdx.y * kWc64;
  // the first channel group also forms dW_om
  const bool om_block = kOmPart && co0 == 0;
  const int dyt = t / 3 - 1, dxt = t % 3 - 1;
  const int HW = H * W;
  const long long n_total = (long long)B * HW;
  const long long n_begin = (long long)blockIdx.x * pix_per_block;
  const long long n_end =
      n_begin + pix_per_block < n_total ? n_begin + pix_per_block : n_total;

  float acc[kNT][4], acc_om[2][4], db[kDzItems];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_om[n][i] = 0.f;
#pragma unroll
  for (int r = 0; r < kDzItems; ++r) db[r] = 0.f;

  const LdRows ld;
  // A = S^T from [pixel][channel] rows; B from [n][pixel] rows
  const int a_off = ld.at_k() * kCPitch + 16 * wm + ld.at_m();
  const int b_off = (8 * kNT * wn + ld.bn_row()) * kPPitch + ld.bn_k();
  const int bom_off = (16 * wn + ld.bn_row()) * kPPitch + ld.bn_k();

  for (long long n0 = n_begin; n0 < n_end; n0 += kKp2) {
    __syncthreads();  // the last step's mma are done with the stage
    if (tid < kKp2) {
      const long long n = n0 + tid;
      if (n < n_end) {
        const int b = (int)(n / HW);
        const int p = (int)(n - (long long)b * HW);
        const int y = p / W, xq = p - y * W;
        const Sample s = sample_at(geom, b, t, y, xq, H, W, max_shift);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k * kKp2 + tid] = s.idx[k] < 0 ? -1 : b * HW + s.idx[k];
          s_cw[k * kKp2 + tid] = s.m * s.c[k];
        }
        const int yy = y + dyt, xx = xq + dxt;
        s_img[tid] = b;
        s_pix[tid] = p;
        s_xi[tid] = yy >= 0 && yy < H && xx >= 0 && xx < W
                        ? b * HW + yy * W + xx
                        : -1;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_idx[k * kKp2 + tid] = -1;
          s_cw[k * kKp2 + tid] = 0.f;
        }
        s_img[tid] = -1;
        s_pix[tid] = 0;
        s_xi[tid] = -1;
      }
    }
    __syncthreads();  // the step's tables are in
    // a step inside one image whose first pixel is 8-aligned reads g as
    // 16-byte rows of 8 pixels
    const int img0 = s_img[0];
    const bool whole = img0 >= 0 && s_img[kKp2 - 1] == img0 &&
                       (HW & 7) == 0 && (s_pix[0] & 7) == 0;
    if (whole) {
      const __nv_bfloat16* gb = g + (size_t)img0 * Cout * HW + s_pix[0];
#pragma unroll
      for (int r = 0; r < kCg * (kKp2 / 8) / kThreads; ++r) {
        const int i = tid + r * kThreads;
        const int o = i >> 3, v = i & 7;
        const bool ok = co0 + o < Cout;
        cp_async16(s_g + o * kPPitch + 8 * v,
                   ok ? gb + (size_t)(co0 + o) * HW + 8 * v : g, ok);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < kCg * (kKp2 / 8); i += kThreads) {
        const int o = i >> 3, v = i & 7;
        const int co = co0 + o;
        __nv_bfloat16 vals[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int b = s_img[8 * v + e];
          vals[e] = b >= 0 && co < Cout
                        ? g[((size_t)b * Cout + co) * HW + s_pix[8 * v + e]]
                        : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) s_g[o * kPPitch + 8 * v + e] = vals[e];
      }
    }
    if constexpr (kOmPart) {
      if (om_block) {
        const float* dz = geom.dz;
        // item (output o, pixels 4 v .. 4 v + 3); o is fixed per (thread, r)
        // across the steps, so db[r] sums one output
#pragma unroll
        for (int r = 0; r < kDzItems; ++r) {
          const int i = tid + r * kThreads;
          const int o = i >> 4, v = i & 15;
          float vals[4] = {0.f, 0.f, 0.f, 0.f};
          if (o < kOm) {
            if (whole) {
              const float* src =
                  dz + ((size_t)img0 * kOm + o) * HW + s_pix[0] + 4 * v;
#pragma unroll
              for (int e = 0; e < 4; ++e) vals[e] = src[e];
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int b = s_img[4 * v + e];
                if (b >= 0)
                  vals[e] =
                      dz[((size_t)b * kOm + o) * HW + s_pix[4 * v + e]];
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s_dz[o * kPPitch + 4 * v + e] = __float2bfloat16(vals[e]);
            db[r] += vals[e];
          }
        }
#pragma unroll
        for (int r = 0; r < kColItems; ++r) {
          const int i = tid + r * kThreads;
          const int pp = i >> 3, v = i & 7;
          const int c = ci0 + 8 * v;
          const int xi = s_xi[pp];
          const bool ok = xi >= 0 && c < Cp;
          cp_async16(s_xt + pp * kCPitch + 8 * v,
                     ok ? x + (size_t)xi * Cp + c : x, ok);
        }
        cp_async_commit();
      }
    }
#pragma unroll
    for (int r = 0; r < kColItems; ++r) {
      const int i = tid + r * kThreads;
      const int pp = i >> 3, uv = i & 7;
      const int c = ci0 + 8 * uv;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (c < Cp) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ix = s_idx[k * kKp2 + pp];
          const float w = s_cw[k * kKp2 + pp];
          if (ix < 0 || w == 0.f) continue;
          float xv[8];
          unpack_bf16x8(*(const uint4*)(x + (size_t)ix * Cp + c), xv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaf(w, xv[e], v[e]);
        }
      }
      *(uint4*)(s_u + pp * kCPitch + 8 * uv) = pack_bf16x8(v);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKp2; ks += 16) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, s_u + a_off + ks * kCPitch);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, s_g + b_off + 16 * np * kPPitch + ks);
        mma_bf16_16816(acc[2 * np], a, bq[0], bq[1]);
        mma_bf16_16816(acc[2 * np + 1], a, bq[2], bq[3]);
      }
      if constexpr (kOmPart) {
        if (om_block) {
          uint32_t bq[4];
          ldmatrix_x4_trans(a, s_xt + a_off + ks * kCPitch);
          ldmatrix_x4(bq, s_dz + bom_off + ks);
          mma_bf16_16816(acc_om[0], a, bq[0], bq[1]);
          mma_bf16_16816(acc_om[1], a, bq[2], bq[3]);
        }
      }
    }
  }

  const int g4 = lane >> 2, q = lane & 3;
  float* dw = parts + blockIdx.x * weight_record(Cp, Cout, kOmPart);
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ci0 + 16 * wm + g4 + 8 * (i >> 1);
      const int co = co0 + 8 * kNT * wn + 8 * n + 2 * q + (i & 1);
      if (c < Cp && co < Cout)
        dw[((size_t)t * Cp + c) * Cout + co] = acc[n][i];
    }
  if constexpr (kOmPart) {
    float* dwom = dw + (size_t)kTaps * Cp * Cout;
    float* dbom = dwom + (size_t)kTaps * Cp * kOm;
    if (om_block) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ci0 + 16 * wm + g4 + 8 * (i >> 1);
          const int o = 16 * wn + 8 * n + 2 * q + (i & 1);
          if (c < Cp && o < kOm)
            dwom[((size_t)t * Cp + c) * kOm + o] = acc_om[n][i];
        }
    }
    if (om_block && t == 0 && blockIdx.y == 0) {
      // db_om, by one column of blocks: item tid + r * kThreads sums output
      // (tid + r * kThreads) / 16, one output per half-warp
#pragma unroll
      for (int r = 0; r < kDzItems; ++r) {
        float v = db[r];
#pragma unroll
        for (int s = 8; s > 0; s >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, s);
        const int o = (tid + r * kThreads) >> 4;
        if ((lane & 15) == 0 && o < kOm) dbom[o] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// Channels of Cin per block of the data kernel: all of Cp, or, while the
// B * tiles blocks are short of about two per SM, a half, a quarter, ...
// (whole chunks of 64 channels, at least one). A negative value is a
// cudaError_t.
__host__ inline int data_cin_per_block(int B, int H, int W, int Cp) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -(int)err;
  const long long tiles = (long long)((W + kTileW - 1) / kTileW) *
                          ((H + kTileH - 1) / kTileH);
  const int chunks = (Cp + kKn - 1) / kKn;
  int splits = 1;
  while (splits * 2 <= chunks && too_few_blocks(tiles * B * splits, sms))
    splits *= 2;
  return (chunks + splits - 1) / splits * kKn;
}

// The data kernel over (tiles, Cin slices of `cin_per_block`, images) on
// `s`; slice i writes the sampling gradients `part_stride` * i floats past
// the geometry's pointers.
template <typename Geom, typename Tag = void>
__host__ cudaError_t launch_sample_data(
    const __nv_bfloat16* x, const Geom& geom, const __nv_bfloat16* wt,
    const __nv_bfloat16* g, __nv_bfloat16* gcol, int B, int H, int W,
    int Cp, int Cout, int cin_per_block, size_t part_stride, float max_shift,
    cudaStream_t s) {
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL || B > 65535) return cudaErrorInvalidConfiguration;
  const int slices = (Cp + cin_per_block - 1) / cin_per_block;
  const size_t smem = DataSmem(g_panel(round_up16(Cout))).bytes;
  auto kernel = dcn_sample_data_kernel<Geom, Tag>;
  cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, slices, B), kThreads, smem, s>>>(
      x, geom, wt, g, gcol, H, W, Cp, Cout, tiles_x, cin_per_block,
      part_stride, max_shift);
  return cudaGetLastError();
}

// The bucket kernel over (source tiles, images), then the dx kernel over
// (destination tiles, chunks of 64 channels, images); `bucket` holds
// bucket_words(B, H, W, max_shift) words.
template <typename Geom, typename Tag = void>
__host__ cudaError_t launch_sample_dx(const Geom& geom,
                                      const __nv_bfloat16* gcol, int* bucket,
                                      float* dx, int B, int H, int W, int Cp,
                                      float max_shift, cudaStream_t s) {
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const long long tiles = (long long)tiles_x * tiles_y;
  const int chunks = (Cp + kKn - 1) / kKn;
  const long long words = bucket_words(B, H, W, max_shift);
  if (tiles > 0x7fffffffLL || chunks > 65535 || B > 65535 || words < 0 ||
      words > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const int nl = bucket_dests(tiles_x, max_shift);
  const size_t smem = (size_t)nl * (kThreads / 32 + 2) * 4;
  auto bucket_kernel = dcn_sample_bucket_kernel<Geom, Tag>;
  cudaError_t err = prepare_launch(bucket_kernel, smem);
  if (err != cudaSuccess) return err;
  auto kernel = dcn_sample_dx_kernel<Geom, Tag>;
  err = check_launch(kernel);
  if (err != cudaSuccess) return err;
  bucket_kernel<<<dim3((unsigned)tiles, 1, B), kThreads, smem, s>>>(
      geom, bucket, H, W, tiles_x, max_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, chunks, B), kThreads, 0, s>>>(
      geom, gcol, bucket, dx, H, W, Cp, tiles_x, tiles_y, max_shift);
  return cudaGetLastError();
}

template <int kNT, typename Geom, typename Tag>
__host__ cudaError_t launch_weight_group(const __nv_bfloat16* x,
                                         const Geom& geom,
                                         const __nv_bfloat16* g,
                                         float* parts, int B, int H, int W,
                                         int Cp, int Cout, float max_shift,
                                         int pix_per_block, cudaStream_t s) {
  auto kernel = dcn_sample_weight_kernel<kNT, Geom, Tag>;
  const size_t smem = WeightSmem<kNT, Geom::kOmGrads>::kBytes;
  cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long n_total = (long long)B * H * W;
  const long long splits = (n_total + pix_per_block - 1) / pix_per_block;
  const int groups = (Cout + 16 * kNT - 1) / (16 * kNT);
  const int ci_tiles = (Cp + kWc64 - 1) / kWc64;
  if (splits > 0x7fffffffLL || ci_tiles > 65535 || kTaps * groups > 65535)
    return cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)splits, ci_tiles, kTaps * groups), kThreads, smem,
           s>>>(x, geom, g, parts, B, H, W, Cp, Cout, max_shift,
                pix_per_block, groups);
  return cudaGetLastError();
}

// The weight kernel on `s`, its channel group fitted to Cout (32, 64, 128
// or 256 channels; several groups above 256), then the sum of its slices'
// records into `out` (weight_record floats). `pix_per_block` is the split-K
// slice, a multiple of 64; `parts` holds ceil(B * H * W / pix_per_block)
// records.
template <typename Geom, typename Tag = void>
__host__ cudaError_t launch_sample_weight(const __nv_bfloat16* x,
                                          const Geom& geom,
                                          const __nv_bfloat16* g,
                                          float* parts, float* out, int B,
                                          int H, int W, int Cp, int Cout,
                                          float max_shift, int pix_per_block,
                                          cudaStream_t s) {
  cudaError_t err;
  switch (cout_group_tiles(Cout)) {
    case 16:
      err = launch_weight_group<16, Geom, Tag>(x, geom, g, parts, B, H, W,
                                               Cp, Cout, max_shift,
                                               pix_per_block, s);
      break;
    case 8:
      err = launch_weight_group<8, Geom, Tag>(x, geom, g, parts, B, H, W, Cp,
                                              Cout, max_shift, pix_per_block,
                                              s);
      break;
    case 4:
      err = launch_weight_group<4, Geom, Tag>(x, geom, g, parts, B, H, W, Cp,
                                              Cout, max_shift, pix_per_block,
                                              s);
      break;
    default:
      err = launch_weight_group<2, Geom, Tag>(x, geom, g, parts, B, H, W, Cp,
                                              Cout, max_shift, pix_per_block,
                                              s);
  }
  if (err != cudaSuccess) return err;
  const long long n_total = (long long)B * H * W;
  return launch_sum_planes(
      parts, (int)((n_total + pix_per_block - 1) / pix_per_block),
      (long long)weight_record(Cp, Cout, Geom::kOmGrads), out, s);
}

// The explicit-offset backward (dcn_bwd.cu, dcn_sel_bwd.cu) over the
// `OffsetMask` geometry: the data kernel; where it splits Cin, the sum of
// its slices' planes; the bucket and dx kernels; the weight kernel and the
// sum of its slices' records. `grads` (B * 27 * H * W f32) receives doffset (B, 18,
// H, W) and then dmask (B, 9, H, W); `grads_parts` holds one such plane a
// slice of data_cin_per_block's split (null where it does not split);
// `dw_parts` the weight kernel's records; `gcol` (B, H, W, 9, Cp) bf16;
// `bucket` bucket_words(B, H, W, max_shift) words. Returns the first
// cudaError_t.
template <typename Tag>
__host__ int launch_explicit_bwd(const void* x, const void* offset,
                                 const void* mask, const void* wt,
                                 const void* g, void* dx, void* grads,
                                 void* grads_parts, void* dw, void* dw_parts,
                                 void* gcol, void* bucket, int B, int H, int W,
                                 int Cp, int Cout, float max_shift,
                                 int pix_per_block, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cp == 0 || Cout == 0)
    return (int)cudaSuccess;
  if (Cp % 8 != 0 || pix_per_block <= 0 || pix_per_block % kKp2 != 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = data_cin_per_block(B, H, W, Cp);
  if (per_block < 0) return -per_block;
  const bool split = per_block < Cp;
  if (split && grads_parts == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t n_grads = (size_t)B * (2 * kTaps + kTaps) * H * W;
  float* to = (float*)(split ? grads_parts : grads);
  const OffsetMask geom{(const float*)offset, (const float*)mask, to,
                        to + (size_t)B * 2 * kTaps * H * W};
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* gb = (const __nv_bfloat16*)g;
  auto* gcolb = (__nv_bfloat16*)gcol;
  cudaError_t err = launch_sample_data<OffsetMask, Tag>(
      xb, geom, (const __nv_bfloat16*)wt, gb, gcolb, B, H, W, Cp, Cout,
      per_block, n_grads, max_shift, s);
  if (err == cudaSuccess && split)
    err = launch_sum_planes((const float*)grads_parts,
                            (Cp + per_block - 1) / per_block,
                            (long long)n_grads, (float*)grads, s);
  if (err == cudaSuccess)
    err = launch_sample_dx<OffsetMask, Tag>(geom, gcolb, (int*)bucket,
                                            (float*)dx, B, H, W, Cp,
                                            max_shift, s);
  if (err == cudaSuccess)
    err = launch_sample_weight<OffsetMask, Tag>(
        xb, geom, gb, (float*)dw_parts, (float*)dw, B, H, W, Cp, Cout,
        max_shift, pix_per_block, s);
  return (int)err;
}

}  // namespace dcn
