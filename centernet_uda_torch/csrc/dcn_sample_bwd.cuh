// The sampling backward of DCNv2 on Hopper's tensor cores (sm_90a), shared
// by the three backward sources: dcn_bwd.cu (the float32 layer),
// dcn_sel_bwd.cu (the "select" shapes) and dcn_fused_bwd.cu (the bfloat16
// layer with its offset conv inside). Two kernels, templates over the
// geometry layout of dcn_common.cuh and a tag that only names the
// instantiation (`Select` for dcn_sel_bwd.cu):
//
// dcn_sample_data_kernel: one block per (8 x 8 pixel tile, image, slice of
//   Cin). The tile's g (64 pixels x Cout, bf16) is loaded once and stays in
//   shared memory (in panels of 256 columns above Cout 256); per tap and
//   chunk of 64 channels, gcol_t = g . W_t^T on mma.sync, rounded to bf16 in
//   shared memory; then per (pixel, 8 channels) the corner contraction e_k =
//   x_corner . gcol on the CUDA cores (a dot product, reduced over the 8
//   lanes of the pixel) and dx += m * corner weight * gcol by two 16-byte
//   vector reductions (red.global.add.v4.f32) into a zeroed channels-last
//   f32 scratch. From e_k the geometry's `write_grads` writes the sampling
//   gradients: d(dy) (0 where |dy_raw| >= max_shift; both y-corners enter
//   at integer positions), d(dx) (never gated) and d(mask); `OffsetMask`
//   as doffset and dmask, `OffsetConv` as dz = d(loss)/d(om) through the
//   sigmoid. Where B * tiles gives too few blocks, Cin is split across
//   blocks; the gradients are linear in e_k, so each block then adds its
//   share into zeroed buffers by atomics.
// dcn_sample_weight_kernel: split-K over the B*H*W pixels. A block owns
//   (tap, Cin tile of 64, slice of pixels) and a group of up to 256 output
//   channels (all of Cout up to 256), so each sample is gathered once per
//   (tap, Cin tile). Per step of 64 pixels it builds tables of each pixel's
//   corners, image and plane index, stages the sampled columns u_t = m *
//   sample (bf16) and g (16-byte cp.async rows where the step lies in one
//   image), and runs u^T . g -> dW[t] on mma.sync; the f32 partials go out
//   by atomics. Under `OffsetConv` the blocks of the first channel group
//   also stage the tap-shifted plain x and bf16-rounded dz and run x_t^T .
//   dz -> dW_om[t], and one column of blocks sums dz, unrounded, for db_om;
//   under `OffsetMask` that part and its shared memory are compiled out.
//
// Operands (the wrappers stage them; Cp is Cin rounded up to a multiple of
// 8 with zero channels, so every channel run is whole 16-byte vectors):
//   x   (B, H, W, Cp)   bf16, channels-last
//   wt  (9, Cp, Cop)    bf16, tap-major, Cout padded with zeros to Cop, a
//                       multiple of 16
//   g   (B, Cout, H, W) bf16, 16-byte aligned
//   dx  (B, H, W, Cp)   f32, zeroed; dW (9, Cp, Cout) f32, zeroed
// As on the TPU, the products take bf16 operands and accumulate in f32: g
// is rounded to bf16 (by the wrapper, for the float32 layer), gcol and the
// samples u are rounded to bf16, and corners outside the map read 0. dx and
// dW are sums of atomics whose order changes from run to run.
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
                           float* __restrict__ dx,  // (B, H, W, Cp), zeroed
                           int H, int W, int Cp, int Cout, int tiles_x,
                           int cin_per_block, float max_shift) {
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
  const bool split = gridDim.y > 1;
  const size_t HW = (size_t)H * W;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Cp;
  float* dxb = dx + (size_t)b * HW * Cp;

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

      // corner contraction and dx reductions: 8 lanes per pixel, a lane
      // owns 8 consecutive channels
#pragma unroll
      for (int r = 0; r < kTilePix * (kKn / 8) / kThreads; ++r) {
        const int item = tid + r * kThreads;
        const int p = item >> 3, v = item & 7;
        const int c = c0 + 8 * v;
        float e[4] = {0.f, 0.f, 0.f, 0.f};
        if (c < ce) {
          float gv[8];
          unpack_bf16x8(*(const uint4*)(s_gcol + p * kGcolPitch + 8 * v), gv);
          const float m = s_m[p];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = s_idx[k * kTilePix + p];
            if (i < 0) continue;
            const size_t at = (size_t)i * Cp + c;
            float xv[8];
            unpack_bf16x8(*(const uint4*)(xb + at), xv);
#pragma unroll
            for (int u = 0; u < 8; ++u) e[k] = fmaf(xv[u], gv[u], e[k]);
            const float w = m * s_c[k * kTilePix + p];
            if (w != 0.f) {
              red_add_v4(dxb + at, w * gv[0], w * gv[1], w * gv[2],
                         w * gv[3]);
              red_add_v4(dxb + at + 4, w * gv[4], w * gv[5], w * gv[6],
                         w * gv[7]);
            }
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
                         s_m[p], gy, gx, dm, split);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight kernel: dW (and, under OffsetConv, dW_om and db_om)

// Shared layout; without the offset conv's part (kOm false) the x_t and dz
// stages take no room.
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
                             float* __restrict__ dw,  // (9, Cp, Cout), zeroed
                             float* __restrict__ dwom,  // (9, Cp, 27), zeroed
                             float* __restrict__ dbom,  // (27), zeroed
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
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ci0 + 16 * wm + g4 + 8 * (i >> 1);
      const int co = co0 + 8 * kNT * wn + 8 * n + 2 * q + (i & 1);
      if (c < Cp && co < Cout)
        atomicAdd(dw + ((size_t)t * Cp + c) * Cout + co, acc[n][i]);
    }
  if constexpr (kOmPart) {
    if (om_block) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ci0 + 16 * wm + g4 + 8 * (i >> 1);
          const int o = 16 * wn + 8 * n + 2 * q + (i & 1);
          if (c < Cp && o < kOm)
            atomicAdd(dwom + ((size_t)t * Cp + c) * kOm + o, acc_om[n][i]);
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
        if ((lane & 15) == 0 && o < kOm) atomicAdd(dbom + o, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// The data kernel over (tiles, Cin slices, images) on `s`. Cin is split
// while the grid is short of about two blocks per SM and a slice keeps at
// least one whole chunk of 64 channels.
template <typename Geom, typename Tag = void>
__host__ cudaError_t launch_sample_data(const __nv_bfloat16* x,
                                        const Geom& geom,
                                        const __nv_bfloat16* wt,
                                        const __nv_bfloat16* g, float* dx,
                                        int B, int H, int W, int Cp, int Cout,
                                        float max_shift, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL || B > 65535) return cudaErrorInvalidConfiguration;
  const int chunks = (Cp + kKn - 1) / kKn;
  int splits = 1;
  while (splits * 2 <= chunks && too_few_blocks(tiles * B * splits, sms))
    splits *= 2;
  const int cin_per_block = (chunks + splits - 1) / splits * kKn;
  splits = (Cp + cin_per_block - 1) / cin_per_block;
  const size_t smem = DataSmem(g_panel(round_up16(Cout))).bytes;
  auto kernel = dcn_sample_data_kernel<Geom, Tag>;
  err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, splits, B), kThreads, smem, s>>>(
      x, geom, wt, g, dx, H, W, Cp, Cout, tiles_x, cin_per_block, max_shift);
  return cudaGetLastError();
}

template <int kNT, typename Geom, typename Tag>
__host__ cudaError_t launch_weight_group(const __nv_bfloat16* x,
                                         const Geom& geom,
                                         const __nv_bfloat16* g, float* dw,
                                         float* dwom, float* dbom, int B,
                                         int H, int W, int Cp, int Cout,
                                         float max_shift, int pix_per_block,
                                         cudaStream_t s) {
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
           s>>>(x, geom, g, dw, dwom, dbom, B, H, W, Cp, Cout, max_shift,
                pix_per_block, groups);
  return cudaGetLastError();
}

// The weight kernel on `s`, its channel group fitted to Cout (32, 64, 128
// or 256 channels; several groups above 256). `pix_per_block` is the
// split-K slice, a multiple of 64; dwom and dbom are read under OffsetConv
// only.
template <typename Geom, typename Tag = void>
__host__ cudaError_t launch_sample_weight(const __nv_bfloat16* x,
                                          const Geom& geom,
                                          const __nv_bfloat16* g, float* dw,
                                          float* dwom, float* dbom, int B,
                                          int H, int W, int Cp, int Cout,
                                          float max_shift, int pix_per_block,
                                          cudaStream_t s) {
  switch (cout_group_tiles(Cout)) {
    case 16:
      return launch_weight_group<16, Geom, Tag>(x, geom, g, dw, dwom, dbom,
                                                B, H, W, Cp, Cout, max_shift,
                                                pix_per_block, s);
    case 8:
      return launch_weight_group<8, Geom, Tag>(x, geom, g, dw, dwom, dbom, B,
                                               H, W, Cp, Cout, max_shift,
                                               pix_per_block, s);
    case 4:
      return launch_weight_group<4, Geom, Tag>(x, geom, g, dw, dwom, dbom, B,
                                               H, W, Cp, Cout, max_shift,
                                               pix_per_block, s);
    default:
      return launch_weight_group<2, Geom, Tag>(x, geom, g, dw, dwom, dbom, B,
                                               H, W, Cp, Cout, max_shift,
                                               pix_per_block, s);
  }
}

// The explicit-offset backward (dcn_bwd.cu, dcn_sel_bwd.cu): the data
// kernel, then the weight kernel, over the `OffsetMask` geometry. doff
// (B, 18, H, W) and dmask (B, 9, H, W) f32 must be zeroed, as dx and dw
// are: where Cin is split they are sums of atomics. Returns the first
// cudaError_t.
template <typename Tag>
__host__ int launch_explicit_bwd(const void* x, const void* offset,
                                 const void* mask, const void* wt,
                                 const void* g, void* dx, void* doff,
                                 void* dmask, void* dw, int B, int H, int W,
                                 int Cp, int Cout, float max_shift,
                                 int pix_per_block, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cp == 0 || Cout == 0)
    return (int)cudaSuccess;
  if (Cp % 8 != 0 || pix_per_block <= 0 || pix_per_block % kKp2 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const OffsetMask geom{(const float*)offset, (const float*)mask,
                        (float*)doff, (float*)dmask};
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* gb = (const __nv_bfloat16*)g;
  cudaError_t err = launch_sample_data<OffsetMask, Tag>(
      xb, geom, (const __nv_bfloat16*)wt, gb, (float*)dx, B, H, W, Cp, Cout,
      max_shift, s);
  if (err == cudaSuccess)
    err = launch_sample_weight<OffsetMask, Tag>(
        xb, geom, gb, (float*)dw, nullptr, nullptr, B, H, W, Cp, Cout,
        max_shift, pix_per_block, s);
  return (int)err;
}

}  // namespace dcn
