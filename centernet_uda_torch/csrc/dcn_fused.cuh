// Device code shared by the tensor-core DCN kernels (the sampling forward
// of dcn_sample_fwd.cuh, the sampling backward of dcn_sample_bwd.cuh and
// dcn_fused_bwd.cu): the 8 x 8 pixel tile, the ldmatrix row helper, the
// offset-conv tile routine on the tensor cores, and the launch helpers.
//
// Operand layouts (the wrapper stages them; Cp is Cin rounded up to a
// multiple of 8, the pad channels zero, so every channel run is whole
// 16-byte vectors):
//   x    (B, H, W, Cp)   bf16, channels-last
//   wom  (9, Cp, 32)     bf16, the offset conv's weight, tap-major, its 27
//                        outputs padded with zeros to 32 (four n8 tiles)
//   wt   (9, Cp, Cop)    bf16, the layer's weight, tap-major, Cout padded
//                        with zeros to Cop, a multiple of 16
//
// The offset conv of one tile, om = conv(x, W_om) + b_om, is the implicit
// GEMM [64 pixels x 9*Cp] . [9*Cp x 32] on mma.sync: per chunk of 32
// channels the tile's 10 x 10 halo of x and the chunk of W_om for all nine
// taps arrive in shared memory by cp.async, once, and each tap's A operand
// is the halo read at the tap's shift (ldmatrix takes one row address per
// lane, so a shifted window costs nothing). bf16 operands, f32
// accumulation, the f32 bias added and om left in f32, as the TPU kernel
// and the twin compute it.
#pragma once

#include "dcn_mma.cuh"

namespace dcn {

constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kTilePix = kTileH * kTileW;  // 64: M of the products over pixels
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPix = (kTileH + 2) * kHaloW;  // 100
constexpr int kOmN = 32;  // the 27 offset-conv outputs padded to 4 n8 tiles
constexpr int kKc = 32;   // channels per staged chunk of x
// bf16 pad of every shared row read by ldmatrix: the row pitch is then an
// odd number of 16-byte units, and the 8 rows of a tile hit distinct banks
constexpr int kRowPad = 8;
constexpr int kChunkPitch = kKc + kRowPad;  // 40
constexpr int kOmWPitch = kOmN + kRowPad;   // 40
constexpr int kOmPitch = kOm + 1;           // f32 row of one pixel's om

// shared bytes of the om routine: the halo chunk, then W_om's chunk
constexpr size_t kOmHaloBytes = (size_t)kHaloPix * kChunkPitch * 2;  // 8000
constexpr size_t kOmStageBytes =
    kOmHaloBytes + (size_t)kTaps * kKc * kOmWPitch * 2;  // 31040
constexpr size_t kTileOmBytes = (size_t)kTilePix * kOmPitch * 4;  // 7168

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__host__ __device__ constexpr int round_up16(int n) { return (n + 15) & ~15; }

// One pixel's om, a row of the tile's shared om, read as `sample_at` reads
// the `OffsetConv` layout.
struct TileOm {
  const float* row;

  __device__ __forceinline__ void read(int, int t, size_t, size_t, float& dy,
                                       float& dx, float& m) const {
    dy = row[2 * t];
    dx = row[2 * t + 1];
    m = 1.f / (1.f + expf(-row[2 * kTaps + t]));
  }
};

// The lane's row in the ldmatrix x4 of a 16 x 16 A tile (rows 0-7 / 8-15,
// columns 0-7 / 8-15 as tiles 0, 1, 2, 3) and of two 8-wide B tiles.
struct LdRows {
  int j, r8;
  __device__ __forceinline__ LdRows() : j((threadIdx.x & 31) >> 3),
                                        r8(threadIdx.x & 7) {}
  // A from [row][k] storage, non-transposed: row, k offset
  __device__ __forceinline__ int a_row() const { return r8 + 8 * (j & 1); }
  __device__ __forceinline__ int a_k() const { return 8 * (j >> 1); }
  // B tiles n 0-7 and 8-15 from [n][k] storage, non-transposed
  __device__ __forceinline__ int bn_row() const { return r8 + 8 * (j >> 1); }
  __device__ __forceinline__ int bn_k() const { return 8 * (j & 1); }
  // B tiles from [k][n] storage, transposed: k row, n offset
  __device__ __forceinline__ int bk_row() const { return r8 + 8 * (j & 1); }
  __device__ __forceinline__ int bk_n() const { return 8 * (j >> 1); }
  // A = S^T from [k][m] storage (S rows are k), transposed: k row, m offset
  __device__ __forceinline__ int at_k() const { return r8 + 8 * (j >> 1); }
  __device__ __forceinline__ int at_m() const { return 8 * (j & 1); }
};

// om of the 8 x 8 tile at (y0, x0) of one image into s_om[kTilePix]
// [kOmPitch] (f32, bias added; pixels off the map hold the bias alone).
// `stage` holds kOmStageBytes. With `stat` non-null, max |dy| over the
// tile's pixels on the map is folded into *stat by one atomicMax on the
// float's bits (non-negative floats order as unsigned ints; a NaN orders
// above every float, so it shows); `s_max` is one shared word. Warps: 4
// along the pixels (16 each) x 2 along the outputs (16 each). Ends with
// __syncthreads().
__device__ __forceinline__ void om_tile(
    const __nv_bfloat16* __restrict__ xb, const __nv_bfloat16* __restrict__ wom,
    const float* __restrict__ bom, int y0, int x0, int H, int W, int Cp,
    unsigned char* stage, float* s_om, unsigned* s_max, unsigned* stat) {
  __nv_bfloat16* s_halo = (__nv_bfloat16*)stage;
  __nv_bfloat16* s_w = (__nv_bfloat16*)(stage + kOmHaloBytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const LdRows ld;
  const int pa = 16 * wm + ld.a_row();
  const int pay = pa / kTileW, pax = pa % kTileW;
  if (tid == 0) *s_max = 0u;

  float acc[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int c0 = 0; c0 < Cp; c0 += kKc) {
    __syncthreads();  // the last chunk's ldmatrix are done with the stage
    for (int i = tid; i < kHaloPix * (kKc / 8); i += kThreads) {
      const int hp = i / (kKc / 8), v = i % (kKc / 8);
      const int yy = y0 - 1 + hp / kHaloW, xx = x0 - 1 + hp % kHaloW;
      const int c = c0 + 8 * v;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && c < Cp;
      cp_async16(s_halo + hp * kChunkPitch + 8 * v,
                 ok ? xb + ((size_t)yy * W + xx) * Cp + c : xb, ok);
    }
    for (int i = tid; i < kTaps * kKc * (kOmN / 8); i += kThreads) {
      const int v = i % (kOmN / 8);
      const int r = (i / (kOmN / 8)) % kKc;
      const int t = i / (kKc * (kOmN / 8));
      const bool ok = c0 + r < Cp;
      cp_async16(s_w + (t * kKc + r) * kOmWPitch + 8 * v,
                 ok ? wom + ((size_t)t * Cp + c0 + r) * kOmN + 8 * v : wom,
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const __nv_bfloat16* arow =
          s_halo + ((pay + t / 3) * kHaloW + pax + t % 3) * kChunkPitch +
          ld.a_k();
      const __nv_bfloat16* brow =
          s_w + (t * kKc + ld.bk_row()) * kOmWPitch + 16 * wn + ld.bk_n();
#pragma unroll
      for (int ks = 0; ks < kKc; ks += 16) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, arow + ks);
        ldmatrix_x4_trans(b, brow + ks * kOmWPitch);
        mma_bf16_16816(acc[0], a, b[0], b[1]);
        mma_bf16_16816(acc[1], a, b[2], b[3]);
      }
    }
  }

  const int g = lane >> 2, q = lane & 3;
  unsigned dmax = 0u;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 16 * wm + g + 8 * (i >> 1);
      const int o = 16 * wn + 8 * n + 2 * q + (i & 1);
      if (o >= kOm) continue;
      const float v = acc[n][i] + bom[o];
      s_om[p * kOmPitch + o] = v;
      if (o < 2 * kTaps && (o & 1) == 0 && y0 + p / kTileW < H &&
          x0 + p % kTileW < W) {
        const unsigned bits = __float_as_uint(fabsf(v));
        dmax = bits > dmax ? bits : dmax;
      }
    }
  if (stat != nullptr) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const unsigned other = __shfl_xor_sync(0xffffffffu, dmax, s);
      dmax = other > dmax ? other : dmax;
    }
    if (lane == 0) atomicMax(s_max, dmax);
    __syncthreads();
    if (tid == 0) atomicMax(stat, *s_max);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// host side

__host__ inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// check_launch, then lets the kernel take `dyn_smem` bytes of dynamic
// shared memory (above 48 KB only after this attribute is raised)
template <typename Kernel>
__host__ cudaError_t prepare_launch(Kernel kernel, size_t dyn_smem) {
  cudaError_t err = check_launch(kernel, kThreads, dyn_smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dyn_smem);
}

// Blocks that put "about two" on every SM: at least 1.9 per SM.
__host__ inline bool too_few_blocks(long long blocks, int sms) {
  return blocks * 10 < 19LL * sms;
}

// n8 tiles per warp of the Cout group that covers min(Cout, 256): 2, 4, 8
// or 16 (groups of 32, 64, 128 or 256 output channels)
__host__ inline int cout_group_tiles(int Cout) {
  int nt = 16;
  while (nt > 2 && 16 * (nt / 2) >= Cout) nt /= 2;
  return nt;
}

}  // namespace dcn
