// The backward of a float32 depthwise convolution for Hopper (sm_90a):
// NCHW maps, one filter a channel (groups = C_in = C_out), a square kernel
// of K = 3 or 5, stride S = 1 or 2, zero padding (ph, pw), dilation 1.
//
// Replaces no TPU kernel: the JAX package's depthwise conv is XLA's
// `feature_group_count` conv (centernet_uda_tpu/models/efficientnet.py,
// MBConv's `_depthwise_conv`). On the card ATen ran its backward on two
// kernels of its own, `conv_depthwise2d_backward_kernel` (dx) and
// `conv_depthwise2d_grad_weight_kernel` (dW), the second with one block a
// (channel, tap) reducing all of N * Ho * Wo inside it: 360 blocks for
// EfficientNet-b3's first layer (40 channels at 256 x 256, batch 8), each
// summing 524 k products. The forward stays ATen's (`ops/depthwise.py`),
// so a layer's output is the same bits as `F.conv2d` gives.
//
// Bound: bytes. The backward needs g and x in and dx out; at 2 K^2 FMAs
// for 12 bytes of traffic a pixel (S = 1) it is far below the card's
// FP32 rate.
//
// What the design does about it: one pass that reads g and x once.
// - `depthwise_bwd_kernel` gives each block a tile of `rows` cell rows of
//   `planes` (n, c) planes. A cell is an S x S quad of input pixels in
//   padded coordinates: input (iy, ix) = (S i + a - ph, S j + b - pw),
//   a, b < S. Each input pixel lies in one cell, so stride 2 works by
//   parity classes: pixel (a, b) of a cell takes exactly the taps
//   ky = a, a + S, ... and kx = b, b + S, ..., each from g at
//   (i - (ky - a) / S, j - (kx - b) / S), offsets fixed at compile time.
//   The block stages its g tile, with its R = (K - 1) / S rows and
//   columns of halo, zero outside the map, in shared memory; its threads
//   then walk the tile's cells (threads of one plane on neighbouring
//   cells, so x and dx are read and written along rows), load x, and for
//   every (pixel, tap) read g once and add it into dx (times the weight)
//   and into that tap's dW sum (times x). A block owns each of its input
//   pixels, so dx is written once, by one thread, and each (pixel, tap)
//   product enters one dW sum. A thread issues its first cells' x loads
//   before the g tile's barrier and each next batch's before it computes
//   the current one, so that their latency overlaps other work.
// - The tile's dW sums go to a workspace slot of their own,
//   part[n * row_tiles + row_tile][c][tap], by a fixed tree over the
//   plane's threads (shuffles, then the warps in order).
// - `depthwise_bwd_finalize_kernel` adds each (c, tap)'s slots in slot
//   order (one warp an output: lane l takes slots l, l + 32, ..., then a
//   fixed shuffle tree), as `bn_train_finalize_kernel` does.
// The wrapper sizes the tile from the shape (threads a plane, planes a
// block, rows a tile), so that every layer from 40 channels at 256 x 256
// to 2304 at 16 x 16 launches a few waves of 132 SMs.
// No float is added by an atomic and every sum has one order fixed by the
// shape, so a call gives the same bits on every run, whatever order the
// blocks run in, eager or inside a CUDA graph.
#include <cuda_runtime.h>

#ifndef DCN_DYNAMIC_SMEM
// the block's dynamic shared memory, as a byte array named `name`
#define DCN_DYNAMIC_SMEM(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

namespace depthwise {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the shape of one call, as the kernels read it
struct Shape {
  unsigned planes;  // N * C
  int C, H, W, Ho, Wo, ph, pw;
  int i_lo, cells_i, j_lo, cells_j;  // first cell and cells, rows and columns
  int tpp_log2;  // threads a plane: 1 << tpp_log2; planes a block: the rest
  int rows;      // cell rows of a tile (the last tile may have fewer)
  int row_tiles;
};

// the sum of v over groups of `width` lanes (a power of two up to 32), the
// same bits in every lane of a group (each step adds the same two values
// in either lane, and a float sum of two commutes)
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int k = width / 2; k > 0; k /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, k);
  return v;
}

// (r, c) += a step of `dr` rows and `dc` < cols columns, carried
__device__ __forceinline__ void advance(int& r, int& c, int dr, int dc,
                                        int cols) {
  c += dc;
  r += dr;
  if (c >= cols) {
    c -= cols;
    ++r;
  }
}

// cells a thread loads x for before it computes
template <int S>
constexpr int kUnroll = S == 1 ? 4 : 2;

// Block (blockIdx.x, blockIdx.y): planes [blockIdx.x * planes_per_block,
// ...) and cell rows [i_lo + blockIdx.y * rows, ...). Writes dx of the
// tile's input pixels and its dW sums into `part`.
template <int K, int S>
__global__ void __launch_bounds__(kThreads, 2)
    depthwise_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         const float* __restrict__ w,
                         float* __restrict__ dx, float* __restrict__ part,
                         Shape sh) {
  constexpr int R = (K - 1) / S, KK = K * K, U = kUnroll<S>;
  DCN_DYNAMIC_SMEM(smem);
  float* gs = reinterpret_cast<float*>(smem);
  __shared__ float red[kWarps][KK];

  const int tpp = 1 << sh.tpp_log2, per_block = kThreads >> sh.tpp_log2;
  const unsigned p0 = blockIdx.x * (unsigned)per_block;
  const int rt = blockIdx.y;
  const int ib = sh.i_lo + rt * sh.rows;  // the tile's first cell row
  const int tr = min(sh.rows, sh.cells_i - rt * sh.rows);
  const int gh = tr + R, gw = sh.cells_j + R, per_plane = gh * gw;

  // this thread's plane q of the block and its cells: tile cells tl,
  // tl + tpp, ... in row-major order, at (rr, cc) of the tile
  const int q = threadIdx.x >> sh.tpp_log2, tl = threadIdx.x & (tpp - 1);
  const unsigned p = p0 + q;
  const bool live = p < sh.planes;
  const int c = live ? (int)(p % (unsigned)sh.C) : 0;
  const size_t plane_at = (size_t)(live ? p : 0) * sh.H * sh.W;
  const float* xp = x + plane_at;
  float* dxp = dx + plane_at;
  const int cells = live ? tr * sh.cells_j : 0;
  const int step_r = tpp / sh.cells_j, step_c = tpp % sh.cells_j;
  int rr = tl / sh.cells_j, cc = tl % sh.cells_j;

  // x of the next U cells from e0 (zero outside the map and past the
  // tile), and where they lie
  auto fetch = [&](int e0, float (&xs)[U][S][S], int (&at_r)[U],
                   int (&at_c)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      at_r[u] = rr;
      at_c[u] = cc;
      advance(rr, cc, step_r, step_c, sh.cells_j);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = e0 + u * tpp < cells;
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int b = 0; b < S; ++b) {
          const int iy = S * (ib + at_r[u]) + a - sh.ph;
          const int ix = S * (sh.j_lo + at_c[u]) + b - sh.pw;
          const bool ok =
              in && iy >= 0 && iy < sh.H && ix >= 0 && ix < sh.W;
          xs[u][a][b] = ok ? xp[iy * sh.W + ix] : 0.f;
        }
    }
  };
  float xv[U][S][S];
  int at_r[U], at_c[U];
  fetch(tl, xv, at_r, at_c);  // in flight while g is staged

  // stage g rows [ib - R, ib + tr) and columns [j_lo - R, j_lo + cells_j)
  // of the block's planes, zero outside the map and past the last plane
  {
    const int step_q = kThreads / per_plane;
    const int step_gr = kThreads % per_plane / gw;
    const int step_gc = kThreads % gw;
    int sq = threadIdx.x / per_plane;
    int r = threadIdx.x % per_plane / gw, col = threadIdx.x % gw;
#pragma unroll 4
    for (int e = threadIdx.x; e < per_block * per_plane; e += kThreads) {
      const unsigned sp = p0 + sq;
      const int oy = ib - R + r, ox = sh.j_lo - R + col;
      float v = 0.f;
      if (sp < sh.planes && oy >= 0 && oy < sh.Ho && ox >= 0 && ox < sh.Wo)
        v = g[((size_t)sp * sh.Ho + oy) * sh.Wo + ox];
      gs[e] = v;
      advance(r, col, step_gr, step_gc, gw);
      if (r >= gh) {
        r -= gh;
        ++sq;
      }
      sq += step_q;
    }
  }

  float wr[KK], acc[KK];
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    wr[k] = live ? w[c * KK + k] : 0.f;
    acc[k] = 0.f;
  }
  __syncthreads();

  const float* gt = gs + q * per_plane;
  for (int e0 = tl; e0 < cells; e0 += U * tpp) {
    float xn[U][S][S];
    int nr[U], nc[U];
    fetch(e0 + U * tpp, xn, nr, nc);  // the next cells' x, in flight
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e0 + u * tpp >= cells) break;
      // g at the cell itself: staged row at_r + R, column at_c + R
      const float* gc = gt + (at_r[u] + R) * gw + at_c[u] + R;
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int b = 0; b < S; ++b) {
          float d = 0.f;
#pragma unroll
          for (int ky = a; ky < K; ky += S)
#pragma unroll
            for (int kx = b; kx < K; kx += S) {
              const float gv = gc[-((ky - a) / S) * gw - (kx - b) / S];
              d = fmaf(gv, wr[ky * K + kx], d);
              acc[ky * K + kx] = fmaf(gv, xv[u][a][b], acc[ky * K + kx]);
            }
          const int iy = S * (ib + at_r[u]) + a - sh.ph;
          const int ix = S * (sh.j_lo + at_c[u]) + b - sh.pw;
          if (iy >= 0 && iy < sh.H && ix >= 0 && ix < sh.W)
            dxp[iy * sh.W + ix] = d;
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      at_r[u] = nr[u];
      at_c[u] = nc[u];
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int b = 0; b < S; ++b) xv[u][a][b] = xn[u][a][b];
    }
  }

  // the plane's sums: over its lanes of a warp, then over its warps in
  // order; slot n * row_tiles + rt of channel c
  const int width = tpp < 32 ? tpp : 32;
#pragma unroll
  for (int k = 0; k < KK; ++k) acc[k] = group_sum(acc[k], width);
  const size_t slot =
      live ? ((size_t)(p / (unsigned)sh.C) * sh.row_tiles + rt) * sh.C + c
           : 0;
  if (tpp <= 32) {
    if (live && tl == 0) {
#pragma unroll
      for (int k = 0; k < KK; ++k) part[slot * KK + k] = acc[k];
    }
    return;
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < KK; ++k) red[warp][k] = acc[k];
  }
  __syncthreads();
  const int warps = tpp / 32;  // a plane's warps: [q * warps, (q + 1) * warps)
  if (live && tl < KK) {
    float s = 0.f;
    for (int v = 0; v < warps; ++v) s += red[q * warps + v][tl];
    part[slot * KK + tl] = s;
  }
}

// One warp an output o = c * K^2 + tap: dw[o] = the sum over slots of
// part[slot][o], in a fixed order.
__global__ void __launch_bounds__(kThreads)
    depthwise_bwd_finalize_kernel(const float* __restrict__ part,
                                  unsigned outputs, unsigned slots,
                                  float* __restrict__ dw) {
  const unsigned o = blockIdx.x * kWarps + threadIdx.x / 32;
  const unsigned lane = threadIdx.x % 32;
  if (o >= outputs) return;  // a whole warp leaves together
  float s = 0.f;
  for (unsigned v = lane; v < slots; v += 32)
    s += part[(size_t)v * outputs + o];
  s = group_sum(s, 32);
  if (lane == 0) dw[o] = s;
}

}  // namespace depthwise

extern "C" {

// Launches the backward on `stream`: the tile kernel over (ceil(N * C /
// planes a block), row_tiles) blocks into `part` ((N * row_tiles, C, K,
// K) f32, not zeroed) and dx (N, C, H, W), then the finalize
// into dw (C, 1, K, K). x is (N, C, H, W), g (N, C, Ho, Wo), w (C, 1, K,
// K), all contiguous f32. Returns the first cudaError_t.
int depthwise_bwd(const void* x, const void* g, const void* w, void* dx,
                  void* part, void* dw, int N, int C, int H, int W, int K,
                  int S, int ph, int pw, int tpp_log2, int rows,
                  int row_tiles, void* stream) {
  using namespace depthwise;
  if (N < 1 || C < 1 || H < 1 || W < 1 || (K != 3 && K != 5) ||
      (S != 1 && S != 2) || ph < 0 || pw < 0 || ph >= K || pw >= K ||
      tpp_log2 < 0 || tpp_log2 > 8 || rows < 1)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.planes = (unsigned)N * (unsigned)C;
  sh.C = C;
  sh.H = H;
  sh.W = W;
  sh.Ho = (H + 2 * ph - K) / S + 1;
  sh.Wo = (W + 2 * pw - K) / S + 1;
  sh.ph = ph;
  sh.pw = pw;
  sh.i_lo = ph / S;
  sh.cells_i = (H - 1 + ph) / S + 1 - sh.i_lo;
  sh.j_lo = pw / S;
  sh.cells_j = (W - 1 + pw) / S + 1 - sh.j_lo;
  sh.tpp_log2 = tpp_log2;
  sh.rows = rows;
  sh.row_tiles = row_tiles;
  const long long n = (long long)N * C * H * W;
  if (sh.Ho < 1 || sh.Wo < 1 || n >= 0x7fffffffLL ||
      (long long)N * C * sh.Ho * sh.Wo >= 0x7fffffffLL ||
      (long long)rows * row_tiles < sh.cells_i ||
      (long long)rows * (row_tiles - 1) >= sh.cells_i)
    return (int)cudaErrorInvalidValue;
  const int R = (K - 1) / S, per_block = kThreads >> tpp_log2;
  const size_t smem = sizeof(float) * (size_t)per_block * (rows + R) *
                      (sh.cells_j + R);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned groups = (sh.planes + per_block - 1) / per_block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const float* wf = static_cast<const float*>(w);
  float* dxf = static_cast<float*>(dx);
  float* partf = static_cast<float*>(part);
  auto tiles = [&](auto kernel) {
    kernel<<<dim3(groups, (unsigned)row_tiles), kThreads, smem, s>>>(
        xf, gf, wf, dxf, partf, sh);
  };
  if (K == 3 && S == 1)
    tiles(depthwise_bwd_kernel<3, 1>);
  else if (K == 3)
    tiles(depthwise_bwd_kernel<3, 2>);
  else if (S == 1)
    tiles(depthwise_bwd_kernel<5, 1>);
  else
    tiles(depthwise_bwd_kernel<5, 2>);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned outputs = (unsigned)C * K * K;
  depthwise_bwd_finalize_kernel<<<(outputs + kWarps - 1) / kWarps, kThreads,
                                  0, s>>>(
      partf, outputs, (unsigned)N * (unsigned)row_tiles,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

const char* depthwise_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
