// Train-mode BatchNorm's backward for Hopper (sm_90a): float32 NCHW maps,
// one statistics group.
//
// Replaces no TPU kernel: XLA fused BatchNorm into its neighbours on the
// TPU. On the card cuDNN's `bn_bw_1C11` ran it, and its NCHW kernel gives
// each channel to one block: DLA-34 has 16 channels at 512 x 512 and 64 at
// 128 x 128 (batch 16), so a grid of 16 to 64 blocks streams 4 to 67 M
// elements on 132 SMs, and the backward reached 16 % of the card's
// 3.35 TB/s over DLA-34's 55 layers. The forward stays torch's own
// (`bn_fw_tr_1C11` on the card), and the backward takes the mean and
// invstd that it saved, so a layer's output is the same bits as torch's
// batch norm gives.
//
// Bound: bytes. The backward reads x and dy to reduce them per channel,
// then reads both again and writes dx (five passes of the map). At 2 bytes
// of traffic per FLOP and less, no part of it comes near the FP32 units.
//
// What the design does about it: every kernel fills the card whatever the
// channel count.
// - `bn_train_reduce_kernel` splits each channel's N * H * W elements into
//   slices sized from the shape (the wrapper, `ops/batchnorm.py`), one
//   block a (slice, channel), so a 16-channel map at 512 px and a
//   512-channel one at 16 px both launch a few waves of 132 SMs. Each
//   block writes its slice's sum of dy and of dy * (x - mean) to a
//   workspace of its own place, [2][slices][C].
// - `bn_train_finalize_kernel` adds a channel's slices in slice order (one
//   warp a channel: lane l takes slices l, l + 32, ..., then a fixed
//   shuffle tree), giving d(bias) and d(weight).
// - `bn_train_dx_kernel` is elementwise over the whole map, 16-byte loads
//   and stores where H * W is a multiple of 4 and the pointers are 16-byte
//   aligned (`V` = 4; else 1), kUnroll vectors a thread in flight; each
//   vector finds its channel from its index.
// No float is added by an atomic and every sum has one order fixed by the
// shape, so a call gives the same bits on every run, whatever order the
// blocks run in, eager or inside a CUDA graph.
//
// Arithmetic, all float32, with the forward's saved mean and invstd:
//   d(bias) = sum dy; d(weight) = invstd * sum dy * (x - mean);
//   dx = weight * invstd * (dy - d(bias) / M - (x - mean) * invstd *
//        d(weight) / M), M = N * H * W.
#include <cuda_runtime.h>

namespace bn_train {

constexpr int kThreads = 256;  // every kernel: 256 threads
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // vectors a thread loads before it computes

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* __restrict__ p,
                                       unsigned j) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[j];
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = p[j];
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, unsigned j,
                                      const Vec<V>& r) {
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(p)[j] =
        make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    p[j] = r.v[0];
  }
}

// the sum of v over the warp, the same bits in every lane (each step adds
// the same two values in either lane, and a float sum of two commutes)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = 16; k > 0; k /= 2) v += __shfl_xor_sync(0xffffffffu, v, k);
  return v;
}

// Block (s, c) sums dy and dy * (x - mean) over vectors [s * slice,
// (s + 1) * slice) of channel c's `count` = N * hw vectors, and writes the
// two sums to part[0][s][c] and part[1][s][c].
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_train_reduce_kernel(const float* __restrict__ x,
                           const float* __restrict__ dy,
                           const float* __restrict__ mean,
                           float* __restrict__ part, unsigned count,
                           unsigned hw, unsigned C, unsigned slice) {
  const unsigned c = blockIdx.y, s = blockIdx.x, slices = gridDim.x;
  const unsigned begin = s * slice;
  const unsigned end = min(begin + slice, count);
  const float m = mean[c];
  float sum_dy = 0.f, sum_dyx = 0.f;
  for (unsigned j0 = begin + threadIdx.x; j0 < end;
       j0 += kThreads * kUnroll) {
    Vec<V> xs[kUnroll], gs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned j = j0 + u * kThreads;
      if (j < end) {
        const unsigned n = j / hw;
        const unsigned at = (n * C + c) * hw + (j - n * hw);
        xs[u] = load<V>(x, at);
        gs[u] = load<V>(dy, at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * kThreads < end) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          sum_dy += gs[u].v[k];
          sum_dyx = fmaf(gs[u].v[k], xs[u].v[k] - m, sum_dyx);
        }
      }
    }
  }
  sum_dy = warp_sum(sum_dy);
  sum_dyx = warp_sum(sum_dyx);
  __shared__ float warps[2][kWarps];
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warps[0][warp] = sum_dy;
    warps[1][warp] = sum_dyx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += warps[0][w];
      b += warps[1][w];
    }
    part[(size_t)s * C + c] = a;
    part[((size_t)slices + s) * C + c] = b;
  }
}

// One warp a channel: d(bias) = the slices' sums of dy, d(weight) = invstd
// times their sums of dy * (x - mean), each in a fixed order.
__global__ void __launch_bounds__(kThreads)
    bn_train_finalize_kernel(const float* __restrict__ part,
                             const float* __restrict__ invstd, unsigned C,
                             unsigned slices,
                             float* __restrict__ dweight,
                             float* __restrict__ dbias) {
  const unsigned c = blockIdx.x * kWarps + threadIdx.x / 32;
  const unsigned lane = threadIdx.x % 32;
  if (c >= C) return;  // a whole warp leaves together
  float a = 0.f, b = 0.f;
  for (unsigned s = lane; s < slices; s += 32) {
    a += part[(size_t)s * C + c];
    b += part[((size_t)slices + s) * C + c];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    dbias[c] = a;
    dweight[c] = b * invstd[c];
  }
}

// dx over `n` vectors of V floats, `hw` vectors a (sample, channel) plane, C
// channels; inv_count = 1 / (N * H * W).
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_train_dx_kernel(const float* __restrict__ x,
                       const float* __restrict__ dy,
                       const float* __restrict__ mean,
                       const float* __restrict__ invstd,
                       const float* __restrict__ weight,
                       const float* __restrict__ dweight,
                       const float* __restrict__ dbias, float inv_count,
                       float* __restrict__ dx, unsigned n, unsigned hw,
                       unsigned C) {
  const unsigned first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  Vec<V> xs[kUnroll], gs[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned j = first + u * kThreads;
    if (j < n) {
      xs[u] = load<V>(x, j);
      gs[u] = load<V>(dy, j);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned j = first + u * kThreads;
    if (j < n) {
      const unsigned c = (j / hw) % C;
      const float istd = invstd[c], m = mean[c];
      const float scale = weight[c] * istd;
      const float mean_dy = dbias[c] * inv_count;
      const float slope = dweight[c] * istd * inv_count;
      Vec<V> out;
#pragma unroll
      for (int k = 0; k < V; ++k)
        out.v[k] =
            scale * fmaf(m - xs[u].v[k], slope, gs[u].v[k] - mean_dy);
      store<V>(dx, j, out);
    }
  }
}

inline long long elementwise_blocks(long long n) {
  return (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
}

}  // namespace bn_train

extern "C" {

// Launches the backward on `stream`: the reduce over `slices` slices of
// `slice` vectors a channel into `part` ((2, slices, C) f32, not zeroed),
// the finalize into dweight and dbias (C,), then, where dx is not null, dx.
// Returns the first cudaError_t.
int bn_train_bwd(const void* x, const void* dy, const void* mean,
                 const void* invstd, const void* weight, void* part,
                 int slices, int slice, void* dweight, void* dbias, void* dx,
                 int N, int C, int hw, int V, void* stream) {
  using namespace bn_train;
  const long long n = (long long)N * C * hw, count = (long long)N * hw;
  if (n >= 0x7fffffffLL || (V != 1 && V != 4) || C > 65535 || slices < 1 ||
      (long long)slices * slice < count)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  const float* meanf = static_cast<const float*>(mean);
  const float* istdf = static_cast<const float*>(invstd);
  float* partf = static_cast<float*>(part);
  auto reduce = [&](auto kernel) {
    kernel<<<dim3((unsigned)slices, (unsigned)C), kThreads, 0, s>>>(
        xf, dyf, meanf, partf, (unsigned)count, (unsigned)hw, (unsigned)C,
        (unsigned)slice);
  };
  if (V == 4)
    reduce(bn_train_reduce_kernel<4>);
  else
    reduce(bn_train_reduce_kernel<1>);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_train_finalize_kernel<<<(unsigned)((C + kWarps - 1) / kWarps), kThreads,
                             0, s>>>(partf, istdf, (unsigned)C,
                                     (unsigned)slices,
                                     static_cast<float*>(dweight),
                                     static_cast<float*>(dbias));
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return (int)err;
  const float inv_count = (float)(1.0 / (double)((long long)N * hw * V));
  auto apply = [&](auto kernel) {
    kernel<<<(unsigned)elementwise_blocks(n), kThreads, 0, s>>>(
        xf, dyf, meanf, istdf, static_cast<const float*>(weight),
        static_cast<const float*>(dweight), static_cast<const float*>(dbias),
        inv_count, static_cast<float*>(dx), (unsigned)n, (unsigned)hw,
        (unsigned)C);
  };
  if (V == 4)
    apply(bn_train_dx_kernel<4>);
  else
    apply(bn_train_dx_kernel<1>);
  return (int)cudaGetLastError();
}

const char* bn_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
