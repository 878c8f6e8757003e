"""The CUDA kernel sources, compiled for the CPU, against their plain twins.

The kernels in ``centernet_uda_torch/csrc/`` run only on an H100, and the
card-only tests (``tests/test_torch_gpu.py``) skip without one. This file
compiles the same sources (the seven DCN ones, BatchNorm's
``bn_train.cu`` and the depthwise conv's ``depthwise_bwd.cu``) with the
host C++ compiler against ``EMULATION_HEADER`` below (a CPU emulation of
the CUDA subset they use: a block's threads as a pool of OS threads,
``__syncthreads`` as a barrier, the warp-wide ``mma.sync`` primitives lane
by lane; the ``<<<...>>>`` launches of the sources and of their headers
rewritten as calls),
loads them in place of the ``nvcc`` builds, and runs them through the
wrappers' launch helpers on CPU tensors at tiny shapes. That holds the
kernels' indexing, tiling, masking and arithmetic against the twins on every
CPU run; the card runs show that ``nvcc`` builds them and what they cost.
The emulation runs a grid's blocks in the order ``DCN_EMU_BLOCK_ORDER``
names (in order, reversed, or a seeded permutation), and the repeat tests
run all seven DCN kernels, the BatchNorm backward and the depthwise
backward in three orders: every output must have the same bits in each, as
a kernel whose sums have one order gives them on the card.

Tolerance: that of the card tests, atol 5e-2 * max(1, max|twin|) and rtol
5e-2, and max |dy| to 1e-5 relative; the operands are the card tests' own
(the fused ones quantised so that the offset conv is exact in any summation
order). BatchNorm's backward computes in float32 as its twin does, in
another order: 1e-4 of the largest value, relative and absolute; so does
the depthwise backward. It skips without a C++20 compiler.
"""

import re
import shutil
import subprocess

import pytest
import torch

from centernet_uda_torch.ops import batchnorm, dcn_cuda, depthwise
from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT
from test_torch_gpu import make_fused_inputs, make_inputs

torch.set_num_threads(2)

LAUNCH = re.compile(r"([A-Za-z_]\w*)<<<(.*?)>>>\(", re.S)

# written into the build directory as cuda_emulation.h
EMULATION_HEADER = r"""// CPU emulation of the CUDA subset that centernet_uda_torch/csrc uses.
//
// A launch runs one block at a time on a pool of blockDim threads, the
// blocks in the order that DCN_EMU_BLOCK_ORDER names when the launch starts:
// unset or "forward" in order (x fastest), "reverse", or a number, the seed
// of a permutation; __syncthreads is a barrier of that pool, __shared__
// variables are statics (one instance per kernel, reused block after block,
// which is safe because every kernel writes its shared memory before it
// reads it), dynamic shared memory is one buffer of the launch's size, and
// the integer atomics are std::atomic_ref (the kernels add no float by an
// atomic, so this header offers none). The warp-wide operations go through
// a buffer between two barriers of the warp's 32 threads (every lane must
// reach them, as on the card): the shuffles, the ballot, __match_any_sync,
// __syncwarp (one barrier), and the
// dcn_mma.cuh primitives with the per-lane fragment layouts of the PTX ISA
// (ldmatrix x4 and its .trans form, mma m16n8k16 with bf16 operands and f32
// accumulation). cp.async is a plain copy (its waits no-ops). bf16
// conversions round to nearest even, as __float2bfloat16 does. Device
// limits and errors are stubs: every launch "succeeds", on a card of 2 SMs.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <math.h>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static
#define DCN_CPU_EMULATION 1
#define DCN_DYNAMIC_SMEM(name) unsigned char* name = ::emu::dynamic_smem

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct emu_uint3 {
  unsigned x, y, z;
};
inline thread_local emu_uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

typedef int cudaError_t;
enum : int {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
typedef void* cudaStream_t;
struct cudaFuncAttributes {
  int maxThreadsPerBlock;
  size_t sharedSizeBytes;
};
enum cudaDeviceAttr {
  cudaDevAttrMaxSharedMemoryPerBlock = 8,
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, T) {
  a->maxThreadsPerBlock = 1024;
  a->sharedSizeBytes = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 2
       : a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 227 * 1024
                                                      : 48 * 1024;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

struct __nv_bfloat16 {
  uint16_t bits;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  __nv_bfloat16 h;
  if ((u & 0x7fffffffu) > 0x7f800000u) {  // NaN stays NaN
    h.bits = (uint16_t)((u >> 16) | 0x40);
    return h;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  h.bits = (uint16_t)(u >> 16);
  return h;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.bits; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline int __ffs(int v) { return __builtin_ffs(v); }

namespace emu {
inline unsigned char* dynamic_smem = nullptr;
inline std::barrier<>* block_barrier = nullptr;
inline thread_local std::barrier<>* warp_barrier = nullptr;
inline void syncthreads() { block_barrier->arrive_and_wait(); }
}  // namespace emu
#define __syncthreads() ::emu::syncthreads()

template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static T buf[1024];
  const unsigned tid = threadIdx.x;
  buf[tid] = v;
  emu::warp_barrier->arrive_and_wait();
  const T r = buf[(tid & ~31u) | ((tid & 31u) ^ (unsigned)lane_mask)];
  emu::warp_barrier->arrive_and_wait();
  return r;
}

template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  static T buf[1024];
  const unsigned tid = threadIdx.x;
  buf[tid] = v;
  emu::warp_barrier->arrive_and_wait();
  const T r = (tid & 31u) >= delta ? buf[tid - delta] : v;
  emu::warp_barrier->arrive_and_wait();
  return r;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  static int buf[1024];
  const unsigned tid = threadIdx.x, base = tid & ~31u;
  buf[tid] = pred != 0;
  emu::warp_barrier->arrive_and_wait();
  unsigned r = 0;
  for (unsigned l = 0; l < 32; ++l) r |= buf[base + l] ? 1u << l : 0u;
  emu::warp_barrier->arrive_and_wait();
  return r;
}

inline unsigned __match_any_sync(unsigned, int v) {
  static int buf[1024];
  const unsigned tid = threadIdx.x, base = tid & ~31u;
  buf[tid] = v;
  emu::warp_barrier->arrive_and_wait();
  unsigned r = 0;
  for (unsigned l = 0; l < 32; ++l) r |= buf[base + l] == v ? 1u << l : 0u;
  emu::warp_barrier->arrive_and_wait();
  return r;
}

inline void __syncwarp() { emu::warp_barrier->arrive_and_wait(); }

inline int __popc(unsigned v) { return __builtin_popcount(v); }

inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}

inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

// the dcn_mma.cuh primitives
namespace dcn {
inline uint16_t emu_b16(const void* row, int col) {
  return static_cast<const uint16_t*>(row)[col];
}

// lane l gives the address of row l % 8 of tile l / 8; register j gets row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of tile j (transposed: rows
// 2 (l % 4) and 2 (l % 4) + 1 of column l / 4)
inline void emu_ldmatrix(uint32_t (&r)[4], const void* row, bool trans) {
  static const void* rows[1024];
  const unsigned tid = threadIdx.x, base = tid & ~31u, lane = tid & 31u;
  rows[tid] = row;
  emu::warp_barrier->arrive_and_wait();
  for (int j = 0; j < 4; ++j) {
    const unsigned tile = base + 8 * j;
    uint16_t lo, hi;
    if (trans) {
      lo = emu_b16(rows[tile + 2 * (lane % 4)], lane / 4);
      hi = emu_b16(rows[tile + 2 * (lane % 4) + 1], lane / 4);
    } else {
      lo = emu_b16(rows[tile + lane / 4], 2 * (lane % 4));
      hi = emu_b16(rows[tile + lane / 4], 2 * (lane % 4) + 1);
    }
    r[j] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  emu::warp_barrier->arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  emu_ldmatrix(r, row, false);
}
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  emu_ldmatrix(r, row, true);
}

inline float emu_half(uint32_t reg, int hi) {
  return __uint_as_float(hi ? reg & 0xffff0000u : reg << 16);
}

// D += A . B over the warp's fragments (A 16 x 16 row-major, B 16 x 8
// column-major, D 16 x 8 f32), element k in order
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                           uint32_t b0, uint32_t b1) {
  static uint32_t fa[1024][4], fb[1024][2];
  const unsigned tid = threadIdx.x, base = tid & ~31u, lane = tid & 31u;
  for (int i = 0; i < 4; ++i) fa[tid][i] = a[i];
  fb[tid][0] = b0;
  fb[tid][1] = b1;
  emu::warp_barrier->arrive_and_wait();
  auto A = [&](int m, int k) {  // a0 (g, 2q..), a1 (g+8, ..), a2, a3: k+8
    const uint32_t reg = fa[base + 4 * (m % 8) + (k % 8) / 2]
                           [(m >= 8) + 2 * (k >= 8)];
    return emu_half(reg, k % 2);
  };
  auto B = [&](int k, int n) {  // b0 (2q.., g), b1 (2q+8.., g)
    return emu_half(fb[base + 4 * n + (k % 8) / 2][k >= 8], k % 2);
  };
  for (int i = 0; i < 4; ++i) {
    const int m = lane / 4 + 8 * (i / 2), n = 2 * (lane % 4) + i % 2;
    float s = d[i];
    for (int k = 0; k < 16; ++k) s += A(m, k) * B(k, n);
    d[i] = s;
  }
  emu::warp_barrier->arrive_and_wait();
}

inline void cp_async16(void* dst, const void* src, bool pred) {
  if (pred)
    memcpy(dst, src, 16);
  else
    memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
}  // namespace dcn

namespace emu {
// kernel<<<grid, block, smem, stream>>>(args...), rewritten by the test as
// emu::launch(kernel, grid, block, smem, stream, args...)
template <class... P, class... A>
void launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
            cudaStream_t, A... args) {
  const unsigned n = block.x * block.y * block.z;  // a multiple of 32
  std::vector<unsigned> order(grid.x * grid.y * grid.z);
  std::iota(order.begin(), order.end(), 0u);
  const char* how = std::getenv("DCN_EMU_BLOCK_ORDER");
  if (how != nullptr && std::strcmp(how, "reverse") == 0) {
    std::reverse(order.begin(), order.end());
  } else if (how != nullptr && *how && std::strcmp(how, "forward") != 0) {
    std::mt19937 rng((unsigned)std::atoi(how));
    std::shuffle(order.begin(), order.end(), rng);
  }
  std::vector<uint64_t> dyn(smem / 8 + 4);
  dynamic_smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn.data()) + 15) & ~(uintptr_t)15);
  std::barrier<> bar(n);
  block_barrier = &bar;
  std::deque<std::barrier<>> warps;  // a deque: barriers cannot move
  for (unsigned w = 0; w < n / 32; ++w) warps.emplace_back(32);
  std::vector<std::thread> pool;
  pool.reserve(n);
  for (unsigned t = 0; t < n; ++t)
    pool.emplace_back([&, t] {
      warp_barrier = &warps[t / 32];
      threadIdx = {t % block.x, (t / block.x) % block.y,
                   t / (block.x * block.y)};
      blockDim = block;
      gridDim = grid;
      for (const unsigned id : order) {
        blockIdx = {id % grid.x, id / grid.x % grid.y,
                    id / (grid.x * grid.y)};
        kernel(static_cast<P>(args)...);
        bar.arrive_and_wait();  // the block is done before the next
      }
    });
  for (auto& th : pool) th.join();
}
}  // namespace emu
"""


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """{kernel name: path} of the kernel sources built for the CPU."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler")
    out = tmp_path_factory.mktemp("emulated_kernels")
    (out / "cuda_emulation.h").write_text(EMULATION_HEADER)
    for header in ("cuda_bf16.h", "cuda_runtime.h"):
        (out / header).write_text('#include "cuda_emulation.h"\n')

    def emulated(path):  # launches rewritten as emu::launch calls
        return LAUNCH.sub(lambda m: f"::emu::launch({m[1]}, {m[2]}, ",
                          path.read_text())

    # the sources' own headers, launches rewritten too, beside the .cpp
    # files, so that their quoted includes find these copies first
    for header in dcn_cuda.CSRC.glob("*.cuh"):
        (out / header.name).write_text(emulated(header))
    procs = {}
    sources = {name: dcn_cuda.CSRC / src
               for name, src in dcn_cuda.SOURCES.items()}
    sources[batchnorm.NAME] = batchnorm.SOURCE
    sources[depthwise.NAME] = depthwise.SOURCE
    for name, src in sources.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(emulated(src))
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
             f"-I{out}", f"-I{dcn_cuda.CSRC}", "-o", str(lib),
             str(cpp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name}:\n{log}"
        libs[name] = lib
    return libs


@pytest.fixture
def emulated(emulated_libs, monkeypatch):
    """The wrappers' libraries replaced by the CPU builds, for one test;
    few split-K blocks, since an emulated block costs thread switches."""
    monkeypatch.setattr(dcn_cuda, "_LIBS", {})
    monkeypatch.setattr(dcn_cuda, "_lib_path", emulated_libs.__getitem__)
    monkeypatch.setattr(dcn_cuda, "_DW_TARGET_BLOCKS", 8)
    dcn_cuda.reset_launches()
    yield
    dcn_cuda.reset_launches()


def assert_close(got, want, name):
    got, want = got.double(), want.double()
    scale = max(1.0, float(want.abs().max()))
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2 * scale,
                               msg=name)


SHAPES = [
    # (b, cin, cout, h, w): one tile each way, ragged tiles
    (2, 8, 8, 12, 12),
    (1, 40, 72, 5, 13),
]

# the tensor-core backward's tile edges (dcn_sample_bwd.cuh), shared by the
# explicit-offset and fused layers: Cin not a multiple of 8 (padded) nor of
# the 64-channel chunk; Cin split across data-kernel blocks (6 chunks of 64
# for one tile); Cout above one 256-wide group (two groups, two g panels);
# a map under one 8 x 8 tile with W < 8. A sixth entry "integer" rounds the
# offsets to integers (zero but on the clamped rows): every sample sits on
# an integer position, where the y0+1 corner still enters d(dy).
EXPLICIT_EDGE_SHAPES = [
    pytest.param((1, 20, 40, 9, 10), id="cin20-padded"),
    pytest.param((1, 384, 16, 4, 8), id="cin-split"),
    pytest.param((1, 24, 264, 3, 9), id="cout264"),
    pytest.param((1, 24, 48, 5, 6), id="under-one-tile-w6"),
    pytest.param((2, 16, 16, 12, 12, "integer"), id="integer-offsets"),
]


def assert_not_bf16(out):
    """A float32 output keeps its f32 sums: not every value is a bf16."""
    assert out.dtype == torch.float32
    assert bool((out != out.bfloat16().float()).any()), "rounded to bf16"


def explicit_inputs(seed, shape):
    """make_inputs on ``shape``'s first five entries, and g; "integer"
    keeps the clamped rows and zeroes every other offset."""
    x, off, m, wt, bias = make_inputs(seed, *shape[:5], "cpu")
    if shape[5:] == ("integer",):
        off = torch.where(off.abs() >= PALLAS_MAX_SHIFT, off.round(),
                          torch.zeros_like(off))
    g = torch.randn(shape[0], shape[2], shape[3], shape[4],
                    generator=torch.Generator().manual_seed(seed + 1))
    return x, off, m, wt, bias, g


def check_explicit_backward(name, x, off, m, wt, g, dtype):
    """One call of the explicit-offset backward ``name`` against autograd
    through the twin: gradients in their dtypes and within tolerance, no dy
    gradient where the clamp holds, and nonzero offset gradients."""
    got = dcn_cuda._explicit_backward_launch(name, x, off, m, wt, g,
                                             PALLAS_MAX_SHIFT, 0)
    want = dcn_cuda.dcn_backward_plain(x, off, m, wt, g)
    assert got[0].dtype == got[3].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    for grad, a, b in zip(("dx", "doff", "dmask", "dw"), got, want):
        assert_close(a, b, grad)
    sat = off[:, 0::2].abs() >= PALLAS_MAX_SHIFT
    assert float(got[1][:, 0::2][sat].abs().max()) == 0.0
    assert float(got[1].abs().max()) > 0.0


@pytest.mark.parametrize("shape", SHAPES + EXPLICIT_EDGE_SHAPES)
def test_emulated_f32_kernels_match_twin(emulated, shape):
    x, off, m, wt, bias, g = explicit_inputs(0, shape)
    out = dcn_cuda._explicit_forward_launch("dcn_fwd", x, off, m, wt, bias,
                                            PALLAS_MAX_SHIFT, 0)
    assert_close(out, dcn_cuda.dcn_v2_twin(x, off, m, wt, bias), "out")
    assert_not_bf16(out)
    check_explicit_backward("dcn_bwd", x, off, m, wt, g, torch.float32)
    assert dcn_cuda.LAUNCHES["dcn_fwd"] == dcn_cuda.LAUNCHES["dcn_bwd"] == 1


# the fused kernels' tile edges: Cin not a multiple of the 32- and
# 64-channel chunks (nor of 8: padded), H and W not multiples of the 8 x 8
# pixel tile, Cout above one 256-wide channel group; a 1 x 3 x 9 map, under
# one tile; Cin split across data-kernel blocks (6 chunks of 64)
FUSED_EDGE_SHAPES = [
    (1, 24, 264, 3, 9),
    (1, 20, 40, 9, 10),
    (1, 384, 16, 4, 8),
]


def _fused_cases():
    # offsets: the card tests' operands (offsets of std about 2, two rows
    # past the clamp); zero-init: the zero-initialised offset conv; uniform:
    # its weight zeroed, so every pixel has the bias's fractional offsets
    # and neighbouring pixels share corners with nonzero weights
    cases = [pytest.param(shape, mode, id=f"{shape}-{mode}")
             for shape in SHAPES
             for mode in ("offsets", "zero-init", "uniform")]
    return cases + [pytest.param(shape, "offsets", id=f"{shape}-edge")
                    for shape in FUSED_EDGE_SHAPES]


@pytest.mark.parametrize("shape,mode", _fused_cases())
def test_emulated_fused_kernels_match_twin(emulated, shape, mode):
    x, om_w, om_b, wt, bias, g = make_fused_inputs(2, *shape, "cpu")
    if mode != "offsets":
        om_w.zero_()
    if mode == "zero-init":
        om_b.zero_()
    out, stat = dcn_cuda._fused_forward_launch(x, om_w, om_b, wt, bias,
                                               PALLAS_MAX_SHIFT, 0)
    ref, ref_stat = dcn_cuda.dcn_v2_fused_twin(x, om_w, om_b, wt, bias)
    assert out.dtype == torch.bfloat16
    assert_close(out, ref, "out")
    assert float(stat) == pytest.approx(float(ref_stat), rel=1e-5)
    got = dcn_cuda._fused_backward_launch(x, om_w, om_b, wt, g,
                                          PALLAS_MAX_SHIFT, 0)
    want = dcn_cuda.dcn_fused_backward_plain(x, om_w, om_b, wt, g)
    assert got[0].dtype == torch.bfloat16
    for name, a, b in zip(("dx", "d om_w", "d om_b", "dw"), got, want):
        assert_close(a, b, name)
    if mode == "offsets":
        assert float(ref_stat) > PALLAS_MAX_SHIFT
    assert dcn_cuda.LAUNCHES["dcn_fused_fwd"] == 1
    assert dcn_cuda.LAUNCHES["dcn_fused_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 12, 12), (1, 40, 72, 5, 6)]
                         + EXPLICIT_EDGE_SHAPES)
def test_emulated_select_kernels_match_twin(emulated, shape, dtype):
    """Rows 6 and 7: x, out, g, dx and dW in ``dtype``; W < 8 in the second
    shape."""
    x, off, m, wt, bias, g = explicit_inputs(3, shape)
    x, wt, g = x.to(dtype), wt.to(dtype), g.to(dtype)
    out = dcn_cuda._explicit_forward_launch("dcn_sel_fwd", x, off, m, wt,
                                            bias, PALLAS_MAX_SHIFT, 0)
    assert out.dtype == dtype
    assert_close(out, dcn_cuda.dcn_v2_twin(x, off, m, wt, bias), "out")
    check_explicit_backward("dcn_sel_bwd", x, off, m, wt, g, dtype)
    assert dcn_cuda.LAUNCHES["dcn_sel_fwd"] == 1
    assert dcn_cuda.LAUNCHES["dcn_sel_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_wide_kernel_matches_clamp_dx_twin(emulated, dtype):
    """Row 2: dx clamped as dy is; the offsets put dx past the clamp at many
    pixels, where the unclamped twin differs."""
    x, off, m, wt, bias = make_inputs(5, 1, 8, 8, 6, 40, "cpu")
    off[:, 1::2] *= 8.0
    x = x.to(dtype)
    out = dcn_cuda._explicit_forward_launch("dcn_wide_fwd", x, off, m, wt,
                                            bias, PALLAS_MAX_SHIFT, 0)
    assert out.dtype == dtype
    want = dcn_cuda.dcn_v2_twin(x, off, m, wt, bias, clamp_dx=True)
    assert_close(out, want, "out")
    unclamped = dcn_cuda.dcn_v2_twin(x, off, m, wt, bias)
    assert float((want.float() - unclamped.float()).abs().max()) > 0.5
    assert dcn_cuda.LAUNCHES["dcn_wide_fwd"] == 1


# the tensor-core forward's edges (dcn_sample_fwd.cuh) on the emulated card
# of 2 SMs, each with whether Cin is split across blocks: Cin padded and
# under one chunk, Cout not a multiple of 16, ragged tiles (W = 13); Cout
# 264 (two channel groups); one block, its channel group narrowed to 32; a
# map under one tile with W < 8; Cin split in two slices, the last not a
# whole chunk; Cin split and the channel group narrowed
FWD_EDGE_SHAPES = [
    pytest.param((1, 20, 40, 9, 13), False, id="cin20-cout40-w13"),
    pytest.param((1, 24, 264, 3, 9), False, id="cout264"),
    pytest.param((1, 8, 128, 4, 8), False, id="narrowed-group"),
    pytest.param((1, 24, 48, 5, 6), False, id="under-one-tile-w6"),
    pytest.param((1, 200, 24, 4, 13), True, id="cin-split"),
    pytest.param((1, 128, 128, 4, 8), True, id="cin-split-narrowed"),
]
FWD_ROWS = [
    pytest.param("dcn_fwd", torch.float32, id="row1-f32"),
    pytest.param("dcn_sel_fwd", torch.float32, id="row6-f32"),
    pytest.param("dcn_sel_fwd", torch.bfloat16, id="row6-bf16"),
    pytest.param("dcn_wide_fwd", torch.float32, id="row2-f32"),
    pytest.param("dcn_wide_fwd", torch.bfloat16, id="row2-bf16"),
]


@pytest.mark.parametrize("name,dtype", FWD_ROWS)
@pytest.mark.parametrize("shape,split", FWD_EDGE_SHAPES)
def test_emulated_forward_edges_match_twin(emulated, shape, split, name,
                                           dtype):
    """Rows 1, 6 and 2 at the forward's tile edges, out in x's dtype: a
    float32 output not rounded to bf16; row 2 against the clamp-dx twin,
    with dx past the clamp at many pixels."""
    x, off, m, wt, bias = make_inputs(4, *shape, "cpu")
    clamp_dx = name == "dcn_wide_fwd"
    if clamp_dx:
        off[:, 1::2] *= 8.0
    x, wt = x.to(dtype), wt.to(dtype)
    b, cin, h, w = x.shape
    per_block = getattr(dcn_cuda._lib(name), f"{name}_cin_per_block")(
        b, h, w, -(-cin // 8) * 8, shape[2])
    assert (per_block < cin) == split
    out = dcn_cuda._explicit_forward_launch(name, x, off, m, wt, bias,
                                            PALLAS_MAX_SHIFT, 0)
    assert out.dtype == dtype
    assert_close(out, dcn_cuda.dcn_v2_twin(x, off, m, wt, bias,
                                           clamp_dx=clamp_dx), "out")
    if dtype == torch.float32:
        assert_not_bf16(out)
    assert dcn_cuda.LAUNCHES == {k: int(k == name) for k in dcn_cuda.LAUNCHES}


# Bitwise repeatability. The card runs a grid's blocks in no fixed order;
# the emulation runs them one by one in the order DCN_EMU_BLOCK_ORDER names
# (and a block's threads concurrently, in whatever order the host's
# scheduler picks). A kernel whose sums had an order that depends on which
# block runs first (a float added by an atomic) gives other bits in
# another order; these kernels must give the same bits in all of them.
ORDERS = ("forward", "reverse", "7")


def bits(t):
    """``t``'s bit pattern, so that -0.0 and 0.0 differ, as on the card."""
    t = t.detach().contiguous()
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def in_orders(monkeypatch, call):
    """``call()`` (a tuple of tensors) once per launch order; asserts that
    every output has the same bits in each, and returns the first run's."""
    runs = []
    for order in ORDERS:
        monkeypatch.setenv("DCN_EMU_BLOCK_ORDER", order)
        runs.append(call())
    for order, run in zip(ORDERS[1:], runs[1:]):
        for i, (a, b) in enumerate(zip(runs[0], run)):
            assert torch.equal(bits(a), bits(b)), (
                f"output {i} differs between the forward and the {order} "
                f"launch order by up to {float((a.double() - b.double()).abs().max())}")
    return runs[0]


# (row, kernel, x dtype), and for each an unsplit shape and one whose Cin
# splits into four slices on the emulated card of 2 SMs (two slices would
# add alike in either order: a float sum of two terms commutes)
REPEAT_FWD_ROWS = [
    pytest.param(1, "dcn_fwd", torch.float32, id="row1-f32"),
    pytest.param(2, "dcn_wide_fwd", torch.float32, id="row2-f32"),
    pytest.param(2, "dcn_wide_fwd", torch.bfloat16, id="row2-bf16"),
    pytest.param(6, "dcn_sel_fwd", torch.float32, id="row6-f32"),
    pytest.param(6, "dcn_sel_fwd", torch.bfloat16, id="row6-bf16"),
]
REPEAT_FWD_SHAPES = [
    pytest.param((1, 20, 40, 9, 13), False, id="unsplit"),
    pytest.param((1, 256, 40, 4, 6), True, id="cin-split"),
]


@pytest.mark.parametrize("shape,split", REPEAT_FWD_SHAPES)
@pytest.mark.parametrize("row,name,dtype", REPEAT_FWD_ROWS)
def test_emulated_forwards_repeat_bitwise(emulated, monkeypatch, row, name,
                                          dtype, shape, split):
    """Rows 1, 2 and 6: the same bits in three launch orders, split or not,
    and within tolerance of the twin; a split call makes two launches (the
    slices' planes, then their sum in slice order)."""
    x, off, m, wt, bias = make_inputs(11, *shape, "cpu")
    clamp_dx = name == "dcn_wide_fwd"
    if clamp_dx:
        off[:, 1::2] *= 8.0
    x, wt = x.to(dtype), wt.to(dtype)
    b, cin, h, w = x.shape
    per_block = getattr(dcn_cuda._lib(name), f"{name}_cin_per_block")(
        b, h, w, -(-cin // 8) * 8, shape[2])
    assert (per_block < cin) == split
    out, = in_orders(monkeypatch, lambda: (dcn_cuda._explicit_forward_launch(
        name, x, off, m, wt, bias, PALLAS_MAX_SHIFT, 0),))
    assert out.dtype == dtype
    assert_close(out, dcn_cuda.dcn_v2_twin(x, off, m, wt, bias,
                                           clamp_dx=clamp_dx), "out")
    assert dcn_cuda.LAUNCHES[name] == len(ORDERS)


@pytest.mark.parametrize("shape", [
    pytest.param((2, 8, 8, 12, 12), id="one-group"),
    pytest.param((1, 384, 16, 4, 8), id="narrowed-group"),
])
def test_emulated_fused_forward_repeats_bitwise(emulated, monkeypatch, shape):
    """Row 4, which never splits Cin: at a full and at a narrowed channel
    group, the same output and max |dy| in three launch orders (max |dy| is
    folded by an integer atomicMax, which no order changes)."""
    x, om_w, om_b, wt, bias, _ = make_fused_inputs(12, *shape, "cpu")
    out, stat = in_orders(monkeypatch, lambda: dcn_cuda._fused_forward_launch(
        x, om_w, om_b, wt, bias, PALLAS_MAX_SHIFT, 0))
    ref, ref_stat = dcn_cuda.dcn_v2_fused_twin(x, om_w, om_b, wt, bias)
    assert_close(out, ref, "out")
    assert float(stat) == pytest.approx(float(ref_stat), rel=1e-5)


# the backward's splits: none; Cin split across the data kernel's blocks
# (its sampling gradients then summed over the slices' planes); the weight
# kernel's split-K over pixels (REPEAT_DW_BLOCKS blocks wanted: 5 slices of
# 64 pixels here); offsets whose dx reaches tiles two and more away, so a
# source tile's samples land in many destination tiles across the row; and
# a map of six tile rows (the last one partial) with dy up to the clamp, so
# each destination tile takes samples from up to two tile rows above and
# below and the window of source rows is cut at both edges
REPEAT_BWD_SHAPES = [
    pytest.param((2, 8, 8, 12, 12), "unsplit", id="unsplit"),
    pytest.param((1, 384, 16, 4, 8), "cin-split", id="cin-split"),
    pytest.param((2, 16, 16, 12, 12), "split-k", id="split-k"),
    pytest.param((1, 16, 24, 12, 28), "far", id="far-offsets"),
    pytest.param((1, 8, 8, 44, 12), "tall", id="tall-map"),
]
REPEAT_DW_BLOCKS = 64
REPEAT_BWD_ROWS = [
    pytest.param(3, "dcn_bwd", torch.float32, id="row3-f32"),
    pytest.param(7, "dcn_sel_bwd", torch.float32, id="row7-f32"),
    pytest.param(7, "dcn_sel_bwd", torch.bfloat16, id="row7-bf16"),
    pytest.param(5, "dcn_fused_bwd", torch.bfloat16, id="row5-bf16"),
]


def bwd_splits(name, shape):
    """(the data kernel splits Cin, slices of the weight kernel's split-K)
    for ``shape`` as the wrapper sizes them."""
    b, cin, cout, h, w = shape[:5]
    cp = -(-cin // 8) * 8
    per_block = getattr(dcn_cuda._lib(name), f"{name}_data_cin_per_block")(
        b, h, w, cp)
    ppb = dcn_cuda._dw_pixels_per_block(b * h * w, cp, cout)
    return per_block < cp, -(-(b * h * w) // ppb)


@pytest.mark.parametrize("shape,kind", REPEAT_BWD_SHAPES)
@pytest.mark.parametrize("row,name,dtype", REPEAT_BWD_ROWS)
def test_emulated_backwards_repeat_bitwise(emulated, monkeypatch, row, name,
                                           dtype, shape, kind):
    """Rows 3, 7 and 5: every gradient has the same bits in three launch
    orders, and lies within tolerance of autograd through the twin; the
    shape's splits are the ones its id names."""
    if kind == "split-k":
        monkeypatch.setattr(dcn_cuda, "_DW_TARGET_BLOCKS", REPEAT_DW_BLOCKS)
    cin_split, k_slices = bwd_splits(name, shape)
    assert cin_split == (kind == "cin-split")
    assert (k_slices > 1) == (kind == "split-k")
    if name == "dcn_fused_bwd":
        x, om_w, om_b, wt, _, g = make_fused_inputs(13, *shape, "cpu")
        if kind == "far":
            om_w[1::2] *= 4.0
        if kind == "tall":
            om_w[0:18:2] *= 6.0
        got = in_orders(monkeypatch, lambda: dcn_cuda._fused_backward_launch(
            x, om_w, om_b, wt, g, PALLAS_MAX_SHIFT, 0))
        want = dcn_cuda.dcn_fused_backward_plain(x, om_w, om_b, wt, g)
        names = ("dx", "d om_w", "d om_b", "dw")
    else:
        x, off, m, wt, _, g = explicit_inputs(13, shape)
        if kind == "far":
            off[:, 1::2] *= 8.0
        if kind == "tall":
            off[:, 0::2] *= 6.0
        x, wt, g = x.to(dtype), wt.to(dtype), g.to(dtype)
        got = in_orders(monkeypatch,
                        lambda: dcn_cuda._explicit_backward_launch(
                            name, x, off, m, wt, g, PALLAS_MAX_SHIFT, 0))
        want = dcn_cuda.dcn_backward_plain(x, off, m, wt, g)
        names = ("dx", "doff", "dmask", "dw")
    assert got[0].dtype == dtype
    for grad, a, b in zip(names, got, want):
        assert_close(a, b, grad)
    assert dcn_cuda.LAUNCHES[name] == len(ORDERS)


# --- train-mode BatchNorm (csrc/bn_train.cu) -----------------------------------


@pytest.fixture
def emulated_bn(emulated_libs, monkeypatch):
    """BatchNorm's library replaced by the CPU build, for one test; a
    reduce grid of a few blocks, so that tiny maps split each channel into
    several slices, the last one ragged."""
    monkeypatch.setattr(batchnorm, "_LIBS", {})
    monkeypatch.setattr(batchnorm, "_lib_path",
                        lambda: emulated_libs[batchnorm.NAME])
    monkeypatch.setattr(batchnorm, "_REDUCE_TARGET_BLOCKS", 12)
    monkeypatch.setattr(batchnorm, "_MIN_SLICE", 2)
    batchnorm.reset_launches()
    yield
    batchnorm.reset_launches()


def bn_inputs(seed, shape):
    """x (N, C, H, W) with channel means away from 0, its batch mean and
    invstd at eps 1e-3, a weight and an output gradient."""
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(shape, generator=gen) * 2.0 + torch.randn(
        1, c, 1, 1, generator=gen) * 3.0
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    invstd = 1.0 / torch.sqrt(var + 1e-3)
    weight = torch.randn(c, generator=gen)
    dy = torch.randn(shape, generator=gen)
    return x, mean, invstd, weight, dy


def assert_bn_close(got, want, name):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale,
                               msg=name)


# (N, C, H, W): H * W a multiple of 4 (16-byte vectors); H * W odd (one
# float a vector); a plane shorter than a slice (slices cross samples)
BN_SHAPES = [
    pytest.param((2, 3, 6, 10), 4, id="vec4"),
    pytest.param((3, 2, 5, 7), 1, id="vec1-ragged"),
    pytest.param((7, 4, 2, 2), 4, id="small-planes"),
]


@pytest.mark.parametrize("shape,vector", BN_SHAPES)
def test_emulated_batchnorm_kernels_match_twin_in_every_order(
        emulated_bn, monkeypatch, shape, vector):
    """dx, d(weight) and d(bias) within 1e-4 of the twin, the same bits in
    three launch orders; each channel in several slices, the last one
    shorter; one launch of each kernel a call, and none of dx where x
    takes no gradient."""
    x, mean, invstd, weight, dy = bn_inputs(21, shape)
    assert batchnorm._vector(x, dy) == vector
    slices, slice_ = batchnorm.reduce_split(
        shape[0], shape[1], shape[2] * shape[3] // vector)
    count = shape[0] * shape[2] * shape[3] // vector
    assert slices >= 3 and slices * slice_ > count
    got = in_orders(monkeypatch, lambda: batchnorm._backward_launch(
        x, dy, mean, invstd, weight, True, 0))
    want = batchnorm.backward_plain(x, dy, mean, invstd, weight)
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        assert_bn_close(a, b, name)
    assert batchnorm.LAUNCHES == dict.fromkeys(batchnorm.LAUNCHES,
                                               len(ORDERS))
    dx, dweight, _ = batchnorm._backward_launch(x, dy, mean, invstd, weight,
                                                False, 0)
    assert dx is None and torch.equal(bits(dweight), bits(got[1]))
    assert batchnorm.LAUNCHES["bn_train_dx_kernel"] == len(ORDERS)


# --- depthwise conv backward (csrc/depthwise_bwd.cu) --------------------------


@pytest.fixture
def emulated_dw(emulated_libs, monkeypatch):
    """The depthwise library replaced by the CPU build, for one test; a
    grid of a few blocks, so that tiny maps split into tiles of two cell
    rows, the last one shorter where the rows do not divide."""
    monkeypatch.setattr(depthwise, "_LIBS", {})
    monkeypatch.setattr(depthwise, "_lib_path",
                        lambda: emulated_libs[depthwise.NAME])
    monkeypatch.setattr(depthwise, "_TARGET_BLOCKS", 6)
    monkeypatch.setattr(depthwise, "_MIN_ROWS", 2)
    depthwise.reset_launches()
    yield
    depthwise.reset_launches()


def dw_inputs(seed, n, c, h, w, k, stride, padding):
    """x (N, C, H, W), a (C, 1, k, k) weight and the output's gradient."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen)
    weight = torch.randn(c, 1, k, k, generator=gen)
    ho = (h + 2 * padding[0] - k) // stride + 1
    wo = (w + 2 * padding[1] - k) // stride + 1
    return x, weight, torch.randn(n, c, ho, wo, generator=gen)


# (N, C, H, W, k, stride, (ph, pw)), tpp: threads a plane. 8 threads a
# plane and 32 planes a block, so one block holds both images' planes;
# SAME's uneven pad as the conv sees it (padded map, padding 0), odd and
# even; MobileNetV2's stride 2 with padding 1 on an odd map; 5x5 stride 1;
# a plane of two and of eight warps (the warps' sums in order); uneven
# padding with stride 2
DW_SHAPES = [
    pytest.param((2, 3, 9, 8, 3, 1, (1, 1)), 8,
                 id="k3s1-planes-across-images"),
    pytest.param((3, 5, 10, 11, 5, 2, (0, 0)), 8, id="k5s2-same-padded"),
    pytest.param((2, 3, 9, 9, 3, 2, (0, 0)), 8, id="k3s2-same-padded-odd"),
    pytest.param((1, 4, 7, 7, 3, 2, (1, 1)), 8, id="k3s2-pad1-odd"),
    pytest.param((2, 2, 12, 12, 5, 1, (2, 2)), 16, id="k5s1-pad2"),
    pytest.param((1, 2, 5, 40, 3, 1, (1, 1)), 64, id="k3s1-two-warps"),
    pytest.param((1, 2, 3, 200, 5, 2, (2, 1)), 128, id="k5s2-four-warps"),
    pytest.param((1, 2, 4, 300, 3, 1, (0, 1)), 256, id="k3s1-eight-warps"),
]


@pytest.mark.parametrize("shape,tpp", DW_SHAPES)
def test_emulated_depthwise_kernels_match_twin_in_every_order(
        emulated_dw, monkeypatch, shape, tpp):
    """dx and d(weight) within 1e-4 of the twin, the same bits in three
    launch orders; several row tiles; one launch of each kernel a call."""
    n, c, h, w, k, stride, padding = shape
    x, weight, g = dw_inputs(23, *shape)
    tpp_log2, rows, tiles = depthwise.plan(n, c, h, w, k, stride, *padding)
    assert 1 << tpp_log2 == tpp and (tiles > 1 or tpp == 128)
    got = in_orders(monkeypatch, lambda: depthwise._backward_launch(
        x, g, weight, stride, padding, 0))
    want = depthwise.backward_plain(x, g, weight, stride, padding)
    for name, a, b in zip(("dx", "dweight"), got, want):
        assert_bn_close(a, b, name)
    assert depthwise.LAUNCHES == dict.fromkeys(depthwise.LAUNCHES,
                                               len(ORDERS))
