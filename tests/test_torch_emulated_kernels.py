"""The CUDA kernel sources, compiled for the CPU, against their plain twins.

The kernels in ``centernet_uda_torch/csrc/`` run only on an H100, and the
card-only tests (``tests/test_torch_gpu.py``) skip without one. This file
compiles the same seven sources with the host C++ compiler against
``EMULATION_HEADER`` below (a CPU emulation of the CUDA subset they use: a
block's threads as a pool of OS threads, ``__syncthreads`` as a barrier,
the warp-wide ``mma.sync`` primitives lane by lane; the ``<<<...>>>``
launches of the sources and of their headers rewritten as calls),
loads them in place of the ``nvcc`` builds, and runs them through the
wrappers' launch helpers on CPU tensors at tiny shapes. That holds the
kernels' indexing, tiling, masking and arithmetic against the twins on every
CPU run; the card runs show that ``nvcc`` builds them and what they cost.

Tolerance: that of the card tests, atol 5e-2 * max(1, max|twin|) and rtol
5e-2, and max |dy| to 1e-5 relative; the operands are the card tests' own
(the fused ones quantised so that the offset conv is exact in any summation
order). It skips without a C++20 compiler.
"""

import re
import shutil
import subprocess

import pytest
import torch

from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT
from test_torch_gpu import make_fused_inputs, make_inputs

torch.set_num_threads(2)

LAUNCH = re.compile(r"([A-Za-z_]\w*)<<<(.*?)>>>\(", re.S)

# written into the build directory as cuda_emulation.h
EMULATION_HEADER = r"""// CPU emulation of the CUDA subset that centernet_uda_torch/csrc uses.
//
// A launch runs one block at a time on a pool of blockDim threads;
// __syncthreads is a barrier of that pool, __shared__ variables are statics
// (one instance per kernel, reused block after block, which is safe because
// every kernel writes its shared memory before it reads it), dynamic shared
// memory is one buffer of the launch's size, and atomics are
// std::atomic_ref. The warp-wide operations go through a buffer between
// two barriers of the warp's 32 threads (every lane must reach them, as on
// the card): a shuffle, and the dcn_mma.cuh primitives with the per-lane
// fragment layouts of the PTX ISA (ldmatrix x4 and its .trans form, mma
// m16n8k16 with bf16 operands and f32 accumulation). cp.async is a plain
// copy (its waits no-ops) and the vector reduction four atomic adds.
// bf16 conversions round to nearest even, as __float2bfloat16 does. Device
// limits and errors are stubs: every launch "succeeds", on a card of 2 SMs.
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <math.h>
#include <thread>
#include <vector>

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

inline float atomicAdd(float* p, float v) {
  return std::atomic_ref<float>(*p).fetch_add(v);
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

inline void red_add_v4(float* p, float a, float b, float c, float d) {
  std::atomic_ref<float>(p[0]).fetch_add(a);
  std::atomic_ref<float>(p[1]).fetch_add(b);
  std::atomic_ref<float>(p[2]).fetch_add(c);
  std::atomic_ref<float>(p[3]).fetch_add(d);
}
}  // namespace dcn

namespace emu {
// kernel<<<grid, block, smem, stream>>>(args...), rewritten by the test as
// emu::launch(kernel, grid, block, smem, stream, args...)
template <class... P, class... A>
void launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
            cudaStream_t, A... args) {
  const unsigned n = block.x * block.y * block.z;  // a multiple of 32
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
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = {x, y, z};
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
    for name, src in dcn_cuda.SOURCES.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(emulated(dcn_cuda.CSRC / src))
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
