// Hopper (sm_90a) primitives of the fused DCN kernels, each one inline PTX
// instruction behind a small function:
//   ldmatrix_x4 / ldmatrix_x4_trans  four 8x8 b16 tiles from shared memory
//                                    into the fragment layout of mma.sync;
//   mma_bf16_16816                   D += A . B, m16n8k16, bf16 operands,
//                                    f32 accumulators (tensor cores);
//   cp_async16, cp_async_commit, cp_async_wait<N>
//                                    16-byte global -> shared copies that
//                                    bypass the registers (zero-filled when
//                                    the predicate is false);
//   red_add_v4                       one vector f32 reduction to global
//                                    memory (red.global.add.v4.f32, sm_90),
//                                    16 bytes per instruction.
// Fragment layouts follow the PTX ISA (lane l, g = l / 4, q = l % 4):
//   ldmatrix: lane l gives the address of row l % 8 of tile l / 8; register
//     j receives row g, columns 2q and 2q + 1 of tile j (of the transposed
//     tile with .trans);
//   mma A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g + 8, 2q..),
//     a2 = (g, 2q + 8..), a3 = (g + 8, 2q + 8..);
//   mma B (16 x 8, column-major): b0 = (2q..2q+1, g), b1 = (2q + 8.., g);
//   mma C/D (16 x 8): d0, d1 = (g, 2q..2q+1), d2, d3 = (g + 8, 2q..).
// The lower-indexed element of a pair sits in the low 16 bits.
//
// All PTX of the fused kernels is in this file. A CPU build that defines
// DCN_CPU_EMULATION provides the same functions (and DCN_DYNAMIC_SMEM)
// itself, lane by lane.
#pragma once

#include <stdint.h>

#include "dcn_common.cuh"

#ifndef DCN_CPU_EMULATION

// the block's dynamic shared memory, as a byte array named `name`
#define DCN_DYNAMIC_SMEM(name) \
  extern __shared__ __align__(128) unsigned char name[]

namespace dcn {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// src must be a valid address even when `pred` is false (nothing is read;
// the 16 bytes at dst are zeroed)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// p 16-byte aligned, in global memory
__device__ __forceinline__ void red_add_v4(float* p, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :
               : "l"(p), "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

}  // namespace dcn

#endif  // DCN_CPU_EMULATION

namespace dcn {

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// the 8 bf16 values of a 16-byte vector, as floats
__device__ __forceinline__ void unpack_bf16x8(const uint4& q, float (&v)[8]) {
  v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x);
  v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z);
  v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  uint4 q;
  q.x = pack_bf16x2(v[0], v[1]);
  q.y = pack_bf16x2(v[2], v[3]);
  q.z = pack_bf16x2(v[4], v[5]);
  q.w = pack_bf16x2(v[6], v[7]);
  return q;
}

}  // namespace dcn
