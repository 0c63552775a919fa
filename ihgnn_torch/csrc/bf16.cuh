// bf16 helpers shared by the kernels' bf16 forms (ModelConfig.bf16_stream):
// csrc/gather.cu, csrc/segsum.cu, csrc/interact.cu, csrc/interact_bwd.cu.
//
// Every rounding to bf16 here is round to nearest even, as PyTorch's
// float -> bfloat16 conversion (and so the plain twins) rounds. A bf16 value
// widens to f32 exactly, and the product of two bf16 values is exact in
// f32, so a bf16 x bf16 product on the tensor cores with f32 accumulators
// needs no split (mma.sync.m16n8k16 .bf16, one pass).
//
// Fragments of mma.m16n8k16 (bf16), for lane = 4 g + t; each 32-bit
// register holds two bf16 values, the first in its low half:
//   A [16, 16]: a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//               a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B [16, 8]:  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C [16, 8]:  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// As with TF32 (tf32.cuh), k is a sum index: a kernel may map the 16 depth
// positions to its own, as long as A and B use the same map.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Two floats rounded to bf16, a in the low half.
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two bf16 values in one register, a in the low half.
__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf16x2(unsigned v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Four bf16 values (8 bytes) widened to f32.
__device__ __forceinline__ float4 widen_bf16x4(uint2 v) {
  const float2 lo = __bfloat1622float2(bits_bf16x2(v.x));
  const float2 hi = __bfloat1622float2(bits_bf16x2(v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four floats rounded to bf16 (8 bytes).
__device__ __forceinline__ uint2 round_bf16x4(float4 v) {
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Shared-memory address of p, for ldmatrix.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix: 8x8 matrices of 16-bit values from shared memory, one 16-byte
// row an address (lane l gives row l % 8 of matrix l / 8; .x2 reads lanes
// 0-15). Register r holds matrix r: lane 4 g + t gets row g, columns 2t,
// 2t + 1 (the low half first), or with .trans row 2t, 2t + 1 of column g,
// which is the A and B fragment layout above read from rows whose index
// is k (.trans) or m / n (plain).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(shared_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(shared_addr(p)));
}

// c += a b for one m16n8k16 tile: a [16, 16] row-major, b [16, 8]
// column-major, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
