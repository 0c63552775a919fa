// Tensor-core and cp.async helpers shared by the interaction kernels
// (csrc/interact.cu, csrc/interact_bwd.cu).
//
// A product in 3xTF32 keeps f32 accuracy on the TF32 tensor cores: each
// f32 operand x is split into x = hi + lo (split_tf32), and a b is
// a_hi b_lo + a_lo b_hi + a_hi b_hi, three TF32 products summed in f32
// (a_lo b_lo is below f32 rounding). mma.sync.m16n8k8 runs one TF32
// product of a [16, 8] by an [8, 8] tile.
//
// Fragments of mma.m16n8k8 (tf32), for lane = 4 g + t:
//   A [16, 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B [8, 8]:  b0 (t, g), b1 (t + 4, g)
//   C [16, 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The k index of a product is a sum index: a kernel may map k = t and
// k = t + 4 to any two of its 8 depth positions, as long as A and B use
// the same map.

#pragma once

#include <cuda_runtime.h>

namespace {

// Asynchronous 16-byte copy from device to shared memory; when !valid it
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(bytes));
}

// 4 bytes from src (global) to dst (shared), through L1.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo, each a TF32 operand: hi is x rounded to 11 significant bits
// (Veltkamp's split, c = 8193 x, hi = c - (c - x): three f32 operations on
// the full-rate FP32 pipe, where the integer rounding of the bits would
// take the half-rate integer pipe), lo = x - hi exactly. The tensor cores
// read the 11 leading significant bits of lo (they ignore an operand's low
// 13 bits), so the pair keeps x to about 2^-23 |x|. The _rn intrinsics
// keep the compiler from fusing the steps into FMAs, which would break the
// split.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// c += a b for one m16n8k8 tile: a [16, 8] row-major, b [8, 8] column-major
// (not volatile: independent products may be reordered around it)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 over N accumulators that share a: c[n] += a_hi b_lo[n] + a_lo
// b_hi[n] + a_hi b_hi[n], the small terms first. Each term is issued for
// all N before the next, so neighbouring products are independent and
// do not wait on each other's accumulator.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[N][2],
                                           const unsigned (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
}

}  // namespace
