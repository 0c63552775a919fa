// K4 csr_segment_max and the scalar csr_segment_sum: per-segment reductions
// of a scalar f32 stream over a CSR.
//
//   max: out[s] = max(-3e38, max_{k in [rowptr[s], rowptr[s+1])} v[k])
//   sum: out[s] = sum_{k in [rowptr[s], rowptr[s+1])} v[k]
//
// The max replaces ihgnn_tpu/ops/pallas/segsum.py csr_segment_max_t
// (segsum.py:848, kernel _segmax_kernel :794): the destination-softmax
// stabiliser of GAT attention. As there, an empty segment reads -3e38, and a
// NaN wins (jnp.maximum). The TPU kernel walks node tiles in order and
// reduces with one-hot compares on sublanes; here one warp owns one
// segment. The sum is K1's csr_segment_sum_t (segsum.py:458) on a scalar
// stream: the softmax denominators and the backward's per-node scalar sums.
// K1's row kernel would keep 31 of 32 lanes idle at d = 1.
//
// Bound on the H100: memory. Each entry is read once (4 bytes), each
// segment writes 4 bytes; one compare or add an entry. Lanes stride the
// segment's entries, so a warp reads them as coalesced 128-byte lines, and
// a segment of any length (GAT in-degrees 10-40, phase-2 destinations with
// hundreds) costs one pass. The lanes' partials meet in a butterfly of
// shuffles in a fixed order, so results repeat bit for bit; no atomics.
//
// Layout: v [K] f32, rowptr [S+1] int32, out [S] f32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kEmpty = -3.0e38f;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <bool kMax>
__global__ void csr_segment_reduce_kernel(const float* __restrict__ v,
                                          const int* __restrict__ rowptr,
                                          float* __restrict__ out,
                                          int num_segments) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= num_segments) return;  // uniform across the warp
  const int begin = rowptr[seg];
  const int end = rowptr[seg + 1];
  float acc = kMax ? kEmpty : 0.f;
  for (int k = begin + lane; k < end; k += 32) {
    const float x = __ldg(v + k);
    acc = kMax ? max_nan(acc, x) : acc + x;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, acc, off);
    acc = kMax ? max_nan(acc, o) : acc + o;
  }
  if (lane == 0) out[seg] = acc;
}

template <bool kMax>
int launch(const void* v, const void* rowptr, void* out, int num_segments,
           void* stream) {
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_segment_reduce_kernel<kMax><<<blocks, kWarpsPerBlock * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(rowptr),
      static_cast<float*>(out), num_segments);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_csr_segment_max(const void* v, const void* rowptr,
                                     void* out, int num_segments,
                                     void* stream) {
  return launch<true>(v, rowptr, out, num_segments, stream);
}

extern "C" int ihgnn_csr_segment_sum(const void* v, const void* rowptr,
                                     void* out, int num_segments,
                                     void* stream) {
  return launch<false>(v, rowptr, out, num_segments, stream);
}
