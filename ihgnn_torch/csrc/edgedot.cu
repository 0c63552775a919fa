// csr_edge_dot: the dot product of two gathered rows per CSR entry.
//
//   out[k] = < a[s, :], b[col[k], :] >   for k in [rowptr[s], rowptr[s+1])
//
// Not a port of one TPU kernel. On the TPU the per-entry dots of the GAT
// attention (ihgnn_tpu/ops/gatconv.py:256-263 and :299-300) are two row
// expansions -- windowed_gather (K2, ops/pallas/gather.py:188) with the
// Clos stages of ops/pallas/permute.py (K6/K7) -- into [d, K] streams, then
// an XLA multiply and a reduction over d. Here both row gathers are folded
// into the dot, as K1 folds its gather, so no [K, d] stream is written. It
// serves the attention backward's tt = alpha * <x[src], cot[dst]>, the
// product head's scores <x[src] (.) w, x[dst]>, and that head's backward.
//
// Bound on the H100: memory. Per entry the kernel reads one int32 column id,
// one d-float row of b and writes one float; the a row of the segment is
// reused by every entry of the segment (L1). One warp owns one segment; a
// group of G lanes (G = the power of two >= d/4, at most 32) owns one entry
// and reads its b row as 16-byte vectors, so at d = 32 the 8 lanes of a
// group read one 128-byte line and a warp 4 entries at once. The group's
// partial dots meet in a fixed butterfly of shuffles: results repeat bit for
// bit; no atomics.
//
// Layout: a [S, d] f32, b [M, d] f32, both row-major and 16-byte aligned
// with d a multiple of 4; col [K] int32, rowptr [S+1] int32, out [K] f32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int G>
__global__ void csr_edge_dot_kernel(const float4* __restrict__ a,
                                    const float4* __restrict__ b,
                                    const int* __restrict__ col,
                                    const int* __restrict__ rowptr,
                                    float* __restrict__ out,
                                    int num_segments, int d4) {
  constexpr int kPerPass = 32 / G;  // entries a warp reads at once
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= num_segments) return;  // uniform across the warp
  const int sub = lane % G;
  const int slot = lane / G;
  const int begin = rowptr[seg];
  const int end = rowptr[seg + 1];
  const float4* arow = a + static_cast<size_t>(seg) * d4;
  // the loop bounds depend on the segment only, so every lane runs every
  // pass and the shuffles below see the whole warp
  for (int base = begin; base < end; base += kPerPass) {
    const int k = base + slot;
    float acc = 0.f;
    if (k < end) {
      const float4* brow = b + static_cast<size_t>(__ldg(col + k)) * d4;
      for (int c = sub; c < d4; c += G) {
        const float4 x = arow[c];
        const float4 y = __ldg(brow + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (k < end && sub == 0) out[k] = acc;
  }
}

template <int G>
int launch(const void* a, const void* b, const void* col, const void* rowptr,
           void* out, int num_segments, int d4, cudaStream_t stream) {
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_edge_dot_kernel<G><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<const int*>(col), static_cast<const int*>(rowptr),
      static_cast<float*>(out), num_segments, d4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_csr_edge_dot(const void* a, const void* b,
                                  const void* col, const void* rowptr,
                                  void* out, int num_segments, int d,
                                  void* stream) {
  if (d <= 0 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d4 = d / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d4 <= 1) return launch<1>(a, b, col, rowptr, out, num_segments, d4, s);
  if (d4 <= 2) return launch<2>(a, b, col, rowptr, out, num_segments, d4, s);
  if (d4 <= 4) return launch<4>(a, b, col, rowptr, out, num_segments, d4, s);
  if (d4 <= 8) return launch<8>(a, b, col, rowptr, out, num_segments, d4, s);
  if (d4 <= 16)
    return launch<16>(a, b, col, rowptr, out, num_segments, d4, s);
  return launch<32>(a, b, col, rowptr, out, num_segments, d4, s);
}
