// K1 csr_gather_sum: CSR weighted row gather-sum, f32 accumulation.
//
//   out[s, :] = sum_{k in [rowptr[s], rowptr[s+1])} w[k] * x[col[k], :]
//
// Replaces ihgnn_tpu/ops/pallas/segsum.py csr_segment_sum3_t (segsum.py:403),
// csr_segment_sum_t (:458) and csr_segment_sum3_multi (:686): the sorted
// CSR segment-sum behind the node update H.E and the word-bag mean. The TPU
// kernel reads a pre-expanded [d, K] entry stream and reduces it on the MXU
// with one-hot tiles; here each entry's row is gathered inside the sum.
//
// Bound on the H100: memory. Per entry the kernel reads one int32 id (and
// one f32 weight) and one d-float row of x; it does d FMAs per row, far
// below the card's 67 TFLOP/s f32 rate. At d = 32 a row is one 128-byte
// line, so one warp per segment with one lane per feature makes each row
// read one coalesced transaction. Lanes load 32 (col, w) pairs at once and
// broadcast them with shuffles. The sum runs in entry order, so results
// are deterministic and need no atomics.
//
// Layout: x [M, d] f32 row-major, col [K] int32, rowptr [S+1] int32,
// w [K] f32 or null, out [S, d] f32.
//
// csr_segment_sum3 is the three-region form of csr_segment_sum3_t itself
// (segsum.py:403): the node update of the routed path sums the [u | q | i]
// regions of its sigma-ordered edge stream, each [e_pad, d], read through
// three base pointers (region = column / e_pad), so the [3 e_pad, d]
// concatenation is never written. Its CSR lists each node's stream
// positions in stream order; sigma pads have no entry.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// THREE: the entry rows come from three [region_rows, d] regions read
// through their own base pointers, column c naming row c % region_rows of
// region c / region_rows (x0, x1, x2), with no concatenated copy.
template <bool THREE>
__global__ void csr_gather_sum_kernel(const float* __restrict__ x0,
                                      const float* __restrict__ x1,
                                      const float* __restrict__ x2,
                                      int region_rows,
                                      const int* __restrict__ col,
                                      const int* __restrict__ rowptr,
                                      const float* __restrict__ weight,
                                      float* __restrict__ out,
                                      int num_segments, int d) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= num_segments) return;  // uniform across the warp
  const int begin = rowptr[seg];
  const int end = rowptr[seg + 1];
  for (int f0 = 0; f0 < d; f0 += 32) {
    const int f = f0 + lane;
    float acc = 0.f;
    for (int base = begin; base < end; base += 32) {
      const int k = base + lane;
      int c = 0;
      float w = 1.f;
      if (k < end) {
        c = col[k];
        if (weight != nullptr) w = weight[k];
      }
      const int n = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(0xffffffffu, c, j);
        const float wj = __shfl_sync(0xffffffffu, w, j);
        const float* row;
        if (THREE) {
          const int region = cj / region_rows;
          const float* xr = region == 0 ? x0 : (region == 1 ? x1 : x2);
          row = xr + static_cast<size_t>(cj - region * region_rows) * d;
        } else {
          row = x0 + static_cast<size_t>(cj) * d;
        }
        if (f < d) acc = fmaf(wj, row[f], acc);
      }
    }
    if (f < d) out[static_cast<size_t>(seg) * d + f] = acc;
  }
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_csr_gather_sum(const void* x, const void* col,
                                    const void* rowptr, const void* weight,
                                    void* out, int num_segments, int d,
                                    void* stream) {
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_gather_sum_kernel<false><<<blocks, kWarpsPerBlock * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), nullptr, nullptr, 0,
      static_cast<const int*>(col), static_cast<const int*>(rowptr),
      static_cast<const float*>(weight), static_cast<float*>(out),
      num_segments, d);
  return static_cast<int>(cudaGetLastError());
}

// The three-region form: col in [0, 3 * region_rows), no weight.
extern "C" int ihgnn_csr_segment_sum3(const void* x0, const void* x1,
                                      const void* x2, int region_rows,
                                      const void* col, const void* rowptr,
                                      void* out, int num_segments, int d,
                                      void* stream) {
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_gather_sum_kernel<true><<<blocks, kWarpsPerBlock * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(x1),
      static_cast<const float*>(x2), region_rows,
      static_cast<const int*>(col), static_cast<const int*>(rowptr), nullptr,
      static_cast<float*>(out), num_segments, d);
  return static_cast<int>(cudaGetLastError());
}
