// K4 csr_segment_max and the scalar csr_segment_sum: per-segment reductions
// of a scalar f32 stream over a CSR.
//
//   max: out[s] = max(-3e38, max_{k in [rowptr[s], rowptr[s+1])} v[k])
//   sum: out[s] = sum_{k in [rowptr[s], rowptr[s+1])} v[k]
//
// The max replaces ihgnn_tpu/ops/pallas/segsum.py csr_segment_max_t
// (segsum.py:848, kernel _segmax_kernel :794): the destination-softmax
// stabiliser of GAT attention. As there, an empty segment reads -3e38, and a
// NaN wins (jnp.maximum). The sum is K1's csr_segment_sum_t (segsum.py:458)
// on a scalar stream: the softmax denominators and the backward's per-node
// scalar sums. The TPU kernels walk node tiles in order and reduce with
// one-hot compares on sublanes.
//
// Bound on the H100: memory. Each entry is read once (4 bytes), each
// segment reads its row pointer and writes 4 bytes; one compare or add an
// entry. On the GAT graph (12M entries, 700k segments of 5-60) that is 16
// us, so what costs is latency: a warp a segment, as the first version
// ran, spends two dependent loads and five shuffles on 17 entries.
//
// Design: a block of kThreads owns kSegs consecutive segments, one a
// thread. It loads their row pointers once (one load a thread), then
// streams their entries, which are contiguous, through shared memory in
// windows of kTile entries with 16-byte loads, all of a window in flight
// at once; each thread then reduces its own segment from the window in
// entry order, carrying its value across windows. A window starts at the
// first entry that a short segment still needs (a block-wide min), so the
// entries of long segments are not staged. A segment longer than kLong
// (found by warp ballots) is reduced afterwards by the whole block, one
// long segment after another: thread t takes entries t, t + kThreads, ...
// (16-byte vectors in the aligned body), the warps combine by xor shuffles
// and thread 0 combines the warps in order. 256 threads and 4096-entry
// windows timed best of the four shapes tried on the H100 (PERF.md).
//
// Order, so results repeat bit for bit (no atomics): a segment of at most
// kLong entries is reduced from the identity in entry order, so its sum is
// the sequential f32 sum; a longer one in the block order above, which
// ihgnn_torch/ops/segmax.py documents (LONG_SEGMENT, BLOCK_THREADS) and
// tests/test_torch_tf32_split.py emulates. A max is the same in any order.
//
// Layout: v [K] f32, rowptr [S+1] int32, out [S] f32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;          // a block
constexpr int kWarps = kThreads / 32;
constexpr int kSegs = kThreads;        // segments a block owns, one a thread
constexpr int kTile = 4096;            // entries a window stages (16 KB)
constexpr int kLong = 256;             // longer segments take the block path
constexpr int kNone = 0x7fffffff;      // no entry left
constexpr float kEmpty = -3.0e38f;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? max_nan(a, b) : a + b;
}

template <bool kMax>
__global__ void __launch_bounds__(kThreads)
csr_segment_reduce_kernel(const float* __restrict__ v,
                          const int* __restrict__ rowptr,
                          float* __restrict__ out, int num_segments) {
  __shared__ float4 tile4[kTile / 4];
  __shared__ int rp[kSegs + 1];
  __shared__ int wmin[kWarps];
  __shared__ float wred[kWarps];
  __shared__ unsigned long_mask[kWarps];
  float* tile = reinterpret_cast<float*>(tile4);
  const float init = kMax ? kEmpty : 0.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(v) & 15) == 0;

  const int s0 = blockIdx.x * kSegs;
  const int n_seg = min(kSegs, num_segments - s0);
  // each thread loads one row pointer, the last thread two
  if (threadIdx.x <= n_seg) rp[threadIdx.x] = rowptr[s0 + threadIdx.x];
  if (threadIdx.x == kThreads - 1 && n_seg == kSegs)
    rp[kSegs] = rowptr[s0 + kSegs];
  __syncthreads();
  const int hi = rp[n_seg];
  const bool mine = threadIdx.x < n_seg;
  const int b = mine ? rp[threadIdx.x] : hi;
  const int e = mine ? rp[threadIdx.x + 1] : hi;
  const bool short_seg = mine && e - b <= kLong;
  // the long segments of each warp, read after the barrier of next_window
  const unsigned longs = __ballot_sync(0xffffffffu, mine && !short_seg);
  if (lane == 0) long_mask[warp] = longs;

  // block-wide: the first entry at or past `from` that a short segment
  // still needs, kNone if none. Ends in a barrier, so the window before it
  // has been read by every thread.
  auto next_window = [&](int from) -> int {
    int c = short_seg && e > from ? max(b, from) : kNone;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c = min(c, __shfl_xor_sync(0xffffffffu, c, off));
    if (lane == 0) wmin[warp] = c;
    __syncthreads();
    int m = wmin[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) m = min(m, wmin[k]);
    return m;
  };

  // 1. short segments, window by window: [w0, end) staged from the
  // 16-byte boundary at or below w0
  float acc = init;
  for (int w0 = next_window(rp[0]); w0 < hi;) {
    const int base = w0 & ~3;
    const int end = min(base + kTile, hi);
    const int nvec = vec ? (end - base) >> 2 : 0;
    const float4* src = reinterpret_cast<const float4*>(v + base);
#pragma unroll
    for (int r = 0; r < kTile / 4 / kThreads; ++r) {
      const int k = threadIdx.x + r * kThreads;
      if (k < nvec) tile4[k] = __ldg(src + k);
    }
    for (int k = base + 4 * nvec + threadIdx.x; k < end; k += kThreads)
      tile[k - base] = __ldg(v + k);
    __syncthreads();
    if (short_seg) {
      const int k_end = min(e, end);
      for (int k = max(b, w0); k < k_end; ++k)
        acc = combine<kMax>(acc, tile[k - base]);
    }
    w0 = next_window(end);
  }
  if (short_seg) out[s0 + threadIdx.x] = acc;

  // 2. long segments, each by the whole block: a head up to the first
  // 16-byte boundary, the aligned body as vectors, the ragged tail
  for (int lw = 0; lw < kWarps; ++lw) {
    for (unsigned m = long_mask[lw]; m; m &= m - 1) {
      const int j = 32 * lw + __ffs(m) - 1;
      const int lb = rp[j];
      const int le = rp[j + 1];
      const int ab = vec ? min((lb + 3) & ~3, le) : le;
      const int nv = (le - ab) >> 2;
      float a = init;
      for (int k = lb + threadIdx.x; k < ab; k += kThreads)
        a = combine<kMax>(a, __ldg(v + k));
      const float4* body = reinterpret_cast<const float4*>(v + ab);
#pragma unroll 4
      for (int k = threadIdx.x; k < nv; k += kThreads) {
        const float4 x = __ldg(body + k);
        a = combine<kMax>(a, x.x);
        a = combine<kMax>(a, x.y);
        a = combine<kMax>(a, x.z);
        a = combine<kMax>(a, x.w);
      }
      for (int k = ab + 4 * nv + threadIdx.x; k < le; k += kThreads)
        a = combine<kMax>(a, __ldg(v + k));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a = combine<kMax>(a, __shfl_xor_sync(0xffffffffu, a, off));
      if (lane == 0) wred[warp] = a;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = wred[0];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) total = combine<kMax>(total, wred[k]);
        out[s0 + j] = total;
      }
      __syncthreads();  // wred is read before the next long segment
    }
  }
}

template <bool kMax>
int launch(const void* v, const void* rowptr, void* out, int num_segments,
           void* stream) {
  const int blocks = (num_segments + kSegs - 1) / kSegs;
  csr_segment_reduce_kernel<kMax><<<blocks, kThreads, 0,
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
