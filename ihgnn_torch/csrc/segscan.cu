// K8 csr_segment_scan: segment-sum of a block-sorted entry stream, f32
// accumulation, each block's window of the stream staged in shared memory.
//
//   out[n, :] = sum over entries k with ids[k] == n of values[k, :]
//
// Replaces ihgnn_tpu/ops/pallas/segscan.py csr_segment_scan_t
// (segscan.py:294). The stream's ids are sorted at 1024-entry block
// granularity and in any order within a block; int32-max sentinels are
// dropped. The TPU restores each sub-block's order with a host-routed
// butterfly, scans it with masked rolls and moves the run totals to their
// node lanes with a second butterfly. Here the host hands over the sorted
// order once (ops/segscan.py pack_scan_inputs): the stream position of
// each real entry sorted by id (pos), each segment's range of it (rowptr),
// and the segments each block owns (block_seg: those whose first entry
// lies in the block, an empty segment going with the next one).
//
// Bound on the H100: memory. Every stream row is read once, each segment
// written once; 4 bytes of pos an entry. The first design walked a block's
// entries one at a time, a warp a block, with about one 128-byte row in
// flight a warp (0.72 ms against 0.27 at the routed node-update shape).
// What K8 has over K1 is that a block's 1024 rows are one contiguous
// window of the stream. So one thread block owns one stream block:
// * it copies the window into shared memory with 16-byte cp.async (4-byte
//   when d is not a multiple of 4), every copy of the window in flight at
//   once, in slices of 16 features (64 KB at 1024 rows), so three blocks
//   fit an SM and one block's copy overlaps another's sums (slices of 8
//   features, 32-byte pieces of each row, and whole 128-byte rows, one
//   block an SM, both ran slower on the H100);
// * a group of G lanes owns a segment, one vector of the slice a lane
//   (float4 at d % 4 == 0: G = 4 at d = 32), and the block's groups sum
//   their segments side by side, loading kUnroll rows ahead of the adds;
// * a segment's entries past the window (a run that crosses into later
//   blocks) are read from device memory by the group that owns its head,
//   so every segment is written once, with no atomics, and segments with
//   no entry are written as 0.
// Each (segment, feature) is one f32 accumulator that starts at 0 and adds
// the segment's entries in stream order: K8 is bit for bit K1 over the
// same entries.
//
// Layout: values [K, d] f32 row-major (K % block == 0, 16-byte aligned
// rows when d % 4 == 0); pos [K_real], rowptr [N+1], block_seg [B+1]
// int32 (B = K / block); out [N, d] f32.
//
// The bf16 form (the routed pack's bf16 streams; csr_segment_scan_t stages
// values_t.dtype and widens each sub-block to f32, segscan.py:260, :318):
// values [K, d] bf16 with d % 4 == 0, staged as 8-byte quads by cp.async
// (the window's slice is 32 features, 64 KB at 1024 rows, so a d = 32 row
// is one slice), each quad widened to f32 exactly where it is added: the
// same accumulators in the same order, so the bf16 form is bit for bit K1's
// bf16 three-region form over the same entries. out [N, d] f32. Bound:
// bytes, the stream at half width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 1024;       // stream rows a block owns
constexpr int kUnroll = 4;

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 16 || sizeof(T) == 8 || sizeof(T) == 4,
                "4, 8 or 16 bytes");
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src));
  else if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(saddr),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr),
                 "l"(src));
}

__device__ __forceinline__ void add(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}
__device__ __forceinline__ void add(float& acc, float v) { acc += v; }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// A staged value as its accumulator type: f32 as it is, a bf16 quad widened.
__device__ __forceinline__ const float4& widen(const float4& v) { return v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float4 widen(uint2 v) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// T: float4 (d % 4 == 0) or float, the accumulator and output vector; S:
// the value vector, T itself (f32) or uint2 (four bf16 values, T float4);
// G: lanes a segment, the vectors of a slice (16 features: 4 float4s or 16
// floats, fewer when the row is narrower; 32 features in bf16)
template <typename T, int G, typename S = T>
__global__ void __launch_bounds__(kThreads)
    csr_segment_scan_kernel(const S* __restrict__ values,
                            const int* __restrict__ pos,
                            const int* __restrict__ rowptr,
                            const int* __restrict__ block_seg,
                            T* __restrict__ out, int dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* win = reinterpret_cast<S*>(smem_raw);   // [kBlock][G]
  constexpr int kGroups = kThreads / G;
  const int seg_lo = block_seg[blockIdx.x];
  const int seg_hi = block_seg[blockIdx.x + 1];
  if (seg_lo == seg_hi) return;   // its rows belong to earlier blocks' runs
  const bool staged = rowptr[seg_hi] > rowptr[seg_lo];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;   // kThreads % G may leave a few idle
  for (int v0 = 0; v0 < dv; v0 += G) {
    const int w = min(G, dv - v0);
    if (staged) {
      for (int i = threadIdx.x; i < kBlock * w; i += kThreads) {
        const int r = i / w, v = i % w;
        cp_async(win + r * G + v, values + (base + r) * dv + v0 + v);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
    }
    if (group < kGroups && lane < w) {
      for (int n = seg_lo + group; n < seg_hi; n += kGroups) {
        const int j0 = rowptr[n], j1 = rowptr[n + 1];
        T acc = zero<T>();
        for (int j = j0; j < j1; j += kUnroll) {
          S v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (j + u < j1) {
              const long long r = __ldg(pos + j + u) - base;
              v[u] = r < kBlock ? win[r * G + lane]
                                : __ldg(values + (base + r) * dv + v0 + lane);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (j + u < j1) add(acc, widen(v[u]));
        }
        out[static_cast<size_t>(n) * dv + v0 + lane] = acc;
      }
    }
    __syncthreads();   // the window's next slice overwrites this one
  }
}

template <typename T, int G, typename S = T>
int launch(const void* values, const void* pos, const void* rowptr,
           const void* block_seg, void* out, int blocks, int dv,
           cudaStream_t stream) {
  const int smem = kBlock * G * static_cast<int>(sizeof(S));
  static bool opted_in = false;   // above 48 KB a kernel must opt in once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_segment_scan_kernel<T, G, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  csr_segment_scan_kernel<T, G, S><<<blocks, kThreads, smem, stream>>>(
      static_cast<const S*>(values), static_cast<const int*>(pos),
      static_cast<const int*>(rowptr), static_cast<const int*>(block_seg),
      static_cast<T*>(out), dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_csr_segment_scan(const void* values, const void* pos,
                                      const void* rowptr,
                                      const void* block_seg, void* out,
                                      int k_total, int d, int block,
                                      void* stream) {
  if (block != kBlock || k_total % kBlock != 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = k_total / kBlock;
  if (blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0) {
    const int dv = d / 4;
    if (dv == 1)
      return launch<float4, 1>(values, pos, rowptr, block_seg, out, blocks,
                               dv, s);
    if (dv == 2)
      return launch<float4, 2>(values, pos, rowptr, block_seg, out, blocks,
                               dv, s);
    if (dv == 3)
      return launch<float4, 3>(values, pos, rowptr, block_seg, out, blocks,
                               dv, s);
    return launch<float4, 4>(values, pos, rowptr, block_seg, out, blocks, dv,
                             s);
  }
  if (d < 16)
    return launch<float, 8>(values, pos, rowptr, block_seg, out, blocks, d,
                            s);
  return launch<float, 16>(values, pos, rowptr, block_seg, out, blocks, d, s);
}

// The bf16 form: values [k_total, d] bf16 (d % 4 == 0, 8-byte aligned
// rows); out [N, d] f32; the rest as above.
extern "C" int ihgnn_csr_segment_scan_bf16(const void* values,
                                           const void* pos,
                                           const void* rowptr,
                                           const void* block_seg, void* out,
                                           int k_total, int d, int block,
                                           void* stream) {
  if (block != kBlock || k_total % kBlock != 0 || d <= 0 || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = k_total / kBlock;
  if (blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dv = d / 4;
  switch (dv < 4 ? dv : (dv < 8 ? 4 : 8)) {
    case 1: return launch<float4, 1, uint2>(values, pos, rowptr, block_seg,
                                            out, blocks, dv, s);
    case 2: return launch<float4, 2, uint2>(values, pos, rowptr, block_seg,
                                            out, blocks, dv, s);
    case 3: return launch<float4, 3, uint2>(values, pos, rowptr, block_seg,
                                            out, blocks, dv, s);
    case 4: return launch<float4, 4, uint2>(values, pos, rowptr, block_seg,
                                            out, blocks, dv, s);
    default: return launch<float4, 8, uint2>(values, pos, rowptr, block_seg,
                                             out, blocks, dv, s);
  }
}
