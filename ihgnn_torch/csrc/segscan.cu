// K8 csr_segment_scan: segment-sum of a block-sorted entry stream by a
// segmented scan over each block's sorted order, f32 accumulation.
//
//   out[n, :] = sum over entries k with ids[k] == n of values[k, :]
//
// Replaces ihgnn_tpu/ops/pallas/segscan.py csr_segment_scan_t
// (segscan.py:294). The stream's ids are sorted at 1024-entry block
// granularity and in any order within a block; int32-max sentinels are
// dropped. The TPU restores each sub-block's order with a host-routed
// butterfly, scans it with masked rolls and moves the run totals to their
// node lanes with a second butterfly. Here the host hands over each
// block's sorted order (ops/segscan.py pack_scan_inputs: the stream
// position, id and run flags of each sorted entry), and the kernel scans
// it: one warp a block, one lane a feature. Each lane keeps the running
// sum of its feature along the current run and the warp writes the run's
// row at the run's tail entry. A warp owns the runs whose head lies in its
// block: it skips the entries that continue a run begun in an earlier
// block and follows its own last run into later blocks until that run's
// tail. So every segment is written once, by one warp, in stream order:
// no atomics, and the result repeats bit for bit.
//
// Bound on the H100: memory. Per entry it reads 9 bytes of pack (int32
// position, int32 id, uint8 flags) and one d-float row, and per segment it
// writes one row; d adds per entry. At d = 32 a row is one 128-byte line
// read by one coalesced warp load. Lanes load 32 pack entries at once and
// broadcast them by shuffles. Segments without entries stay as the
// wrapper's zeros.
//
// Layout: values [K, d] f32 row-major (K % block == 0), order/ids [K]
// int32, flags [K] uint8 (bit 0 head, bit 1 tail), out [N, d] f32 zeroed.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSentinel = 0x7fffffff;
constexpr int kHead = 1;
constexpr int kTail = 2;

__global__ void csr_segment_scan_kernel(const float* __restrict__ values,
                                        const int* __restrict__ order,
                                        const int* __restrict__ ids,
                                        const uint8_t* __restrict__ flags,
                                        float* __restrict__ out, int k_total,
                                        int d, int block) {
  const int lane = threadIdx.x & 31;
  const int warp_block = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long begin = static_cast<long long>(warp_block) * block;
  if (begin >= k_total) return;  // uniform across the warp
  const long long end = begin + block;
  for (int f0 = 0; f0 < d; f0 += 32) {
    const int f = f0 + lane;
    float acc = 0.f;
    bool active = false;  // inside a run this warp owns (uniform)
    int cur = 0;
    bool done = false;
    for (long long base = begin; base < k_total && !done; base += 32) {
      const long long k = base + lane;
      int my_id = kSentinel, my_src = 0, my_flag = 0;
      if (k < k_total) {
        my_id = ids[k];
        my_src = order[k];
        my_flag = flags[k];
      }
      const int n = static_cast<int>(k_total - base < 32 ? k_total - base
                                                         : 32);
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(0xffffffffu, my_id, j);
        const int src = __shfl_sync(0xffffffffu, my_src, j);
        const int fl = __shfl_sync(0xffffffffu, my_flag, j);
        const bool past = base + j >= end;
        if (past && !active) {
          done = true;
          break;
        }
        if (id == kSentinel) continue;
        if (fl & kHead) {
          if (past) {  // a run that starts in the next block is not ours
            done = true;
            break;
          }
          active = true;
          acc = 0.f;
          cur = id;
        }
        if (!active) continue;  // continues a run of an earlier block
        if (f < d) acc += values[static_cast<size_t>(src) * d + f];
        if (fl & kTail) {
          if (f < d) out[static_cast<size_t>(cur) * d + f] = acc;
          active = false;
        }
      }
    }
  }
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_csr_segment_scan(const void* values, const void* order,
                                      const void* ids, const void* flags,
                                      void* out, int k_total, int d, int block,
                                      void* stream) {
  if (block <= 0 || k_total % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = k_total / block;
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return 0;
  csr_segment_scan_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(order),
      static_cast<const int*>(ids), static_cast<const uint8_t*>(flags),
      static_cast<float*>(out), k_total, d, block);
  return static_cast<int>(cudaGetLastError());
}
