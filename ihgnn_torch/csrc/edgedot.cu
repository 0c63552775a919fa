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
// Bound on the H100: memory. Each entry reads one random row of b. On the
// GAT graph (12M entries, b [700k, 32] f32 = 90 MB, larger than the 50 MB
// L2) that is 1.54 GB of rows; gathered in entry order, each of them comes
// from device memory (0.46 ms at 3.35 TB/s however the per-entry code is
// written). The design reuses b's rows in L2 instead:
//
// * The host cuts the destination-ordered entries into chunks of at most
//   kChunk entries spanning at most kSpan segments, and sorts each chunk's
//   entries by column (ops/edgedot.py edge_dot_order). One block owns one
//   chunk. All resident blocks then walk b from low to high ids at about
//   the same pace (the warps of a block move through the sorted order
//   together), so the rows read at any moment lie in a narrow band that L2
//   holds, and b comes from device memory about once per wave of blocks.
//   Every other wave walks its columns from high to low, so it starts on
//   the rows that the wave before it read last, which L2 still holds.
// * The chunk's a rows, at most kSpan of them, are staged in shared memory
//   once; each entry reads its a row from there.
// * Each dot lands in a shared-memory slot at its destination-order
//   position; the block writes the chunk's outputs as one coalesced store
//   (stored one by one from the sorted order, they cost more than the
//   sweep saved).
// With every row of b in L2, the kernel still moves the 1.54 GB of rows
// from L2 to the SMs, and that is what bounds it then (chip_smoke.py times
// it so, as l2_resident_ms).
//
// Widths: a group of G lanes (a power of two, at most 8) owns one entry and
// reads a slice of G float4s of its rows, one a lane, so at d = 32 a group
// reads one 128-byte row and a warp 4 entries at once (16 with the unroll
// by 4). A row wider than 8 float4s is taken in slices of 8, the a slab of
// each slice staged in turn. The group's partial dots meet in a fixed
// butterfly of shuffles, and the slices add in slice order: results repeat
// bit for bit; no atomics.
//
// Layout: a [S', d] f32 (S' >= S), b [M, d] f32, both row-major and
// 16-byte aligned with d a multiple of 4; the order's chunk_ptr [C+1],
// chunk_segs [C, 2] (first and last segment), col and slot [K] int32 (slot
// = (segment - first) << 16 | (entry - chunk start)); out [K] f32 in
// destination order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 3072;   // entries a block owns at most
constexpr int kSpan = 256;     // segments a chunk spans at most
constexpr int kUnroll = 4;     // entries a group loads before it sums
constexpr int kSlotBits = 16;

__device__ __forceinline__ float dot4(const float4& x, const float4& y) {
  float acc = x.x * y.x;
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    csr_edge_dot_kernel(const float4* __restrict__ a,
                        const float4* __restrict__ b,
                        const int* __restrict__ chunk_ptr,
                        const int2* __restrict__ chunk_segs,
                        const int* __restrict__ col,
                        const int* __restrict__ slot,
                        float* __restrict__ out, int d4, int wave) {
  constexpr int kPerWarp = 32 / G;            // entries a warp pass holds
  constexpr int kStep = kThreads / G * kUnroll;  // entries a block pass
  __shared__ float4 a_s[kSpan * G];
  __shared__ float o_s[kChunk];
  const int begin = chunk_ptr[blockIdx.x];
  const int n = chunk_ptr[blockIdx.x + 1] - begin;
  const int2 segs = chunk_segs[blockIdx.x];
  const int span = segs.y - segs.x + 1;
  const int lane = threadIdx.x % G;
  const int warp = threadIdx.x / 32;
  const int group = (threadIdx.x % 32) / G;   // within the warp
  // every other wave of blocks walks its columns from high to low, so it
  // starts on the rows that the wave before it read last
  const bool down = (blockIdx.x / wave) % 2 == 1;
  for (int v0 = 0; v0 < d4; v0 += G) {
    const int w = min(G, d4 - v0);
    for (int i = threadIdx.x; i < span * G; i += kThreads) {
      const int r = i / G, v = i % G;
      a_s[i] = v < w ? a[static_cast<size_t>(segs.x + r) * d4 + v0 + v]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    // the warps step through the sorted entries together; the loop bounds
    // depend on the warp only, so the shuffles see the whole warp
    for (int base = warp * kPerWarp * kUnroll; base < n; base += kStep) {
      int j[kUnroll], s[kUnroll];
      float4 y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        j[u] = base + u * kPerWarp + group;
        s[u] = 0;
        y[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j[u] < n) {
          const int e = begin + (down ? n - 1 - j[u] : j[u]);
          s[u] = __ldg(slot + e);
          if (lane < w)
            y[u] = __ldg(b + static_cast<size_t>(__ldg(col + e)) * d4 + v0
                         + lane);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float acc = dot4(a_s[(s[u] >> kSlotBits) * G + lane], y[u]);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (j[u] < n && lane == 0) {
          const int p = s[u] & ((1 << kSlotBits) - 1);
          o_s[p] = v0 == 0 ? acc : o_s[p] + acc;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += kThreads) out[begin + i] = o_s[i];
}

template <int G>
int resident(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, csr_edge_dot_kernel<G>, kThreads, 0));
}

template <int G>
int launch(const void* a, const void* b, const void* chunk_ptr,
           const void* chunk_segs, const void* col, const void* slot,
           void* out, int chunks, int d4, cudaStream_t stream) {
  static int wave = 0;   // blocks the card holds at once
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    int err = static_cast<int>(cudaGetDevice(&dev));
    if (err == 0)
      err = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev));
    if (err == 0) err = resident<G>(&per_sm);
    if (err != 0) return err;
    wave = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  csr_edge_dot_kernel<G><<<chunks, kThreads, 0, stream>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<const int*>(chunk_ptr), static_cast<const int2*>(chunk_segs),
      static_cast<const int*>(col), static_cast<const int*>(slot),
      static_cast<float*>(out), d4, wave);
  return static_cast<int>(cudaGetLastError());
}

int group_width(int d4) {
  return d4 <= 1 ? 1 : d4 <= 2 ? 2 : d4 <= 4 ? 4 : 8;
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// chunk and span: the limits the order was built with; a launch refuses an
// order whose chunks would not fit the kernel's shared memory.
extern "C" int ihgnn_csr_edge_dot(const void* a, const void* b,
                                  const void* chunk_ptr,
                                  const void* chunk_segs, const void* col,
                                  const void* slot, void* out, int chunks,
                                  int d, int chunk, int span, void* stream) {
  if (d <= 0 || d % 4 != 0 || chunk <= 0 || chunk > kChunk || span <= 0 ||
      span > kSpan)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 0) return 0;
  const int d4 = d / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group_width(d4)) {
    case 1: return launch<1>(a, b, chunk_ptr, chunk_segs, col, slot, out,
                             chunks, d4, s);
    case 2: return launch<2>(a, b, chunk_ptr, chunk_segs, col, slot, out,
                             chunks, d4, s);
    case 4: return launch<4>(a, b, chunk_ptr, chunk_segs, col, slot, out,
                             chunks, d4, s);
    default: return launch<8>(a, b, chunk_ptr, chunk_segs, col, slot, out,
                              chunks, d4, s);
  }
}

// Blocks of the kernel for width d that one SM holds at once (the size of
// a wave is this times the SM count).
extern "C" int ihgnn_csr_edge_dot_resident(int d, int* blocks) {
  if (d <= 0 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (group_width(d / 4)) {
    case 1: return resident<1>(blocks);
    case 2: return resident<2>(blocks);
    case 4: return resident<4>(blocks);
    default: return resident<8>(blocks);
  }
}
