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
// below the card's 67 TFLOP/s f32 rate. Segments are short (3 entries in
// the scatter's backward, about 9 in the node update, 4 in the word bag),
// so what limits a kernel that walks them one at a time is latency: each
// segment is a chain rowptr -> col -> rows -> store.
//
// Vector form (d % 4 == 0, 16-byte aligned rows; every width the model
// uses). A segment belongs to a group of L lanes, L the least power of two
// >= d / 4 (at most 32), each lane holding one float4 of the row: at
// d = 32 a warp sums 4 segments at once, 8 lanes each. The warp loads the
// rowptr entries of all its segments with one instruction, each group
// loads up to L (col, w) pairs of its segment with one instruction and
// hands them round with shuffles, and a lane issues the loads of up to 8
// rows before the first FMA that needs them, so a whole short segment is
// in flight at once. d > 128 walks the row in chunks of 128 floats.
//
// Sum order: every (segment, feature) sum is one f32 accumulator over the
// segment's entries in entry order, acc = fmaf(w, x, acc) (acc += x
// without weights, the same rounding), exactly as in the scalar form below
// and in K8 (csrc/segscan.cu): the results repeat bit for bit and equal
// K8's. Only the loads are reordered, never the additions.
//
// Long segments (hub nodes under skew; f32 vector form, CSR only). A group
// keeps 8 rows in flight, so a segment of 44k entries takes 5,500 round
// trips to memory while the rest of the card has finished. The caller may
// pass the list of the segments with more than kLongEntries entries (every
// one of them, longest first: ops/segsum.py long_segments, built once with
// the CSR); the launch then puts one block per listed segment in front of
// the regular blocks, whose groups skip any segment of more than
// kLongEntries entries, so each segment is written once. A long segment's
// block copies its ids (and weights) and rows by cp.async through rings in
// shared memory, in stages of up to 64 entries (8 KB of rows): ids land
// kIdLead stages ahead of their sums, rows kRowLead. Its last warp (up to
// four at d > 128) copies nothing and adds the staged rows in entry order
// into the same one accumulator a (segment, feature): the bits are the
// group's. On an H100 80GB HBM3 (700 W) the block is bound by its
// per-stage barrier and its chain of adds, not by memory: the zipf cell's
// largest hub (43,896 rows of d = 32) takes 0.38 ms alone, its rows read
// in random or in linear order. kLongEntries = 256 from one measurement of
// the zipf node update (6M entries -> 700k x 32) on that card: 1024 (184
// blocks) took 0.673 ms, its groups' segments of 257-1024 entries the
// longest part, 512 0.560, 256 (1,043 blocks) 0.485, 128 (2,477) 0.461;
// the kernel without the list 6.77.
// The rings take 33.75 KB (35.5 KB with weights) of shared memory, which
// every block of that launch reserves: at d = 32 registers (60-64 a
// thread) hold both kernels to 4 blocks an SM, which 35.5 KB does not
// lower. A launch without a list runs csr_gather_sum_vec_kernel, which
// reserves none. The bf16, three-region and fixed-width forms keep a long
// segment on its group.
//
// Fixed width (width > 0): segment s spans entries [s * width, (s + 1) *
// width) and rowptr is not read (the scatter's backward: 3 entries an edge).
//
// Scalar form (any other d or alignment, chosen by the wrapper from the
// shapes): one warp a segment, one lane a feature.
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
//
// The bf16 forms (ModelConfig.bf16_stream; the Pallas kernels' bf16 values
// with f32 accumulation, segsum.py:211-215, :368-372): without weights,
// reading bf16 rows of x (widened to f32 exactly) into the same f32
// accumulators in the same order, and writing the sums as f32 (the node
// update, the gather's backward) or rounded once to bf16 (the scatter's
// backward in the fixed-width form: one bf16 row an edge). csr_segment_sum3
// has them too (the routed pack's bf16 streams, csr_segment_sum3_t on bf16
// regions), written as f32 (the node update) or rounded once to bf16 (the
// gather's backward, whose node gradient the Pallas path rounds to the
// stream's dtype, ihgnn_tpu/ops/hyperagg.py:430, :597). Bound: bytes, the
// bf16 reads at half width.
//
// Two lane widths, chosen from d and the rows' alignment alone
// (bf16_lane_bytes below; the wrapper's bf16_form applies the same rule):
// - the 16-byte form (d % 8 == 0, 16-byte aligned rows; every width the
//   model uses): csr_sum_bf16x8_kernel. A lane holds eight features, one
//   uint4 of bf16 widened into two float4 accumulators; L is the least
//   power of two >= d / 8, so at d = 32 a warp sums 8 segments, 4 lanes
//   each. A group loads the ids of up to max(L, 8) entries at once, up to
//   8 / L a lane, and the lane that loads an id resolves it to its row's
//   address (the three-region form: its region and the row within it, by
//   compare and subtract) before the shuffles hand it round; the loop
//   that issues a lane's 8 row loads ahead of their adds then holds only
//   shuffles, loads and adds.
// - the 8-byte form (d % 4 == 0 with 8-byte aligned rows otherwise): the
//   vector kernel above on bf16 rows, a lane four features (8 bytes),
//   groups of L >= d / 4 lanes. It resolves a three-region id per lane and
//   per entry (entry_row: a division by the region's rows).
// Both add in entry order into one f32 accumulator a (segment, feature),
// so the two forms, and K8's bf16 form (csrc/segscan.cu), give the same
// bits. At d = 32 on an NVIDIA H100 80GB HBM3 (700 W) the three-region
// sum takes 0.186 ms in the 16-byte form, where the 8-byte form's
// divisions, one between each id's shuffle and its row's load, made it
// 0.484 (PERF.md sections 6-7).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsInFlight = 8;   // row loads a lane issues before its FMAs
// a segment of more than kLongEntries entries is long (ops/segsum.py
// LONG_ENTRIES)
constexpr int kLongEntries = 256;
// a long segment's block: a stage holds up to kSlotIds entries and
// kSlotFloats floats of their rows; rows land kRowLead stages ahead of the
// sums, ids kIdLead
constexpr int kSlotIds = 64;
constexpr int kSlotFloats = 2048;
constexpr int kRowLead = 3;
constexpr int kRowStages = kRowLead + 1;
constexpr int kIdLead = 2 * kRowLead;
constexpr int kIdStages = kIdLead + 1;

// The row of column c: THREE reads row c % region_rows of region
// c / region_rows (x0, x1, x2); otherwise row c of x0.
template <bool THREE, typename T>
__device__ __forceinline__ const T* entry_row(const T* x0, const T* x1,
                                              const T* x2, int region_rows,
                                              int c, int d) {
  if (THREE) {
    const int region = c / region_rows;
    const T* xr = region == 0 ? x0 : (region == 1 ? x1 : x2);
    return xr + static_cast<size_t>(c - region * region_rows) * d;
  }
  return x0 + static_cast<size_t>(c) * d;
}

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
        const float* row = entry_row<THREE>(x0, x1, x2, region_rows, cj, d);
        if (f < d) acc = fmaf(wj, row[f], acc);
      }
    }
    if (f < d) out[static_cast<size_t>(seg) * d + f] = acc;
  }
}

// Features 4 f4 .. 4 f4 + 3 of a row, widened to f32 when bf16.
__device__ __forceinline__ float4 load_quad(const float* row, int f4) {
  return __ldg(reinterpret_cast<const float4*>(row) + f4);
}

__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* row, int f4) {
  return widen_bf16x4(__ldg(reinterpret_cast<const uint2*>(row) + f4));
}

// Four sums stored at features 4 f4 .. 4 f4 + 3 of a row, rounded once
// when bf16.
__device__ __forceinline__ void store_quad(float* row, int f4, float4 v) {
  reinterpret_cast<float4*>(row)[f4] = v;
}

__device__ __forceinline__ void store_quad(__nv_bfloat16* row, int f4,
                                           float4 v) {
  reinterpret_cast<uint2*>(row)[f4] = round_bf16x4(v);
}

__device__ __forceinline__ void fma4(float w, const float4& v, float4& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// The vector form's work of warp `warp`: groups of L lanes, 32 / L
// segments a warp (see above); rows of Tin (f32 or bf16), sums in f32,
// stored as Tout (f32 or bf16). SKIP_LONG: a group leaves a segment of more
// than kLongEntries entries to its own block.
template <int L, bool WEIGHTED, bool THREE, bool FIXED, typename Tin,
          typename Tout, bool SKIP_LONG>
__device__ __forceinline__ void vec_warp(long long warp,
                                         const Tin* __restrict__ x0,
                                         const Tin* __restrict__ x1,
                                         const Tin* __restrict__ x2,
                                         int region_rows,
                                         const int* __restrict__ col,
                                         const int* __restrict__ rowptr,
                                         const float* __restrict__ weight,
                                         Tout* __restrict__ out,
                                         int num_segments, int d, int width) {
  constexpr int G = 32 / L;                          // segments a warp
  constexpr int J = L < kRowsInFlight ? L : kRowsInFlight;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L;
  const int gl = lane - grp * L;
  const long long seg0 = warp * G;
  if (seg0 >= num_segments) return;                  // uniform across the warp
  const long long seg = seg0 + grp;
  int begin, end;
  if (FIXED) {
    begin = static_cast<int>(seg * width);
    end = seg < num_segments ? begin + width : begin;
  } else {
    // rowptr[seg0 .. seg0 + G] in one load, lane l holding entry l (at
    // G = 32 the last group reads its end itself)
    int rp = 0;
    if (lane <= G && seg0 + lane <= num_segments)
      rp = rowptr[seg0 + lane];
    begin = __shfl_sync(0xffffffffu, rp, grp);
    end = __shfl_sync(0xffffffffu, rp, (grp + 1) & 31);
    if (seg >= num_segments)
      end = begin;
    else if (G == 32 && grp == 31)
      end = rowptr[seg + 1];
  }
  const bool own = !SKIP_LONG || end - begin <= kLongEntries;
  if (!own) end = begin;
  // the group's lanes, for shuffles that stay inside it
  const unsigned mask = L == 32 ? 0xffffffffu
                                : ((1u << L) - 1u) << (grp * L);
  const int v4 = d >> 2;                             // float4s a row
  for (int c0 = 0; c0 < v4; c0 += L) {
    const int f4 = c0 + gl;
    const bool active = f4 < v4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = begin; base < end; base += L) {
      // up to L (col, w) pairs of the segment, one a lane
      const int k = base + gl;
      int c = 0;
      float w = 1.f;
      if (k < end) {
        c = __ldg(col + k);
        if (WEIGHTED) w = __ldg(weight + k);
      }
      const int n = min(L, end - base);
#pragma unroll 1
      for (int j0 = 0; j0 < n; j0 += J) {
        float4 v[J];
        float wj[J];
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const int cj = __shfl_sync(mask, c, j0 + jj, L);
          wj[jj] = WEIGHTED ? __shfl_sync(mask, w, j0 + jj, L) : 1.f;
          v[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (active && j0 + jj < n)
            v[jj] = load_quad(
                entry_row<THREE>(x0, x1, x2, region_rows, cj, d), f4);
        }
        // the FMAs in entry order
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          if (j0 + jj < n) fma4(wj[jj], v[jj], acc);
        }
      }
    }
    if (active && own && seg < num_segments)
      store_quad(out + static_cast<size_t>(seg) * d, f4, acc);
  }
}

template <int L, bool WEIGHTED, bool THREE, bool FIXED, typename Tin = float,
          typename Tout = float>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_gather_sum_vec_kernel(const Tin* __restrict__ x0,
                          const Tin* __restrict__ x1,
                          const Tin* __restrict__ x2, int region_rows,
                          const int* __restrict__ col,
                          const int* __restrict__ rowptr,
                          const float* __restrict__ weight,
                          Tout* __restrict__ out, int num_segments, int d,
                          int width) {
  vec_warp<L, WEIGHTED, THREE, FIXED, Tin, Tout, false>(
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
          (threadIdx.x >> 5),
      x0, x1, x2, region_rows, col, rowptr, weight, out, num_segments, d,
      width);
}

// One long segment [begin, end) summed by the whole block (see the top of
// the file), kChunkFloats features at a time. The last warps of the block
// sum (lane u < the chunk's float4s adds features 4 u .. 4 u + 3 of the
// staged rows in entry order, loading kRowsInFlight rows ahead of their
// FMAs) and copy nothing, so their adds wait for no copy; the other warps
// copy (warps 0-1 a stage's ids, warps 2-3 its weights, all of them its
// rows in 16-byte pieces).
template <bool WEIGHTED>
__device__ __forceinline__ void long_segment_block(
    const float* __restrict__ x, const int* __restrict__ col,
    const float* __restrict__ weight, float* __restrict__ out, long long seg,
    int begin, int end, int d) {
  __shared__ __align__(16) float rows[kRowStages * kSlotFloats];
  __shared__ int ids[kIdStages * kSlotIds];
  __shared__ float wts[WEIGHTED ? kIdStages * kSlotIds : 1];
  constexpr int kThreads = kWarpsPerBlock * 32;
  constexpr int kChunkFloats = kThreads * 2;           // at most 4 adding warps
  const int t = threadIdx.x;
  for (int f0 = 0; f0 < d; f0 += kChunkFloats) {
    const int dc = min(d - f0, kChunkFloats);         // the chunk's features
    const int c4 = dc >> 2;
    const int copiers = kThreads - 32 * ((c4 + 31) / 32);
    const int u = t - copiers;                         // the adding lane
    const int per = min(kSlotIds, kSlotFloats / dc);  // entries a stage
    const int stages = (end - begin + per - 1) / per;
    // stage j's ids (warps 0-1) and weights (warps 2-3) into slot j %
    // kIdStages
    auto copy_ids = [&](int j) {
      const int e = t % kSlotIds;
      const int k = begin + j * per + e;
      if (j < stages && e < per && k < end) {
        const int slot = (j % kIdStages) * kSlotIds + e;
        if (t < kSlotIds)
          cp_async4(ids + slot, col + k);
        else if (WEIGHTED && t < 2 * kSlotIds)
          cp_async4(wts + slot, weight + k);
      }
    };
    // stage j's rows into slot j % kRowStages, a piece (row r, float4 q) a
    // copying thread at a time; its ids have landed
    auto copy_rows = [&](int j) {
      if (j >= stages || u >= 0) return;
      const int n = min(per, end - begin - j * per);
      const int* id = ids + (j % kIdStages) * kSlotIds;
      float* slot = rows + (j % kRowStages) * kSlotFloats;
      for (int p = t; p < n * c4; p += copiers) {
        const int r = p / c4;
        const int q = p - r * c4;
        cp_async16(slot + r * dc + 4 * q,
                   x + static_cast<size_t>(id[r]) * d + f0 + 4 * q, true);
      }
    };
    for (int j = 0; j < kIdLead; ++j) copy_ids(j);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int j = 0; j < kRowLead; ++j) {
      copy_rows(j);
      cp_async_commit();
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < stages; ++j) {
      // stage j's rows (and stage j + kRowLead's ids) have landed, and every
      // lane is done with stage j - 1, whose slots the copies below reuse
      cp_async_wait<kRowLead - 1>();
      __syncthreads();
      copy_rows(j + kRowLead);
      copy_ids(j + kIdLead);
      cp_async_commit();
      if (u >= 0 && u < c4) {
        const float* slot = rows + (j % kRowStages) * kSlotFloats + 4 * u;
        const float* ws = WEIGHTED ? wts + (j % kIdStages) * kSlotIds : wts;
        const int n = min(per, end - begin - j * per);
        int i = 0;
        for (; i + kRowsInFlight <= n; i += kRowsInFlight) {
          float4 v[kRowsInFlight];
#pragma unroll
          for (int k = 0; k < kRowsInFlight; ++k)
            v[k] = *reinterpret_cast<const float4*>(slot + (i + k) * dc);
#pragma unroll
          for (int k = 0; k < kRowsInFlight; ++k)
            fma4(WEIGHTED ? ws[i + k] : 1.f, v[k], acc);
        }
        for (; i < n; ++i)
          fma4(WEIGHTED ? ws[i] : 1.f,
               *reinterpret_cast<const float4*>(slot + i * dc), acc);
      }
    }
    if (u >= 0 && u < c4)
      store_quad(out + static_cast<size_t>(seg) * d + f0, u, acc);
    cp_async_wait<0>();
    __syncthreads();                                  // the rings are free
  }
}

// Blocks 0 .. num_long - 1 each sum the long segment long_ids[block]; the
// others run the vector form's warps, which skip every long segment.
template <int L, bool WEIGHTED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_gather_sum_long_kernel(const float* __restrict__ x,
                           const int* __restrict__ col,
                           const int* __restrict__ rowptr,
                           const float* __restrict__ weight,
                           float* __restrict__ out, int num_segments, int d,
                           const int* __restrict__ long_ids, int num_long) {
  if (static_cast<int>(blockIdx.x) < num_long) {
    const int seg = long_ids[blockIdx.x];
    long_segment_block<WEIGHTED>(x, col, weight, out, seg, rowptr[seg],
                                 rowptr[seg + 1], d);
    return;
  }
  vec_warp<L, WEIGHTED, false, false, float, float, true>(
      static_cast<long long>(blockIdx.x - num_long) * kWarpsPerBlock +
          (threadIdx.x >> 5),
      x, x, x, 0, col, rowptr, weight, out, num_segments, d, 0);
}

// Lanes a segment for d / 4 float4s: the least power of two >= d / 4, at
// most 32.
int group_lanes(int d) {
  const int v4 = d / 4;
  int lanes = 1;
  while (lanes < v4 && lanes < 32) lanes *= 2;
  return lanes;
}

// Eight bf16 features (16 bytes) added to their f32 sums, features 0-3
// into lo and 4-7 into hi: acc + x, as the f32 forms' fmaf(1, x, acc).
__device__ __forceinline__ void add_bf16x8(const uint4& v, float4& lo,
                                           float4& hi) {
  const float4 a = widen_bf16x4(make_uint2(v.x, v.y));
  const float4 b = widen_bf16x4(make_uint2(v.z, v.w));
  lo.x += a.x;
  lo.y += a.y;
  lo.z += a.z;
  lo.w += a.w;
  hi.x += b.x;
  hi.y += b.y;
  hi.z += b.z;
  hi.w += b.w;
}

// Eight sums stored at features 8 f8 .. 8 f8 + 7 of a row, rounded once
// when bf16.
__device__ __forceinline__ void store_oct(float* row, int f8, float4 lo,
                                          float4 hi) {
  reinterpret_cast<float4*>(row)[2 * f8] = lo;
  reinterpret_cast<float4*>(row)[2 * f8 + 1] = hi;
}

__device__ __forceinline__ void store_oct(__nv_bfloat16* row, int f8,
                                          float4 lo, float4 hi) {
  const uint2 a = round_bf16x4(lo);
  const uint2 b = round_bf16x4(hi);
  reinterpret_cast<uint4*>(row)[f8] = make_uint4(a.x, a.y, b.x, b.y);
}

// The address of column c's row: THREE resolves region c / region_rows by
// compare and subtract (no division), once, in the lane that loaded c.
template <bool THREE>
__device__ __forceinline__ unsigned long long row_address(
    const __nv_bfloat16* x0, const __nv_bfloat16* x1,
    const __nv_bfloat16* x2, int region_rows, int c, int d) {
  const __nv_bfloat16* xr = x0;
  if (THREE) {
    if (c >= region_rows) {
      c -= region_rows;
      xr = x1;
    }
    if (c >= region_rows) {
      c -= region_rows;
      xr = x2;
    }
  }
  return reinterpret_cast<unsigned long long>(xr + static_cast<size_t>(c) *
                                                       d);
}

// Lane src's row address, handed round the group (two 32-bit shuffles).
__device__ __forceinline__ const uint4* shfl_row(unsigned mask,
                                                 unsigned long long a,
                                                 int src, int width) {
  const unsigned lo = __shfl_sync(mask, static_cast<unsigned>(a), src, width);
  const unsigned hi =
      __shfl_sync(mask, static_cast<unsigned>(a >> 32), src, width);
  return reinterpret_cast<const uint4*>(
      (static_cast<unsigned long long>(hi) << 32) | lo);
}

// The bf16 16-byte form (see the top of the file): groups of L lanes, 32 / L
// segments a warp, a lane eight features; sums in f32, stored as Tout.
template <int L, bool THREE, bool FIXED, typename Tout>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_sum_bf16x8_kernel(const __nv_bfloat16* __restrict__ x0,
                      const __nv_bfloat16* __restrict__ x1,
                      const __nv_bfloat16* __restrict__ x2, int region_rows,
                      const int* __restrict__ col,
                      const int* __restrict__ rowptr,
                      Tout* __restrict__ out, int num_segments, int d,
                      int width) {
  constexpr int G = 32 / L;                          // segments a warp
  constexpr int J = kRowsInFlight;                   // row loads ahead
  constexpr int B = L < J ? J : L;                   // entries a batch
  constexpr int C = B / L;                           // ids a lane a batch
  const int lane = threadIdx.x & 31;
  const int grp = lane / L;
  const int gl = lane - grp * L;
  const long long warp = static_cast<long long>(blockIdx.x) *
                             kWarpsPerBlock + (threadIdx.x >> 5);
  const long long seg0 = warp * G;
  if (seg0 >= num_segments) return;                  // uniform across the warp
  const long long seg = seg0 + grp;
  int begin, end;
  if (FIXED) {
    begin = static_cast<int>(seg * width);
    end = seg < num_segments ? begin + width : begin;
  } else {
    // rowptr[seg0 .. seg0 + G] in one load, lane l holding entry l (at
    // G = 32 the last group reads its end itself)
    int rp = 0;
    if (lane <= G && seg0 + lane <= num_segments)
      rp = rowptr[seg0 + lane];
    begin = __shfl_sync(0xffffffffu, rp, grp);
    end = __shfl_sync(0xffffffffu, rp, (grp + 1) & 31);
    if (seg >= num_segments)
      end = begin;
    else if (G == 32 && grp == 31)
      end = rowptr[seg + 1];
  }
  // the group's lanes, for shuffles that stay inside it
  const unsigned mask = L == 32 ? 0xffffffffu
                                : ((1u << L) - 1u) << (grp * L);
  const int v8 = d >> 3;                             // uint4s a row
  for (int c0 = 0; c0 < v8; c0 += L) {
    const int f8 = c0 + gl;
    const bool active = f8 < v8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hi = lo;
    for (int base = begin; base < end; base += B) {
      // the rows of up to B entries: lane gl resolves entries base + gl +
      // L m, m < C
      unsigned long long addr[C];
#pragma unroll
      for (int m = 0; m < C; ++m) {
        const int k = base + gl + L * m;
        addr[m] = 0;
        if (k < end)
          addr[m] = row_address<THREE>(x0, x1, x2, region_rows,
                                       __ldg(col + k), d);
      }
      const int n = min(B, end - base);
#pragma unroll 1
      for (int j0 = 0; j0 < n; j0 += J) {
        uint4 v[J];
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          // C > 1 only where B == J: then j0 == 0 and entry jj lies in
          // register jj / L of lane jj % L; else in register 0 of lane
          // j0 + jj
          const uint4* row =
              C > 1 ? shfl_row(mask, addr[jj / L], jj % L, L)
                    : shfl_row(mask, addr[0], j0 + jj, L);
          v[jj] = make_uint4(0u, 0u, 0u, 0u);
          if (active && j0 + jj < n) v[jj] = __ldg(row + f8);
        }
        // the adds in entry order
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          if (j0 + jj < n) add_bf16x8(v[jj], lo, hi);
        }
      }
    }
    if (active && seg < num_segments)
      store_oct(out + static_cast<size_t>(seg) * d, f8, lo, hi);
  }
}

template <int L, bool THREE, typename Tout>
cudaError_t launch_x8_l(const __nv_bfloat16* x0, const __nv_bfloat16* x1,
                        const __nv_bfloat16* x2, int region_rows,
                        const int* col, const int* rowptr, Tout* out,
                        int num_segments, int d, int width,
                        cudaStream_t stream) {
  constexpr int G = 32 / L;
  const long long warps = (static_cast<long long>(num_segments) + G - 1) / G;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = kWarpsPerBlock * 32;
  if (!THREE && width > 0)
    csr_sum_bf16x8_kernel<L, false, true, Tout>
        <<<grid, threads, 0, stream>>>(x0, x0, x0, 0, col, rowptr, out,
                                       num_segments, d, width);
  else
    csr_sum_bf16x8_kernel<L, THREE, false, Tout>
        <<<grid, threads, 0, stream>>>(x0, x1, x2, region_rows, col, rowptr,
                                       out, num_segments, d, 0);
  return cudaGetLastError();
}

// The 16-byte form: L the least power of two >= d / 8, at most 32.
template <bool THREE, typename Tout>
cudaError_t launch_x8(const __nv_bfloat16* x0, const __nv_bfloat16* x1,
                      const __nv_bfloat16* x2, int region_rows,
                      const int* col, const int* rowptr, Tout* out,
                      int num_segments, int d, int width,
                      cudaStream_t stream) {
  int lanes = 1;
  while (lanes < d / 8 && lanes < 32) lanes *= 2;
  switch (lanes) {
    case 1: return launch_x8_l<1, THREE>(x0, x1, x2, region_rows, col,
                                         rowptr, out, num_segments, d, width,
                                         stream);
    case 2: return launch_x8_l<2, THREE>(x0, x1, x2, region_rows, col,
                                         rowptr, out, num_segments, d, width,
                                         stream);
    case 4: return launch_x8_l<4, THREE>(x0, x1, x2, region_rows, col,
                                         rowptr, out, num_segments, d, width,
                                         stream);
    case 8: return launch_x8_l<8, THREE>(x0, x1, x2, region_rows, col,
                                         rowptr, out, num_segments, d, width,
                                         stream);
    case 16: return launch_x8_l<16, THREE>(x0, x1, x2, region_rows, col,
                                           rowptr, out, num_segments, d,
                                           width, stream);
    default: return launch_x8_l<32, THREE>(x0, x1, x2, region_rows, col,
                                           rowptr, out, num_segments, d,
                                           width, stream);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The bf16 forms' lane width in bytes, from d and the alignment of the rows
// (x0, x1, x2) and of out alone: 16 for d % 8 == 0 and 16-byte aligned
// rows, else 8 for d % 4 == 0 and 8-byte aligned rows, else 0 (refused).
// out must be 16-byte aligned in either form. The wrapper's bf16_form
// (ops/segsum.py) applies the same rule to the tensors.
int bf16_lane_bytes(int d, const void* x0, const void* x1, const void* x2,
                    const void* out) {
  if (!aligned(out, 16)) return 0;
  if (d % 8 == 0 && aligned(x0, 16) && aligned(x1, 16) && aligned(x2, 16))
    return 16;
  if (d % 4 == 0 && aligned(x0, 8) && aligned(x1, 8) && aligned(x2, 8))
    return 8;
  return 0;
}

template <int L, bool THREE, typename Tin = float, typename Tout = float>
cudaError_t launch_vec_l(const Tin* x0, const Tin* x1, const Tin* x2,
                         int region_rows, const int* col, const int* rowptr,
                         const float* weight, Tout* out, int num_segments,
                         int d, int width, cudaStream_t stream) {
  constexpr int G = 32 / L;
  const long long warps = (static_cast<long long>(num_segments) + G - 1) / G;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = kWarpsPerBlock * 32;
  if constexpr (THREE) {
    csr_gather_sum_vec_kernel<L, false, true, false, Tin, Tout>
        <<<grid, threads, 0, stream>>>(x0, x1, x2, region_rows, col, rowptr,
                                       nullptr, out, num_segments, d, 0);
  } else if constexpr (!std::is_same<Tin, float>::value) {
    // the bf16 forms: no weights
    if (width > 0)
      csr_gather_sum_vec_kernel<L, false, false, true, Tin, Tout>
          <<<grid, threads, 0, stream>>>(x0, x0, x0, 0, col, rowptr, nullptr,
                                         out, num_segments, d, width);
    else
      csr_gather_sum_vec_kernel<L, false, false, false, Tin, Tout>
          <<<grid, threads, 0, stream>>>(x0, x0, x0, 0, col, rowptr, nullptr,
                                         out, num_segments, d, 0);
  } else if (width > 0) {
    if (weight != nullptr)
      csr_gather_sum_vec_kernel<L, true, false, true>
          <<<grid, threads, 0, stream>>>(x0, x0, x0, 0, col, rowptr, weight,
                                         out, num_segments, d, width);
    else
      csr_gather_sum_vec_kernel<L, false, false, true>
          <<<grid, threads, 0, stream>>>(x0, x0, x0, 0, col, rowptr, nullptr,
                                         out, num_segments, d, width);
  } else {
    if (weight != nullptr)
      csr_gather_sum_vec_kernel<L, true, false, false>
          <<<grid, threads, 0, stream>>>(x0, x0, x0, 0, col, rowptr, weight,
                                         out, num_segments, d, 0);
    else
      csr_gather_sum_vec_kernel<L, false, false, false>
          <<<grid, threads, 0, stream>>>(x0, x0, x0, 0, col, rowptr, nullptr,
                                         out, num_segments, d, 0);
  }
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_long_l(const float* x, const int* col, const int* rowptr,
                          const float* weight, float* out, int num_segments,
                          int d, const int* long_ids, int num_long,
                          cudaStream_t stream) {
  constexpr int G = 32 / L;
  const long long warps = (static_cast<long long>(num_segments) + G - 1) / G;
  const long long blocks =
      num_long + (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = kWarpsPerBlock * 32;
  if (weight != nullptr)
    csr_gather_sum_long_kernel<L, true><<<grid, threads, 0, stream>>>(
        x, col, rowptr, weight, out, num_segments, d, long_ids, num_long);
  else
    csr_gather_sum_long_kernel<L, false><<<grid, threads, 0, stream>>>(
        x, col, rowptr, nullptr, out, num_segments, d, long_ids, num_long);
  return cudaGetLastError();
}

cudaError_t launch_long(const float* x, const int* col, const int* rowptr,
                        const float* weight, float* out, int num_segments,
                        int d, const int* long_ids, int num_long,
                        cudaStream_t stream) {
  switch (group_lanes(d)) {
    case 1: return launch_long_l<1>(x, col, rowptr, weight, out,
                                    num_segments, d, long_ids, num_long,
                                    stream);
    case 2: return launch_long_l<2>(x, col, rowptr, weight, out,
                                    num_segments, d, long_ids, num_long,
                                    stream);
    case 4: return launch_long_l<4>(x, col, rowptr, weight, out,
                                    num_segments, d, long_ids, num_long,
                                    stream);
    case 8: return launch_long_l<8>(x, col, rowptr, weight, out,
                                    num_segments, d, long_ids, num_long,
                                    stream);
    case 16: return launch_long_l<16>(x, col, rowptr, weight, out,
                                      num_segments, d, long_ids, num_long,
                                      stream);
    default: return launch_long_l<32>(x, col, rowptr, weight, out,
                                      num_segments, d, long_ids, num_long,
                                      stream);
  }
}

template <bool THREE, typename Tin = float, typename Tout = float>
cudaError_t launch_vec(const Tin* x0, const Tin* x1, const Tin* x2,
                       int region_rows, const int* col, const int* rowptr,
                       const float* weight, Tout* out, int num_segments,
                       int d, int width, cudaStream_t stream) {
  switch (group_lanes(d)) {
    case 1: return launch_vec_l<1, THREE>(x0, x1, x2, region_rows, col,
                                          rowptr, weight, out, num_segments,
                                          d, width, stream);
    case 2: return launch_vec_l<2, THREE>(x0, x1, x2, region_rows, col,
                                          rowptr, weight, out, num_segments,
                                          d, width, stream);
    case 4: return launch_vec_l<4, THREE>(x0, x1, x2, region_rows, col,
                                          rowptr, weight, out, num_segments,
                                          d, width, stream);
    case 8: return launch_vec_l<8, THREE>(x0, x1, x2, region_rows, col,
                                          rowptr, weight, out, num_segments,
                                          d, width, stream);
    case 16: return launch_vec_l<16, THREE>(x0, x1, x2, region_rows, col,
                                            rowptr, weight, out, num_segments,
                                            d, width, stream);
    default: return launch_vec_l<32, THREE>(x0, x1, x2, region_rows, col,
                                            rowptr, weight, out, num_segments,
                                            d, width, stream);
  }
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vector: 1 for the vector form (the caller guarantees d % 4 == 0 and
// 16-byte aligned x and out), 0 for the scalar form. width > 0: segments of
// exactly width entries (vector form only; rowptr is not read).
extern "C" int ihgnn_csr_gather_sum(const void* x, const void* col,
                                    const void* rowptr, const void* weight,
                                    void* out, int num_segments, int d,
                                    int vector, int width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    if (d % 4 != 0 || width < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const float* xf = static_cast<const float*>(x);
    return static_cast<int>(launch_vec<false>(
        xf, xf, xf, 0, static_cast<const int*>(col),
        static_cast<const int*>(rowptr), static_cast<const float*>(weight),
        static_cast<float*>(out), num_segments, d, width, s));
  }
  if (width != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_gather_sum_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const float*>(x), nullptr, nullptr, 0,
      static_cast<const int*>(col), static_cast<const int*>(rowptr),
      static_cast<const float*>(weight), static_cast<float*>(out),
      num_segments, d);
  return static_cast<int>(cudaGetLastError());
}

// The vector form (the caller guarantees d % 4 == 0 and 16-byte aligned x
// and out) with long_ids [num_long > 0]: every segment of more than
// kLongEntries entries, each once, longest first, and no other (a listed
// shorter one is summed twice, to the same bits).
extern "C" int ihgnn_csr_gather_sum_long(const void* x, const void* col,
                                         const void* rowptr,
                                         const void* weight, void* out,
                                         int num_segments, int d,
                                         const void* long_ids, int num_long,
                                         void* stream) {
  if (d % 4 != 0 || d <= 0 || num_long <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_long(
      static_cast<const float*>(x), static_cast<const int*>(col),
      static_cast<const int*>(rowptr), static_cast<const float*>(weight),
      static_cast<float*>(out), num_segments, d,
      static_cast<const int*>(long_ids), num_long,
      static_cast<cudaStream_t>(stream)));
}

// The bf16 forms: x [M, d] bf16, no weight; out [S, d] f32 (out_bf16 ==
// 0) or bf16 (out_bf16 == 1, rounded once); width as above. The lane width
// follows bf16_lane_bytes (refused: cudaErrorInvalidValue).
extern "C" int ihgnn_csr_gather_sum_bf16(const void* x, const void* col,
                                         const void* rowptr, void* out,
                                         int num_segments, int d, int width,
                                         int out_bf16, void* stream) {
  const int lane_bytes = bf16_lane_bytes(d, x, x, x, out);
  if (lane_bytes == 0 || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int* c = static_cast<const int*>(col);
  const int* rp = static_cast<const int*>(rowptr);
  if (lane_bytes == 16) {
    if (out_bf16)
      return static_cast<int>(launch_x8<false>(
          xb, xb, xb, 0, c, rp, static_cast<__nv_bfloat16*>(out),
          num_segments, d, width, s));
    return static_cast<int>(launch_x8<false>(xb, xb, xb, 0, c, rp,
                                             static_cast<float*>(out),
                                             num_segments, d, width, s));
  }
  if (out_bf16)
    return static_cast<int>(launch_vec<false>(
        xb, xb, xb, 0, c, rp, nullptr, static_cast<__nv_bfloat16*>(out),
        num_segments, d, width, s));
  return static_cast<int>(launch_vec<false>(xb, xb, xb, 0, c, rp, nullptr,
                                            static_cast<float*>(out),
                                            num_segments, d, width, s));
}

// The three-region form: col in [0, 3 * region_rows), no weight; vector as
// above, for all three regions and out.
extern "C" int ihgnn_csr_segment_sum3(const void* x0, const void* x1,
                                      const void* x2, int region_rows,
                                      const void* col, const void* rowptr,
                                      void* out, int num_segments, int d,
                                      int vector, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_vec<true>(
        static_cast<const float*>(x0), static_cast<const float*>(x1),
        static_cast<const float*>(x2), region_rows,
        static_cast<const int*>(col), static_cast<const int*>(rowptr),
        nullptr, static_cast<float*>(out), num_segments, d, 0, s));
  }
  const int blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_gather_sum_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(x1),
      static_cast<const float*>(x2), region_rows,
      static_cast<const int*>(col), static_cast<const int*>(rowptr), nullptr,
      static_cast<float*>(out), num_segments, d);
  return static_cast<int>(cudaGetLastError());
}

// The three-region bf16 form: x0, x1, x2 [region_rows, d] bf16; out f32
// (out_bf16 == 0) or bf16 (out_bf16 == 1, rounded once). The lane width
// follows bf16_lane_bytes (refused: cudaErrorInvalidValue).
extern "C" int ihgnn_csr_segment_sum3_bf16(const void* x0, const void* x1,
                                           const void* x2, int region_rows,
                                           const void* col,
                                           const void* rowptr, void* out,
                                           int num_segments, int d,
                                           int out_bf16, void* stream) {
  const int lane_bytes = bf16_lane_bytes(d, x0, x1, x2, out);
  if (lane_bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(x0);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(x1);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(x2);
  const int* cl = static_cast<const int*>(col);
  const int* rp = static_cast<const int*>(rowptr);
  if (lane_bytes == 16) {
    if (out_bf16)
      return static_cast<int>(launch_x8<true>(
          a, b, c, region_rows, cl, rp, static_cast<__nv_bfloat16*>(out),
          num_segments, d, 0, s));
    return static_cast<int>(launch_x8<true>(a, b, c, region_rows, cl, rp,
                                            static_cast<float*>(out),
                                            num_segments, d, 0, s));
  }
  if (out_bf16)
    return static_cast<int>(launch_vec<true>(
        a, b, c, region_rows, cl, rp, nullptr,
        static_cast<__nv_bfloat16*>(out), num_segments, d, 0, s));
  return static_cast<int>(launch_vec<true>(a, b, c, region_rows, cl, rp,
                                           nullptr, static_cast<float*>(out),
                                           num_segments, d, 0, s));
}
