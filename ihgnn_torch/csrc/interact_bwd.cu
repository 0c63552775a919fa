// K3 interact_bwd and K5 interact_bwd_absorb: fused hyperedge feature
// interaction, backward.
//
// For out[e] = b + sum_j part_j[e] . W_j (csrc/interact.cu) and an output
// cotangent cot [E, out]:
//
//   dpart_j[e] = cot[e] . W_j^T                 (registers only)
//   du, dq, di = the product rule on the dparts  -> droles [3, E, d]
//   dW_j       = sum_e part_j[e]^T (x) cot[e]     -> [parts * d, out]
//   db         = sum_e cot[e]                     -> [out]
//
// Replaces ihgnn_tpu/ops/pallas/interact.py interact_bwd (interact.py:340)
// with its kernels _bwd_kernel (:253) and _bwd_kernel_batchk (:80), and,
// under ABSORB, interact_bwd_absorb (:422, kernel _bwd_kernel_absorb). The
// TPU kernel carries dW/db in a VMEM accumulator across its sequential
// grid. Blocks on the card run in no order, so one launch of the C entry
// point runs two kernels:
//
// 1. interact_bwd_fused_kernel: one pass over the edges. A block owns a
//    fixed chunk of edges (chunk_edges, chosen by the caller), streams it
//    through shared memory with cp.async, and with each staged tile forms
//    the dparts (cot . W^T) and the product rule, storing du, dq, di, and
//    accumulates the chunk's dW (parts^T . cot) and db. Both products run
//    on the tensor cores in 3xTF32 (three TF32 products a product, f32
//    accuracy). The partial goes to partial[chunk][parts * d + 1][out]; the
//    last row is db. Details above the kernel.
// 2. reduce_partials_kernel: sums the partials over chunks in chunk order.
//
// No atomics: every sum runs in a fixed order that depends only on E and
// chunk_edges, so the result repeats bit for bit.
//
// Bound on the H100: at order 3, d = out = 32 the data gradient and dW
// each take 2 * parts * d * out FLOPs an edge (14,336 each); on the f32
// CUDA cores that is 0.86 ms for 2M edges, on the tensor cores in 3xTF32
// 0.35 ms, below the bytes (u, q, i and cot read once, du, dq, di written
// once: 0.535 ms), so the bound is memory at every order. What holds the
// kernel above it is the work around the products: an mma.sync a TF32
// product, three of them a 3xTF32 product, and a split of each operand
// element by every warp that needs it, at 12 warps an SM. ABSORB reads c2
// too (0.646 ms of bytes for the routed pack's 2,097,152 edges), gathers
// its i and c2 rows through pi, and keeps one stage a block (below).
//
// K5's absorbed backward (interact_bwd_absorb, ABSORB below) runs the same
// kernel with three changes of address and one merge; the arithmetic is
// the same, so on the edges of one [R, C] grid it gives bit for bit what
// interact_bwd gives on the pre-permuted inputs (see ABSORB).
//
// Layout: u/q/i [E, d] f32 row-major (d % 4 == 0), W [parts * d, out] f32,
// cot [E, out] f32; droles [3, E, d] f32; partial [chunks, parts * d + 1,
// out] f32 scratch; dw_ext [parts * d + 1, out] f32 (dW, then db). out is
// one of 8, 16, 32, 64. W is staged in shared memory beside the two edge
// stages when both fit (every shape the model runs); when they do not
// (d above 76 to 184, by out and order), the data product reads W from
// device memory instead, so every shape whose two stages fit runs (d up
// to 268 to 288, by out).
//
// ABSORB (K5, interact_bwd_absorb, interact.py:422): the backward of the
// absorbed forward (csrc/interact.cu), for the edges of an [R, C] grid in
// sigma order with i given in t1 order and pi [R, C] the row-local stage
// between them (rho = pi^-1). With e_pi = r C + pi[r, c] for e = r C + c:
// - the i row of edge e is staged from i_t1[e_pi] (role_row);
// - c2[e_pi] is staged by cp.async beside c1[e], with each row's mask
//   value and e_pi, and the cotangent is merged once a tile in shared
//   memory, cot[e] = (c1[e] + c2[e_pi]) * mask[e], an f32 add then an f32
//   multiply, the twin's arithmetic (o2 = rho(o1), whose vector-Jacobian
//   product is the pi-gather of c2; the mask zeroes the sigma pads, copies
//   of real rows that must reach no gradient). Each thread merges the
//   vectors it copied, before the barrier that shows the tile to all;
// - di is stored for i_t1, di_t1[e_pi] = di_sigma[e]: a rho scatter that
//   writes each row once;
// - du and dq are stored at e, and dW, db and the chunk partials are those
//   of the direct kernel.
// With cols equal to chunk_edges (the routed pack: 1024) a block's pi
// reads and rho stores stay in its own grid row, a 128 KB window that L2
// holds; any cols that divides E is right. On the TPU pi and rho were
// dynamic gathers inside the VMEM block; here they are row addresses.
//
// The bf16 form (ModelConfig.bf16_stream; interact_bwd_bf16_kernel): bf16
// u, q, i and cot, as the Pallas kernel takes them (interact.py:80-125):
// dparts = W_bf16 . cot in f32; the product rule in f32 on the widened u,
// q, i, with du, dq, di each rounded to bf16 once; dW = parts_bf16^T . cot
// in f32 (the parts rounded as the forward rounds them); db = sum cot in
// f32. Both products are one mma.sync.m16n8k16 bf16 pass (bf16.cuh): a
// bf16 x bf16 product is exact in f32, so no split. It keeps the fused
// kernel's arithmetic and its fixed-order partials, one a chunk, summed by
// reduce_partials_kernel (so a step repeats bit for bit), on a design of
// its own for Hopper (details above the kernel): persistent blocks of 8
// warps that walk their chunks as one stream of 64-edge tiles through a
// ring of 2-4 cp.async stages, W rounded to bf16 once a block, every mma
// fragment read by ldmatrix, and du, dq, di staged in shared memory and
// stored as whole 16-byte row pieces. It takes d % 8 == 0 when W, the
// staged output rows and two stages fit in one block's shared memory (d
// up to 120 at out = 32, order 3; the entry point refuses a larger d).
// Bound: bytes. At order 3, E = 2M, d = out = 32 it reads u, q, i and cot
// (4 x 128 MB) and writes du, dq, di (3 x 128 MB): 0.27 ms at 3.35 TB/s;
// the two products' 28,672 FLOPs an edge take 0.058 ms at the 989 TFLOP/s
// bf16 rate.
//
// The bf16 form with ABSORB (K5's backward on the routed pack's bf16
// streams, _bwd_kernel_absorb on bf16 operands, interact.py:203-227): the
// i row of edge e staged from i_t1[e_pi], c2[e_pi] staged beside c1[e] in
// a plane of its own, and the merged cotangent formed as Pallas forms it,
// in bf16: cot = round_bf16(c1 + c2) (one rounding of the exact f32 sum of
// two bf16 values), then times the mask (0 or 1, exact). The merge runs in
// shared memory, each thread on the vectors it copied, before the barrier
// that shows the tile to all, so the dW product, the data product and db
// all read the one rounded bf16 cotangent; di is stored at e_pi. Each
// stage has its c2 plane, and each tile's pi and mask are copied into a
// ring of their own ahead of its rows. On the edges of one [R, C] grid it
// is bit for bit the direct bf16 form on the pre-permuted inputs. Bound:
// bytes, the direct bf16 form's plus c2 (128 MB at the routed pack's
// 2,097,152 edges), pi and the mask.

#include <cuda_runtime.h>

#include <algorithm>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kReduceOut = 32;   // outputs a reduce block owns
constexpr int kReduceLanes = 16; // chunk lanes of a reduce block
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
constexpr size_t kSmemPerSm = 233472;  // shared memory of an SM
constexpr size_t kSmemReserved = 1024; // the runtime's share of a block

template <int ORDER>
__host__ __device__ constexpr int parts_of() {
  return ORDER == 1 ? 3 : (ORDER == 2 ? 6 : 7);
}

template <int P>
__device__ __forceinline__ void make_parts(float u, float q, float i,
                                           float (&p)[P]) {
  p[0] = u;
  p[1] = q;
  p[2] = i;
  if constexpr (P >= 6) {
    p[3] = u * q;
    p[4] = q * i;
    p[5] = i * u;
  }
  if constexpr (P >= 7) p[6] = p[3] * i;
}

// The pi-permuted edge of e in its grid row of `cols` edges (ABSORB).
__device__ __forceinline__ int permuted_edge(const int* __restrict__ pi,
                                             int e, int cols) {
  return e - e % cols + pi[e];
}

// out[n] = sum over chunks c of partial[c][n], in a fixed order: lane l of
// a block sums chunks l, l + 16, ... in turn, then lane 0 sums the 16 lane
// sums in lane order.
__global__ void __launch_bounds__(kReduceOut * kReduceLanes)
reduce_partials_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int chunks, int n) {
  __shared__ float red[kReduceLanes][kReduceOut];
  const int oi = threadIdx.x % kReduceOut;
  const int lane = threadIdx.x / kReduceOut;
  const int idx = blockIdx.x * kReduceOut + oi;
  float s = 0.f;
  if (idx < n) {
    for (int c = lane; c < chunks; c += kReduceLanes)
      s += partial[static_cast<size_t>(c) * n + idx];
  }
  red[lane][oi] = s;
  __syncthreads();
  if (lane == 0 && idx < n) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < kReduceLanes; ++l) t += red[l][oi];
    out[idx] = t;
  }
}

// ---------------------------------------------------------------------------
// The fused backward on the tensor cores (interact_bwd, interact_bwd_absorb)
// ---------------------------------------------------------------------------

constexpr int kFusedWarps = 4;
constexpr int kFusedThreads = 32 * kFusedWarps;
constexpr int kFusedTile = 32;    // edges staged at once
constexpr int kBf16Warps = 8;     // the bf16 form's warps a block
constexpr int kBf16Threads = 32 * kBf16Warps;
constexpr int kBf16MaxStages = 4; // the bf16 form's deepest ring
constexpr int kBf16Tile = 64;     // the bf16 form's edges a stage

// ABSORB's pi and mask ring: tile k's slot is written with tile k - stages
// + 1's rows and read up to tile k, so it needs 2 stages - 1 slots; a power
// of two
__host__ __device__ constexpr int pi_slots_of(int stages) {
  return stages <= 2 ? 4 : 8;
}

// Fragments of mma.m16n8k8: see tf32.cuh.
//
// grid (chunks, slabs), kFusedThreads threads. A block owns chunk
// blockIdx.x of chunk_edges edges and streams it through shared memory
// kFusedTile edges at a time, double-buffered by cp.async (ABSORB: one
// stage, below): u, q, i rows
// [kFusedTile][d + 8] and cot rows [kFusedTile][OUT + 8] (pads chosen so
// that the fragment loads below meet no bank conflict). Each tile is used
// twice while it is staged, so the inputs are read from device memory once:
//
// 1. dW^T [OUT, parts * d] += cot^T [OUT, T] . parts [T, parts * d]: warp w
//    owns the features f = 32 fs + 8 w + (0..7) of slab fs and, for each
//    part j, the rows j d + f: it forms the parts of its features in
//    registers (make_parts on the staged u, q, i), and keeps an [OUT-slab,
//    8] accumulator tile per part and 16 outputs in registers for the whole
//    chunk. Slab (fs, os) covers features 32 fs .. 32 fs + 31 and outputs
//    32 os .. 32 os + 31, so the accumulators stay at P * 2 tiles a warp
//    for every width; the main path (d = out = 32) is one slab.
// 2. Slab 0 only: dparts [T, parts * d] = cot [T, OUT] . W^T, W staged in
//    shared memory once (WS; else read from device memory), in [16
//    edges, 8 features] tiles, warp w taking the feature blocks 8 w, 8 (w +
//    4), ...; the product rule runs on the accumulator fragments in f32,
//    each thread holding every part's dpart at its (edge, feature)
//    positions beside u, q, i read from the stage, and du, dq, di go from
//    registers to the [3, E, d] buffer, 32-byte row pieces a store. No
//    dpart leaves registers. Slab 0 also sums db.
//
// Both products run on the tensor cores in 3xTF32 (split_tf32): f32
// accuracy at three TF32 products a product. At order 3, d = out = 32 the
// two products are 2 * 2 * 7 * 32 * 32 FLOPs an edge: 3 x 57 GFLOP over 2M
// edges at 495 TFLOP/s is 0.35 ms, under the 0.535 ms of the bytes (u, q,
// i, cot read once, du, dq, di written once), where the f32 cores would
// need 0.86 ms. The partial of the chunk goes to partial[chunk][parts * d +
// 1][OUT] (the last row db) and reduce_partials_kernel sums the chunks in
// a fixed order, so the result repeats bit for bit.
//
// ABSORB: i through pi, the merged cotangent and the rho store of di, as
// the file's header says; cot2, pi, mask (or null) and cols are unused
// without it. WS: W staged in shared memory (else read from device
// memory).
//
// At order 3 the launch bounds ask for three blocks an SM
// (interact_bwd_fused_kernel3): the compiler then keeps the kernel at 168
// registers (a few spills) instead of 191, and on the H100 80GB HBM3 at
// 700 W that is faster (1.38 against 1.59 ms at 2M edges; K5 1.91
// against 2.23); at order 1
// the same bound made K5 slower (1.40 against 1.14 ms), so the kernel of
// the other orders asks nothing.
//
// ABSORB streams its tiles through one stage, not two: beside W, the c2
// plane and the rows' e_pi, two stages would leave shared memory for two
// blocks an SM, one stage leaves it for three (12 warps, as the direct
// kernel runs), which is the faster of the two on the H100 (PERF.md). The
// loads of the next tile then wait for the current tile's products; the
// other blocks of the SM cover them.

// Fetch the 128-byte line at p into L1 ahead of its use.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

template <int OUT, int ORDER, bool ABSORB, bool WS>
__device__ __forceinline__ void interact_bwd_fused(
    const float* __restrict__ u, const float* __restrict__ q,
    const float* __restrict__ it, const float* __restrict__ w,
    const float* __restrict__ cot, const float* __restrict__ cot2,
    const int* __restrict__ pi, const float* __restrict__ mask,
    float* __restrict__ droles, float* __restrict__ partial, int edges,
    int d, int chunk_edges, int cols) {
  constexpr int P = parts_of<ORDER>();
  constexpr int T = kFusedTile;
  constexpr int SC = OUT + 8;              // staged cot row
  constexpr int SW = OUT <= 32 ? 36 : 68;  // staged W row
  constexpr int MT = OUT >= 32 ? 2 : 1;    // 16-output tiles of a slab
  constexpr int OS = (OUT + 31) / 32;      // output slabs
  constexpr int KO = OUT / 8;              // k steps of the data product
  constexpr int C4 = OUT / 4;              // 16-byte vectors a cot row
  const int sd = d + 8;                    // staged role row
  const int R = P * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int fs = blockIdx.y / OS;
  const int os = blockIdx.y - fs * OS;
  const bool data = blockIdx.y == 0;

  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);   // [R][SW] W, if WS
  float* stages = ws + (WS ? static_cast<size_t>(R) * SW : 0);
  // a stage: u, q, i rows [T][sd] and cot rows [T][SC]; ABSORB adds each
  // row's e_pi, and after its one stage the gathered c2 rows [T][OUT]
  const int stage_floats = T * (3 * sd + SC) + (ABSORB ? T : 0);
  float* c2s = stages + stage_floats;

  if (data && WS) {
    for (int idx = threadIdx.x; idx < R * C4; idx += kFusedThreads) {
      const int r = idx / C4;
      const int v = idx - r * C4;
      reinterpret_cast<float4*>(ws + r * SW)[v] =
          __ldg(reinterpret_cast<const float4*>(w) + idx);
    }
  }

  const long long begin = static_cast<long long>(blockIdx.x) * chunk_edges;
  const int e_begin = static_cast<int>(begin);
  const int e_end = static_cast<int>(
      begin + chunk_edges < edges ? begin + chunk_edges : edges);
  const int tiles = (e_end - e_begin + T - 1) / T;
  const int v4 = d >> 2;

  // the row of role a (0 u, 1 q, 2 i) of edge e; ABSORB reads i at e_pi
  auto role_row = [&](int a, int e) -> const float* {
    const float* src = a == 0 ? u : (a == 1 ? q : it);
    if (ABSORB && a == 2) e = permuted_edge(pi, e, cols);
    return src + static_cast<size_t>(e) * d;
  };

  auto issue = [&](int tile) {
    float* buf = stages + (ABSORB ? 0 : (tile & 1)) * stage_floats;
    const int e0 = e_begin + tile * T;
    const int n_e = min(T, e_end - e0);
    for (int idx = threadIdx.x; idx < 3 * T * v4; idx += kFusedThreads) {
      const int a = idx / (T * v4);
      const int rem = idx - a * T * v4;
      const int te = rem / v4;
      const int v = rem - te * v4;
      const bool valid = te < n_e;
      cp_async16(buf + (a * T + te) * sd + 4 * v,
                 valid ? role_row(a, e0 + te) + 4 * v : u, valid);
    }
    for (int idx = threadIdx.x; idx < T * C4; idx += kFusedThreads) {
      const int te = idx / C4;
      const int v = idx - te * C4;
      const bool valid = te < n_e;
      cp_async16(buf + 3 * T * sd + te * SC + 4 * v,
                 valid ? cot + static_cast<size_t>(e0 + te) * OUT + 4 * v
                       : cot,
                 valid);
    }
    if constexpr (ABSORB) {
      // c2 rows at e_pi, copied by the threads that copy the same c1
      // vectors (they merge them); each row's e_pi
      for (int idx = threadIdx.x; idx < T * C4; idx += kFusedThreads) {
        const int te = idx / C4;
        const int v = idx - te * C4;
        const bool valid = te < n_e;
        cp_async16(c2s + te * OUT + 4 * v,
                   valid ? cot2 + static_cast<size_t>(permuted_edge(
                                      pi, e0 + te, cols)) * OUT + 4 * v
                         : cot2,
                   valid);
      }
      if (threadIdx.x < T && threadIdx.x < n_e)
        reinterpret_cast<int*>(buf + T * (3 * sd + SC))[threadIdx.x] =
            permuted_edge(pi, e0 + threadIdx.x, cols);
      if (threadIdx.x == 0 && e0 + T < e_end) {
        prefetch_l1(pi + e0 + T);   // the next tile's pi and mask
        if (mask != nullptr) prefetch_l1(mask + e0 + T);
      }
    }
    cp_async_commit();
  };

  // ABSORB: this thread's c1 vectors of the tile, merged with the c2
  // vectors it copied: (c1 + c2) * mask, an f32 add then an f32 multiply,
  // as the twin computes it
  auto merge = [&](float* buf, int e0, int n_e) {
    float* cs = buf + 3 * T * sd;
    for (int idx = threadIdx.x; idx < T * C4; idx += kFusedThreads) {
      const int te = idx / C4;
      if (te >= n_e) continue;
      const float m = mask != nullptr ? __ldg(mask + e0 + te) : 1.f;
      float4* c = reinterpret_cast<float4*>(cs + te * SC) + (idx - te * C4);
      const float4 y = reinterpret_cast<const float4*>(c2s)[idx];
      float4 x = *c;
      x.x = __fmul_rn(__fadd_rn(x.x, y.x), m);
      x.y = __fmul_rn(__fadd_rn(x.y, y.y), m);
      x.z = __fmul_rn(__fadd_rn(x.z, y.z), m);
      x.w = __fmul_rn(__fadd_rn(x.w, y.w), m);
      *c = x;
    }
  };

  // product 1: this warp's features and accumulators
  const int F2 = 32 * fs + 8 * warp;
  const bool has2 = F2 < d;
  float acc[MT][P][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < P; ++j)
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  float bacc = 0.f;
  const size_t plane = static_cast<size_t>(edges) * d;
  const float* wsrc = WS ? ws : w;         // W rows, wstride floats apart
  const int wstride = WS ? SW : OUT;

  if (tiles > 0) issue(0);
  for (int tile = 0; tile < tiles; ++tile) {
    const int e0 = e_begin + tile * T;
    const int n_e = min(T, e_end - e0);
    float* us = stages + (ABSORB ? 0 : (tile & 1)) * stage_floats;
    if (ABSORB) {
      // the tile has landed for this thread, which merges what it copied
      cp_async_wait<0>();
      merge(us, e0, n_e);
    } else {
      if (tile + 1 < tiles) {
        issue(tile + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();  // the tile (and W) has landed for every thread
    const float* qs = us + T * sd;
    const float* is = qs + T * sd;
    const float* cs = is + T * sd;
    // ABSORB: e_pi of each row of the tile
    const int* pis = reinterpret_cast<const int*>(cs + T * SC);

    // 1. dW^T += cot^T . parts, 8 edges a k step, into a fresh tile sum
    if (has2) {
      const int f = F2 + g;
      const bool fv = f < d;
      float tacc[MT][P][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < P; ++j)
          tacc[m][j][0] = tacc[m][j][1] = tacc[m][j][2] = tacc[m][j][3] =
              0.f;
#pragma unroll
      for (int ks = 0; ks < T / 8; ++ks) {
        const int ea = 8 * ks + t;
        const int eb = ea + 4;
        unsigned bh[P][2], bl[P][2];
        {
          float pa[P], pb[P];
          make_parts<P>(fv ? us[ea * sd + f] : 0.f,
                        fv ? qs[ea * sd + f] : 0.f,
                        fv ? is[ea * sd + f] : 0.f, pa);
          make_parts<P>(fv ? us[eb * sd + f] : 0.f,
                        fv ? qs[eb * sd + f] : 0.f,
                        fv ? is[eb * sd + f] : 0.f, pb);
#pragma unroll
          for (int j = 0; j < P; ++j) {
            split_tf32(pa[j], bh[j][0], bl[j][0]);
            split_tf32(pb[j], bh[j][1], bl[j][1]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int o = 32 * os + 16 * m + g;
          const float x[4] = {
              o < OUT ? cs[ea * SC + o] : 0.f,
              o + 8 < OUT ? cs[ea * SC + o + 8] : 0.f,
              o < OUT ? cs[eb * SC + o] : 0.f,
              o + 8 < OUT ? cs[eb * SC + o + 8] : 0.f};
          unsigned ah[4], al[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) split_tf32(x[k], ah[k], al[k]);
          mma_3xtf32<P>(tacc[m], ah, al, bh, bl);
        }
      }
      // the tile's sum joins the chunk's by a rounded f32 add. An mma
      // truncates the sum it accumulates into; carried over a whole chunk
      // (384 mma a 1024-edge chunk) that bias put dW up to 1.2e-5 of its
      // largest value off float64 (H100 80GB HBM3, 700 W), a tile's 12
      // below 3e-7
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[m][j][k] = __fadd_rn(acc[m][j][k], tacc[m][j][k]);
    }

    // 2. the data gradient and db (slab 0)
    if (data) {
      for (int fb = warp; 8 * fb < d; fb += kFusedWarps) {
        const int F1 = 8 * fb;
        const bool bv = F1 + g < d;     // this lane's W row exists
#pragma unroll
        for (int mt = 0; mt < T / 16; ++mt) {
          float dp[P][4];
#pragma unroll
          for (int j = 0; j < P; ++j)
            dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
          const float* c_lo = cs + (16 * mt + g) * SC;
          const float* c_hi = c_lo + 8 * SC;
#pragma unroll
          for (int kk = 0; kk < KO; ++kk) {
            const int o = 8 * kk + t;
            unsigned ah[4], al[4];
            split_tf32(c_lo[o], ah[0], al[0]);
            split_tf32(c_hi[o], ah[1], al[1]);
            split_tf32(c_lo[o + 4], ah[2], al[2]);
            split_tf32(c_hi[o + 4], ah[3], al[3]);
            unsigned bh[P][2], bl[P][2];
#pragma unroll
            for (int j = 0; j < P; ++j) {
              const float* wr =
                  wsrc + static_cast<size_t>(j * d + F1 + g) * wstride;
              split_tf32(bv ? wr[o] : 0.f, bh[j][0], bl[j][0]);
              split_tf32(bv ? wr[o + 4] : 0.f, bh[j][1], bl[j][1]);
            }
            mma_3xtf32<P>(dp, ah, al, bh, bl);
          }
          // the product rule as _bwd_kernel writes it (interact.py:284-294),
          // at features f, f + 1 of edges 16 mt + g and 16 mt + g + 8
          const int f = F1 + 2 * t;
          if (f < d) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int te = 16 * mt + g + 8 * h;
              if (te >= n_e) continue;
              const int at_s = te * sd + f;
              const float2 uu = *reinterpret_cast<const float2*>(us + at_s);
              const float2 qq = *reinterpret_cast<const float2*>(qs + at_s);
              const float2 ii = *reinterpret_cast<const float2*>(is + at_s);
              float gu[2], gq[2], gi[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float x = c ? uu.y : uu.x;
                const float y = c ? qq.y : qq.x;
                const float z = c ? ii.y : ii.x;
                float du = dp[0][2 * h + c], dq = dp[1][2 * h + c],
                      di = dp[2][2 * h + c];
                if constexpr (P >= 6) {
                  du += dp[3][2 * h + c] * y + dp[5][2 * h + c] * z;
                  dq += dp[3][2 * h + c] * x + dp[4][2 * h + c] * z;
                  di += dp[4][2 * h + c] * y + dp[5][2 * h + c] * x;
                }
                if constexpr (P >= 7) {
                  du += dp[6][2 * h + c] * (y * z);
                  dq += dp[6][2 * h + c] * (x * z);
                  di += dp[6][2 * h + c] * (x * y);
                }
                gu[c] = du;
                gq[c] = dq;
                gi[c] = di;
              }
              const size_t at = static_cast<size_t>(e0 + te) * d + f;
              // ABSORB: di for i_t1, at row e_pi
              const size_t at_i =
                  ABSORB ? static_cast<size_t>(pis[te]) * d + f : at;
              *reinterpret_cast<float2*>(droles + at) =
                  make_float2(gu[0], gu[1]);
              *reinterpret_cast<float2*>(droles + plane + at) =
                  make_float2(gq[0], gq[1]);
              *reinterpret_cast<float2*>(droles + 2 * plane + at_i) =
                  make_float2(gi[0], gi[1]);
            }
          }
        }
      }
      if (threadIdx.x < OUT) {
        for (int te = 0; te < n_e; ++te) bacc += cs[te * SC + threadIdx.x];
      }
    }
    __syncthreads();  // the stage is read before it is refilled
    if (ABSORB && tile + 1 < tiles) issue(tile + 1);
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * (R + 1) * OUT;
  if (has2 && F2 + 2 * t < d) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int r = j * d + F2 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int o = 32 * os + 16 * m + g;
        if (o < OUT) {
          out[static_cast<size_t>(r) * OUT + o] = acc[m][j][0];
          out[static_cast<size_t>(r + 1) * OUT + o] = acc[m][j][1];
        }
        if (o + 8 < OUT) {
          out[static_cast<size_t>(r) * OUT + o + 8] = acc[m][j][2];
          out[static_cast<size_t>(r + 1) * OUT + o + 8] = acc[m][j][3];
        }
      }
    }
  }
  if (data && threadIdx.x < OUT)
    out[static_cast<size_t>(R) * OUT + threadIdx.x] = bacc;
}

#define FUSED_PARAMS                                                       \
  const float* __restrict__ u, const float* __restrict__ q,                \
      const float* __restrict__ it, const float* __restrict__ w,           \
      const float* __restrict__ cot, const float* __restrict__ cot2,       \
      const int* __restrict__ pi, const float* __restrict__ mask,          \
      float* __restrict__ droles, float* __restrict__ partial, int edges, \
      int d, int chunk_edges, int cols
#define FUSED_ARGS \
  u, q, it, w, cot, cot2, pi, mask, droles, partial, edges, d, chunk_edges, cols

// the fused kernel at orders 1 and 2
template <int OUT, int ORDER, bool ABSORB, bool WS>
__global__ void __launch_bounds__(kFusedThreads)
interact_bwd_fused_kernel(FUSED_PARAMS) {
  interact_bwd_fused<OUT, ORDER, ABSORB, WS>(FUSED_ARGS);
}

// at order 3, three blocks an SM asked of the compiler (above)
template <int OUT, bool ABSORB, bool WS>
__global__ void __launch_bounds__(kFusedThreads, 3)
interact_bwd_fused_kernel3(FUSED_PARAMS) {
  interact_bwd_fused<OUT, 3, ABSORB, WS>(FUSED_ARGS);
}

#undef FUSED_PARAMS
#undef FUSED_ARGS

// the fused kernel of ORDER (only the one taken is instantiated)
template <int OUT, int ORDER, bool ABSORB, bool WS>
constexpr auto fused_kernel() {
  if constexpr (ORDER == 3) {
    return interact_bwd_fused_kernel3<OUT, ABSORB, WS>;
  } else {
    return interact_bwd_fused_kernel<OUT, ORDER, ABSORB, WS>;
  }
}

// ---------------------------------------------------------------------------
// The bf16 form (interact_bwd on bf16 streams)
// ---------------------------------------------------------------------------
//
// Persistent blocks: grid (blocks, slabs) of kBf16Threads threads, with
// blocks the number the card holds at once (at most one a chunk). Block b
// of a slab takes chunks b, b + blocks, ... in turn, as one stream of
// kBf16Tile-edge tiles through a ring of `stages` (2-4) shared-memory
// stages filled by cp.async, each tile issued stages - 1 tiles ahead of
// its use and across the chunks' boundaries, so no chunk starts on an
// empty pipeline. W is rounded to bf16 into shared memory once a block
// (slab 0). A chunk's dW and db stay in registers while its tiles pass
// and go to partial[chunk] at its last tile, so every partial, and the
// fixed-order reduce_partials_kernel over them, is what a block a chunk
// gives bit for bit. The launcher takes the deepest ring that leaves room
// for three blocks an SM, else two: on the H100 the blocks resident, not
// the depth, set the time (PERF.md).
//
// Shared memory: W rounded to bf16 [parts * d][OUT + 8], the tile's du,
// dq, di rows [3][T][d + 8] (both slab 0), then the stages, each u, q, i
// rows [T][d + 8] and cot rows [T][OUT + 8] (ABSORB: and the gathered c2
// rows [T][OUT + 8]), all bf16 with 16 bytes of pad a row, so the 8 rows
// of an ldmatrix fall in 8 bank groups; ABSORB adds a ring of tiles of pi
// (int32) and mask (f32), four bytes an edge by cp.async, and each tile's
// grid-row base.
//
// Each tile, two products on mma.sync.m16n8k16 bf16, every fragment read
// by ldmatrix from the staged rows (the pairs the fragment layout asks,
// bf16.cuh):
// 1. dW^T [OUT, parts * d] += cot^T [OUT, T] . parts [T, parts * d]: warp
//    w owns the features f = 32 fs + 8 (w % 4) + g (the mma's n) and the
//    16-output tile w / 4 of slab os (warps 4-7 have none when OUT < 32),
//    an accumulator tile a part. A k step is 16 edges: ldmatrix.trans
//    gives the lane its u, q, i at (edges 2t, 2t + 1 and 2t + 8, 2t + 9 of
//    the step, f) and cot at the same edges for its outputs; the parts are
//    formed in bf16 from those pairs.
// 2. Slab 0: dparts [16 edges, 8 features] = cot . W^T in k steps of 16
//    outputs, a unit (8-feature block, 16 edges) a warp at a time, A from
//    the staged cot rows and B from the staged W rows; then the product
//    rule in f32 and du, dq, di rounded to bf16 into the staged output
//    rows. Threads 0 .. OUT - 1 sum db in f32, edge by edge. After a
//    barrier the block stores the tile's output rows whole, 16 bytes a
//    thread (ABSORB: di at row e_pi).
// Each accumulator sees the same products in the same order as in a form
// with one block a chunk and scalar-packed fragments (k steps in edge
// order within a chunk, outputs' k steps in order), so the bits are its.
//
// ABSORB: i and c2 through pi, the merged cotangent and the rho store of
// di (the top of the file); cot2, pi, mask (or null) and cols are unused
// without it. The pi and mask of tile k are copied with tile k - stages +
// 1's rows, so they have landed, for every thread, by the barrier before
// tile k's rows are issued; the rows then take e_pi (the tile's grid-row
// base, found once a tile when the tile lies in one grid row, plus pi)
// from shared memory, and the merge its mask.
//
// ptxas (sm_90a) at d = out = 32: order 3 128 registers (ABSORB 124),
// order 1 72 (ABSORB 128), no spills.
template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(kBf16Threads, 2)
interact_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ it,
                         const float* __restrict__ w,
                         const __nv_bfloat16* __restrict__ cot,
                         const __nv_bfloat16* __restrict__ cot2,
                         const int* __restrict__ pi,
                         const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ droles,
                         float* __restrict__ partial, int edges, int d,
                         int chunk_edges, int cols, int stages) {
  constexpr int P = parts_of<ORDER>();
  constexpr int T = kBf16Tile;
  constexpr int H = T / 16;                // 16-edge steps of a tile
  constexpr int SC = OUT + 8;              // staged cot row
  constexpr int SW = OUT + 8;              // staged W row
  constexpr int MT = OUT >= 32 ? 2 : 1;    // 16-output tiles of a slab
  constexpr int OS = (OUT + 31) / 32;      // output slabs
  constexpr int KO = (OUT + 15) / 16;      // k16 steps of the data product
  constexpr int C8 = OUT / 8;              // 16-byte vectors a cot row
  using bf16 = __nv_bfloat16;
  const int sd = d + 8;                    // staged role row
  const int R = P * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int fs = blockIdx.y / OS;
  const int os = blockIdx.y - fs * OS;
  const bool data = blockIdx.y == 0;
  const int tid = threadIdx.x;
  const int pi_slots = pi_slots_of(stages);

  extern __shared__ float4 smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);       // [R][SW], slab 0
  // slab 0: the tile's du, dq, di rows [3][T][sd], then written out whole
  bf16* obuf = ws + static_cast<size_t>(R) * SW;
  bf16* ring = obuf + 3 * T * sd;
  const int stage_elems = T * (3 * sd + SC) + (ABSORB ? T * SC : 0);
  // ABSORB: the pi and mask ring, [pi_slots][T] each, after the stages
  int* pis = reinterpret_cast<int*>(ring + stages * stage_elems);
  float* masks = reinterpret_cast<float*>(pis + pi_slots * T);

  if (data) {
    for (int idx = tid; idx < R * (OUT / 4); idx += kBf16Threads) {
      const int r = idx / (OUT / 4);
      const int v = idx - r * (OUT / 4);
      reinterpret_cast<uint2*>(ws + r * SW)[v] =
          round_bf16x4(__ldg(reinterpret_cast<const float4*>(w) + idx));
    }
  }

  // The block's stream of tiles: chunks blockIdx.x, + blocks, ... in turn,
  // each from its first edge in steps of T to its end. A Cursor follows
  // one place in that stream (the tile in use, the next to issue, the next
  // pi to copy) by additions alone; past the block's last tile its e0 is
  // `edges`.
  const int blocks = gridDim.x;
  struct Cursor {
    int c, e0, end;   // the chunk, the tile's first edge, the chunk's end
  };
  auto start_chunk = [&](Cursor& k, int c) {
    const long long b = static_cast<long long>(c) * chunk_edges;
    k.c = c;
    k.e0 = static_cast<int>(min(b, static_cast<long long>(edges)));
    k.end = static_cast<int>(
        min(b + chunk_edges, static_cast<long long>(edges)));
  };
  auto advance = [&](Cursor& k) {
    k.e0 += T;
    if (k.e0 >= k.end) start_chunk(k, k.c + blocks);
  };
  // this thread's copies of a tile, the same every tile: role rows r =
  // my_row, + rpv, ... of the 3 T, vector my_v; cot rows c_row, + CR, ...,
  // vector c_v
  const int v8 = d >> 3;
  const int rpv = kBf16Threads / v8;
  const int my_row = tid / v8;
  const int my_v = tid - my_row * v8;
  constexpr int CR = kBf16Threads / C8;
  const int c_row = tid / C8;
  const int c_v = tid - c_row * C8;
  // ABSORB: a tile's grid-row base (its first edge's row start when the
  // tile lies in one grid row, else -1), beside its pi and mask
  int* bases = reinterpret_cast<int*>(masks + pi_slots * T);

  // ABSORB: the pi, mask and base of tile kidx (at k) into its ring slot
  auto copy_pi = [&](const Cursor& k, int kidx) {
    const int n_e = min(T, k.end - k.e0);
    if (n_e <= 0) return;
    const int slot = kidx & (pi_slots - 1);
    if (tid < n_e) {
      cp_async4(pis + slot * T + tid, pi + k.e0 + tid);
    } else if (mask != nullptr && tid >= T && tid - T < n_e) {
      cp_async4(masks + slot * T + tid - T, mask + k.e0 + tid - T);
    } else if (tid == kBf16Threads - 1) {
      bases[slot] = k.e0 / cols == (k.e0 + n_e - 1) / cols
                        ? k.e0 - k.e0 % cols
                        : -1;
    }
  };

  // ABSORB: e_pi of edge e0 + te of tile kidx
  auto e_pi = [&](int kidx, int e0, int te) {
    const int slot = kidx & (pi_slots - 1);
    const int base = bases[slot];
    const int e = e0 + te;
    return (base >= 0 ? base : e - e % cols) + pis[slot * T + te];
  };

  // tile kidx (at k) into stage st
  auto issue = [&](const Cursor& k, int kidx, int st) {
    const int e0 = k.e0;
    const int n_e = min(T, k.end - e0);
    if (n_e <= 0) return;
    bf16* buf = ring + st * stage_elems;
    if (my_row < rpv) {
      for (int r = my_row; r < 3 * T; r += rpv) {
        const int a = r / T;
        const int te = r - a * T;
        const bool valid = te < n_e;
        const bf16* src = a == 0 ? u : (a == 1 ? q : it);
        int e = e0 + te;
        if (ABSORB && a == 2 && valid) e = e_pi(kidx, e0, te);
        cp_async16(buf + r * sd + 8 * my_v,
                   valid ? src + static_cast<size_t>(e) * d + 8 * my_v : u,
                   valid);
      }
    }
    for (int te = c_row; te < T; te += CR) {
      const bool valid = te < n_e;
      cp_async16(buf + 3 * T * sd + te * SC + 8 * c_v,
                 valid ? cot + static_cast<size_t>(e0 + te) * OUT + 8 * c_v
                       : cot,
                 valid);
      if constexpr (ABSORB) {
        // c2 at e_pi, copied by the thread that copies the same c1 vector
        // (it merges them)
        cp_async16(buf + 3 * T * sd + (T + te) * SC + 8 * c_v,
                   valid ? cot2 + static_cast<size_t>(e_pi(kidx, e0, te)) *
                                      OUT + 8 * c_v
                         : cot2,
                   valid);
      }
    }
  };

  // ABSORB: this thread's c1 vectors of tile kidx (stage st), merged with
  // the c2 vectors it copied: round_bf16(c1 + c2), then times the mask
  auto merge = [&](int st, int kidx, int n_e) {
    bf16* cs = ring + st * stage_elems + 3 * T * sd;
    const bf16* c2s = cs + T * SC;
    const float* ms = masks + (kidx & (pi_slots - 1)) * T;
    for (int te = c_row; te < n_e; te += CR) {
      const int at = te * SC + 8 * c_v;
      const float mv = mask != nullptr ? ms[te] : 1.f;
      uint4 x = *reinterpret_cast<const uint4*>(cs + at);
      const uint4 y = *reinterpret_cast<const uint4*>(c2s + at);
      unsigned* xs = reinterpret_cast<unsigned*>(&x);
      const unsigned* ys = reinterpret_cast<const unsigned*>(&y);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 a = __bfloat1622float2(bits_bf16x2(xs[c]));
        const float2 b = __bfloat1622float2(bits_bf16x2(ys[c]));
        const float2 r = __bfloat1622float2(
            __floats2bfloat162_rn(a.x + b.x, a.y + b.y));
        xs[c] = pack_bf16(r.x * mv, r.y * mv);
      }
      *reinterpret_cast<uint4*>(cs + at) = x;
    }
  };

  auto wait_stages = [&]() {   // tile k's group (and all before) landed
    if (stages == 4) cp_async_wait<2>();
    else if (stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
  };

  // product 1: this warp's features and output tile, and accumulators
  const int F2 = 32 * fs + 8 * (warp & 3);
  const int mm = warp >> 2;
  const int o2 = 32 * os + 16 * mm;        // the tile's first output
  const bool has2 = F2 < d && mm < MT;
  float acc[P][4];
#pragma unroll
  for (int j = 0; j < P; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float bacc = 0.f;
  const size_t plane = static_cast<size_t>(edges) * d;
  // the staged row (within a 16-row step) and column offset of this lane's
  // ldmatrix address: matrix l / 8, row l % 8
  const int lrow = lane & 7;
  const int lmat = lane >> 3;

  Cursor cur, nxt, pic;   // the tile in use, the next to issue, next pi
  start_chunk(cur, blockIdx.x);
  nxt = pic = cur;
  if constexpr (ABSORB) {
    for (int k = 0; k < stages - 1; ++k) {
      copy_pi(pic, k);
      advance(pic);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int k = 0; k < stages - 1; ++k) {
    issue(nxt, k, k);
    advance(nxt);
    if (ABSORB) {
      copy_pi(pic, k + stages - 1);
      advance(pic);
    }
    cp_async_commit();
  }

  for (int tile = 0, st = 0; cur.e0 < edges; ++tile) {
    const int e0 = cur.e0;
    const int n_e = min(T, cur.end - e0);
    wait_stages();
    // ABSORB: the tile has landed for this thread, which merges what it
    // copied
    if (ABSORB) merge(st, tile, n_e);
    __syncthreads();  // the tile (and W, the ring's pi) has landed for all
    issue(nxt, tile + stages - 1, st == 0 ? stages - 1 : st - 1);
    advance(nxt);
    if (ABSORB) {
      copy_pi(pic, tile + 2 * stages - 2);
      advance(pic);
    }
    cp_async_commit();
    const bf16* us = ring + st * stage_elems;
    const bf16* qs = us + T * sd;
    const bf16* is = qs + T * sd;
    const bf16* cs = is + T * sd;

    // 1. dW^T += cot^T . parts, 16 edges a k step
    if (has2) {
#pragma unroll
      for (int ks = 0; ks < H; ++ks) {
        // u and q (matrices 0, 1 and 2, 3: edges 0-7 and 8-15 of the step),
        // i (lanes 0-15); x[h], y[h], z[h] hold edges 2t, 2t + 1 (h = 0)
        // and 2t + 8, 2t + 9 (h = 1) at feature F2 + g
        const int er = 16 * ks + lrow + 8 * (lmat & 1);
        unsigned uq[4], iv[2];
        ldsm_x4_t(uq, (lmat < 2 ? us : qs) + er * sd + F2);
        ldsm_x2_t(iv, is + er * sd + F2);
        __nv_bfloat162 x[2] = {bits_bf16x2(uq[0]), bits_bf16x2(uq[1])};
        __nv_bfloat162 y[2] = {bits_bf16x2(uq[2]), bits_bf16x2(uq[3])};
        __nv_bfloat162 z[2] = {bits_bf16x2(iv[0]), bits_bf16x2(iv[1])};
        unsigned bp[P][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bp[0][h] = bf16x2_bits(x[h]);
          bp[1][h] = bf16x2_bits(y[h]);
          bp[2][h] = bf16x2_bits(z[h]);
          if constexpr (P >= 6) {
            const __nv_bfloat162 uq2 = __hmul2(x[h], y[h]);
            bp[3][h] = bf16x2_bits(uq2);
            bp[4][h] = bf16x2_bits(__hmul2(y[h], z[h]));
            bp[5][h] = bf16x2_bits(__hmul2(z[h], x[h]));
            if constexpr (P >= 7) bp[6][h] = bf16x2_bits(__hmul2(uq2, z[h]));
          }
        }
        // A = cot^T: matrices (edges 0-7, outputs o2 .. o2 + 7), (0-7,
        // o2 + 8 ..), (8-15, o2 ..), (8-15, o2 + 8 ..); outputs past OUT
        // (OUT = 8) are zero
        unsigned a[4];
        ldsm_x4_t(a, cs + (16 * ks + lrow + 8 * (lmat >> 1)) * SC + o2 +
                         8 * (lmat & 1));
        if (o2 + 8 >= OUT) a[1] = a[3] = 0u;
#pragma unroll
        for (int j = 0; j < P; ++j) mma_bf16(acc[j], a, bp[j][0], bp[j][1]);
      }
    }

    // 2. the data gradient (slab 0): units of (8-feature block, half tile)
    if (data) {
      for (int unit = warp; unit < H * v8; unit += kBf16Warps) {
        const int F1 = 8 * (unit / H);
        const int mt = unit - H * (unit / H);
        float dp[P][4];
#pragma unroll
        for (int j = 0; j < P; ++j)
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KO; ++kk) {
          // A = cot: matrices (edges 0-7, outputs 16 kk ..), (8-15, 16 kk
          // ..), (0-7, 16 kk + 8 ..), (8-15, 16 kk + 8 ..) of the half
          const bool up = 16 * kk + 8 < OUT;    // outputs 16 kk + 8 .. exist
          unsigned a[4];
          ldsm_x4(a, cs + (16 * mt + lrow + 8 * (lmat & 1)) * SC + 16 * kk +
                         8 * (lmat >> 1));
          if (!up) a[2] = a[3] = 0u;
          // B = W^T: rows j d + F1 .. + 7, outputs 16 kk .. (b0) and
          // 16 kk + 8 .. (b1), two parts an ldmatrix
#pragma unroll
          for (int j = 0; j < P; j += 2) {
            if (j + 1 < P) {
              unsigned b[4];
              ldsm_x4(b, ws + static_cast<size_t>((j + (lmat >> 1)) * d +
                                                  F1 + lrow) * SW +
                             16 * kk + 8 * (lmat & 1));
              mma_bf16(dp[j], a, b[0], up ? b[1] : 0u);
              mma_bf16(dp[j + 1], a, b[2], up ? b[3] : 0u);
            } else {
              unsigned b[2];
              ldsm_x2(b, ws + static_cast<size_t>(j * d + F1 + lrow) * SW +
                             16 * kk + 8 * (lmat & 1));
              mma_bf16(dp[j], a, b[0], up ? b[1] : 0u);
            }
          }
        }
        // the product rule in f32 (interact.py:111-122), at features f,
        // f + 1 of edges 16 mt + g and 16 mt + g + 8
        const int f = F1 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int te = 16 * mt + g + 8 * h;
          if (te >= n_e) continue;
          const int at_s = te * sd + f;
          const float2 uu = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(us + at_s));
          const float2 qq = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qs + at_s));
          const float2 ii = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(is + at_s));
          float gu[2], gq[2], gi[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = c ? uu.y : uu.x;
            const float y = c ? qq.y : qq.x;
            const float z = c ? ii.y : ii.x;
            float du = dp[0][2 * h + c], dq = dp[1][2 * h + c],
                  di = dp[2][2 * h + c];
            if constexpr (P >= 6) {
              du += dp[3][2 * h + c] * y + dp[5][2 * h + c] * z;
              dq += dp[3][2 * h + c] * x + dp[4][2 * h + c] * z;
              di += dp[4][2 * h + c] * y + dp[5][2 * h + c] * x;
            }
            if constexpr (P >= 7) {
              du += dp[6][2 * h + c] * (y * z);
              dq += dp[6][2 * h + c] * (x * z);
              di += dp[6][2 * h + c] * (x * y);
            }
            gu[c] = du;
            gq[c] = dq;
            gi[c] = di;
          }
          bf16* ob = obuf + at_s;
          *reinterpret_cast<unsigned*>(ob) = pack_bf16(gu[0], gu[1]);
          *reinterpret_cast<unsigned*>(ob + T * sd) = pack_bf16(gq[0], gq[1]);
          *reinterpret_cast<unsigned*>(ob + 2 * T * sd) =
              pack_bf16(gi[0], gi[1]);
        }
      }
      if (threadIdx.x < OUT) {
        if (n_e == T) {
#pragma unroll
          for (int te = 0; te < T; ++te)
            bacc += __bfloat162float(cs[te * SC + threadIdx.x]);
        } else {
          for (int te = 0; te < n_e; ++te)
            bacc += __bfloat162float(cs[te * SC + threadIdx.x]);
        }
      }
      __syncthreads();  // the tile's du, dq, di rows are staged
      // whole rows out, 16 bytes a thread, as the roles came in (ABSORB:
      // di at row e_pi)
      if (my_row < rpv) {
        for (int r = my_row; r < 3 * T; r += rpv) {
          const int a = r / T;
          const int te = r - a * T;
          if (te >= n_e) continue;
          const int row = ABSORB && a == 2 ? e_pi(tile, e0, te) : e0 + te;
          *reinterpret_cast<uint4*>(droles + a * plane +
                                    static_cast<size_t>(row) * d +
                                    8 * my_v) =
              *reinterpret_cast<const uint4*>(obuf + r * sd + 8 * my_v);
        }
      }
    }

    // the chunk's last tile: its partial, then fresh accumulators
    if (e0 + T >= cur.end) {
      float* out = partial + static_cast<size_t>(cur.c) * (R + 1) * OUT;
      if (has2) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int r = j * d + F2 + 2 * t;
          const int o = o2 + g;
          if (o < OUT) {
            out[static_cast<size_t>(r) * OUT + o] = acc[j][0];
            out[static_cast<size_t>(r + 1) * OUT + o] = acc[j][1];
          }
          if (o + 8 < OUT) {
            out[static_cast<size_t>(r) * OUT + o + 8] = acc[j][2];
            out[static_cast<size_t>(r + 1) * OUT + o + 8] = acc[j][3];
          }
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        }
      }
      if (data && threadIdx.x < OUT)
        out[static_cast<size_t>(R) * OUT + threadIdx.x] = bacc;
      bacc = 0.f;
    }
    advance(cur);
    st = st + 1 == stages ? 0 : st + 1;
  }
}

// ABSORB: cot2, pi, mask (or null) and cols as above; else all unused.
struct Absorb {
  const void* cot2;
  const void* pi;
  const void* mask;
  int cols;
};

// out [n] = the fixed-order sum of partial [chunks, n] over chunks
cudaError_t reduce_partials(const void* partial, void* out, int chunks,
                            int n, cudaStream_t stream) {
  reduce_partials_kernel<<<(n + kReduceOut - 1) / kReduceOut,
                           kReduceOut * kReduceLanes, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), chunks,
      n);
  return cudaGetLastError();
}

int chunk_count(int edges, int chunk_edges) {
  return static_cast<int>((static_cast<long long>(edges) + chunk_edges - 1) /
                          chunk_edges);
}

// The fused kernel, then the sum over chunks. W is staged when it fits
// beside the two stages; a shape whose two stages alone do not fit in one
// block's shared memory is refused before anything is launched.
template <int OUT, int ORDER, bool ABSORB, bool WS>
cudaError_t launch_kernel(const void* u, const void* q, const void* i,
                          const void* w, const void* cot, Absorb ab,
                          void* droles, void* partial, int edges, int d,
                          int chunk_edges, size_t smem, cudaStream_t stream) {
  auto kernel = fused_kernel<OUT, ORDER, ABSORB, WS>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it as the return value
    return err;
  }
  const int slabs = ((d + 31) / 32) * ((OUT + 31) / 32);
  kernel<<<dim3(chunk_count(edges, chunk_edges), slabs), kFusedThreads, smem,
           stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(q),
      static_cast<const float*>(i), static_cast<const float*>(w),
      static_cast<const float*>(cot), static_cast<const float*>(ab.cot2),
      static_cast<const int*>(ab.pi), static_cast<const float*>(ab.mask),
      static_cast<float*>(droles), static_cast<float*>(partial), edges, d,
      chunk_edges, ab.cols);
  return cudaGetLastError();
}

template <int OUT, int ORDER, bool ABSORB>
cudaError_t launch(const void* u, const void* q, const void* i, const void* w,
                   const void* cot, Absorb ab, void* droles, void* partial,
                   void* dw_ext, int edges, int d, int chunk_edges,
                   cudaStream_t stream) {
  constexpr int P = parts_of<ORDER>();
  constexpr int SW = OUT <= 32 ? 36 : 68;
  const int R = P * d;
  // two stages; ABSORB: one stage with the rows' e_pi, and the c2 plane
  const size_t stage_bytes =
      static_cast<size_t>(kFusedTile) * sizeof(float) *
      (ABSORB ? 3 * (d + 8) + OUT + 8 + 1 + OUT
              : 2 * (3 * (d + 8) + OUT + 8));
  const size_t w_bytes = static_cast<size_t>(R) * SW * sizeof(float);
  if (stage_bytes > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t err =
      stage_bytes + w_bytes <= kSmemLimit
          ? launch_kernel<OUT, ORDER, ABSORB, true>(
                u, q, i, w, cot, ab, droles, partial, edges, d, chunk_edges,
                stage_bytes + w_bytes, stream)
          : launch_kernel<OUT, ORDER, ABSORB, false>(
                u, q, i, w, cot, ab, droles, partial, edges, d, chunk_edges,
                stage_bytes, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, dw_ext, chunk_count(edges, chunk_edges),
                         (R + 1) * OUT, stream);
}

template <int OUT, bool ABSORB>
cudaError_t launch_order(int order, const void* u, const void* q,
                         const void* i, const void* w, const void* cot,
                         Absorb ab, void* droles, void* partial, void* dw_ext,
                         int edges, int d, int chunk_edges,
                         cudaStream_t stream) {
  switch (order) {
    case 1: return launch<OUT, 1, ABSORB>(u, q, i, w, cot, ab, droles,
                                          partial, dw_ext, edges, d,
                                          chunk_edges, stream);
    case 2: return launch<OUT, 2, ABSORB>(u, q, i, w, cot, ab, droles,
                                          partial, dw_ext, edges, d,
                                          chunk_edges, stream);
    case 3: return launch<OUT, 3, ABSORB>(u, q, i, w, cot, ab, droles,
                                          partial, dw_ext, edges, d,
                                          chunk_edges, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ABSORB>
int launch_out(const void* u, const void* q, const void* i, const void* w,
               const void* cot, Absorb ab, void* droles, void* partial,
               void* dw_ext, int edges, int d, int out_dim, int order,
               int chunk_edges, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (edges <= 0 || chunk_edges <= 0 || chunk_edges % kFusedTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (out_dim) {
    case 8: err = launch_order<8, ABSORB>(order, u, q, i, w, cot, ab, droles,
                                          partial, dw_ext, edges, d,
                                          chunk_edges, s); break;
    case 16: err = launch_order<16, ABSORB>(order, u, q, i, w, cot, ab,
                                            droles, partial, dw_ext, edges, d,
                                            chunk_edges, s); break;
    case 32: err = launch_order<32, ABSORB>(order, u, q, i, w, cot, ab,
                                            droles, partial, dw_ext, edges, d,
                                            chunk_edges, s); break;
    case 64: err = launch_order<64, ABSORB>(order, u, q, i, w, cot, ab,
                                            droles, partial, dw_ext, edges, d,
                                            chunk_edges, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// The bf16 form's shared memory with `stages` stages: W [parts * d][OUT +
// 8] and the stages, all bf16 (ABSORB: each stage with its c2 plane, and
// the pi and mask ring, pi_slots_of(stages) tiles of 8 bytes an edge and
// a base each).
size_t bf16_smem(int d, int out, int parts, bool absorb, int stages) {
  return sizeof(__nv_bfloat16) *
             (static_cast<size_t>(parts) * d * (out + 8) +
              3 * static_cast<size_t>(kBf16Tile) * (d + 8) +
              static_cast<size_t>(stages) * kBf16Tile *
                  (3 * (d + 8) + out + 8 + (absorb ? out + 8 : 0))) +
         (absorb ? static_cast<size_t>(pi_slots_of(stages)) *
                       (kBf16Tile * 8 + sizeof(int))
                 : 0);
}

// The deepest ring (4 stages, else 3, else 2) whose shared memory fits in
// one block; the grid as many blocks a slab as the card holds at once, at
// most one a chunk.
template <int OUT, int ORDER, bool ABSORB>
cudaError_t launch_bf16(const void* u, const void* q, const void* i,
                        const void* w, const void* cot, Absorb ab,
                        void* droles, void* partial, void* dw_ext, int edges,
                        int d, int chunk_edges, cudaStream_t stream) {
  constexpr int P = parts_of<ORDER>();
  if (d % 8 != 0) return cudaErrorInvalidValue;
  // the deepest ring (4 stages down to 2) that leaves room for three
  // blocks an SM, else two, else the deepest that fits in one block
  int stages = 0;
  for (int per_sm = 3; per_sm >= 1 && stages == 0; --per_sm) {
    for (int s = kBf16MaxStages; s >= 2 && stages == 0; --s) {
      if (per_sm * (bf16_smem(d, OUT, P, ABSORB, s) + kSmemReserved) <=
          kSmemPerSm)
        stages = s;
    }
  }
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t smem = bf16_smem(d, OUT, P, ABSORB, stages);
  auto kernel = interact_bwd_bf16_kernel<OUT, ORDER, ABSORB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kBf16Threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it as the return value
    return err;
  }
  const int slabs = ((d + 31) / 32) * ((OUT + 31) / 32);
  const int chunks = chunk_count(edges, chunk_edges);
  const int blocks = std::max(1, std::min(chunks, per_sm * sms / slabs));
  kernel<<<dim3(blocks, slabs), kBf16Threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(i), static_cast<const float*>(w),
      static_cast<const __nv_bfloat16*>(cot),
      static_cast<const __nv_bfloat16*>(ab.cot2),
      static_cast<const int*>(ab.pi), static_cast<const float*>(ab.mask),
      static_cast<__nv_bfloat16*>(droles), static_cast<float*>(partial),
      edges, d, chunk_edges, ab.cols, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, dw_ext, chunks, (P * d + 1) * OUT, stream);
}

template <int OUT, bool ABSORB>
cudaError_t launch_bf16_order(int order, const void* u, const void* q,
                              const void* i, const void* w, const void* cot,
                              Absorb ab, void* droles, void* partial,
                              void* dw_ext, int edges, int d,
                              int chunk_edges, cudaStream_t stream) {
  switch (order) {
    case 1: return launch_bf16<OUT, 1, ABSORB>(u, q, i, w, cot, ab, droles,
                                               partial, dw_ext, edges, d,
                                               chunk_edges, stream);
    case 2: return launch_bf16<OUT, 2, ABSORB>(u, q, i, w, cot, ab, droles,
                                               partial, dw_ext, edges, d,
                                               chunk_edges, stream);
    case 3: return launch_bf16<OUT, 3, ABSORB>(u, q, i, w, cot, ab, droles,
                                               partial, dw_ext, edges, d,
                                               chunk_edges, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ABSORB>
int launch_bf16_out(const void* u, const void* q, const void* i,
                    const void* w, const void* cot, Absorb ab, void* droles,
                    void* partial, void* dw_ext, int edges, int d,
                    int out_dim, int order, int chunk_edges, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (edges <= 0 || chunk_edges <= 0 || chunk_edges % kFusedTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (out_dim) {
    case 8: err = launch_bf16_order<8, ABSORB>(order, u, q, i, w, cot, ab,
                                               droles, partial, dw_ext, edges,
                                               d, chunk_edges, s); break;
    case 16: err = launch_bf16_order<16, ABSORB>(order, u, q, i, w, cot, ab,
                                                 droles, partial, dw_ext,
                                                 edges, d, chunk_edges, s);
      break;
    case 32: err = launch_bf16_order<32, ABSORB>(order, u, q, i, w, cot, ab,
                                                 droles, partial, dw_ext,
                                                 edges, d, chunk_edges, s);
      break;
    case 64: err = launch_bf16_order<64, ABSORB>(order, u, q, i, w, cot, ab,
                                                 droles, partial, dw_ext,
                                                 edges, d, chunk_edges, s);
      break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [n] = the fixed-order sum over chunks of partial [chunks, n], the
// second kernel of every entry point below (for timing it apart).
extern "C" int ihgnn_reduce_partials(const void* partial, void* out,
                                     int chunks, int n, void* stream) {
  return static_cast<int>(reduce_partials(
      partial, out, chunks, n, static_cast<cudaStream_t>(stream)));
}

extern "C" int ihgnn_interact_bwd(const void* u, const void* q, const void* i,
                                  const void* w, const void* cot, void* droles,
                                  void* partial, void* dw_ext, int edges,
                                  int d, int out_dim, int order,
                                  int chunk_edges, void* stream) {
  return launch_out<false>(u, q, i, w, cot, Absorb{nullptr, nullptr, nullptr,
                                                   1},
                           droles, partial, dw_ext, edges, d, out_dim, order,
                           chunk_edges, stream);
}

// K5 backward: i_t1 and cot2 read through pi [edges / cols, cols], the
// merged cotangent masked by mask [edges] (or null); droles plane 2 is di
// for i_t1.
extern "C" int ihgnn_interact_bwd_absorb(
    const void* u, const void* q, const void* i_t1, const void* pi,
    const void* w, const void* cot1, const void* cot2, const void* mask,
    void* droles, void* partial, void* dw_ext, int edges, int d, int out_dim,
    int order, int cols, int chunk_edges, void* stream) {
  if (cols <= 0 || edges % cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_out<true>(u, q, i_t1, w, cot1, Absorb{cot2, pi, mask, cols},
                          droles, partial, dw_ext, edges, d, out_dim, order,
                          chunk_edges, stream);
}

// The bf16 form: u/q/i [edges, d] bf16, W [parts * d, out_dim] f32, cot
// [edges, out_dim] bf16; droles [3, edges, d] bf16, partial and dw_ext f32
// as ihgnn_interact_bwd. Refused (cudaErrorInvalidValue) for d % 8 != 0 or
// when W, the staged output rows and two stages do not fit in one block's
// shared memory (bf16_smem).
extern "C" int ihgnn_interact_bwd_bf16(const void* u, const void* q,
                                       const void* i, const void* w,
                                       const void* cot, void* droles,
                                       void* partial, void* dw_ext, int edges,
                                       int d, int out_dim, int order,
                                       int chunk_edges, void* stream) {
  return launch_bf16_out<false>(u, q, i, w, cot,
                                Absorb{nullptr, nullptr, nullptr, 1}, droles,
                                partial, dw_ext, edges, d, out_dim, order,
                                chunk_edges, stream);
}

// K5 backward's bf16 form: u/q/i_t1, cot1 and cot2 bf16, pi, mask (f32 or
// null) and cols as ihgnn_interact_bwd_absorb; droles bf16, partial and
// dw_ext f32. Refused as ihgnn_interact_bwd_bf16 is.
extern "C" int ihgnn_interact_bwd_absorb_bf16(
    const void* u, const void* q, const void* i_t1, const void* pi,
    const void* w, const void* cot1, const void* cot2, const void* mask,
    void* droles, void* partial, void* dw_ext, int edges, int d, int out_dim,
    int order, int cols, int chunk_edges, void* stream) {
  if (cols <= 0 || edges % cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16_out<true>(u, q, i_t1, w, cot1,
                               Absorb{cot2, pi, mask, cols}, droles, partial,
                               dw_ext, edges, d, out_dim, order, chunk_edges,
                               stream);
}
