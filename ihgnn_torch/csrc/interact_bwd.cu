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
// bf16 x bf16 product is exact in f32, so no split. The design is the
// direct fused kernel's, in bf16: the same chunks, tiles and slabs, the
// same fixed-order partials and reduce_partials_kernel (so a step repeats
// bit for bit), W rounded to bf16 once a block into shared memory, and
// tiles of bf16 rows staged by cp.async. Each k step of the dW product is
// 16 edges, whose pairs (edges 2 t, 2 t + 1 and 2 t + 8, 2 t + 9 of the
// step) are packed from two staged rows; each k step of the data product
// is 16 outputs, whose pairs are neighbours in a staged cot row and a W
// row. It takes d % 8 == 0 when W and the two stages fit in one block's
// shared memory. Bound: bytes. At order 3, E = 2M, d = out = 32 it reads
// u, q, i and cot (4 x 128 MB) and writes du, dq, di (3 x 128 MB): 0.27 ms
// at 3.35 TB/s; the two products' 28,672 FLOPs an edge take 0.058 ms at
// the 989 TFLOP/s bf16 rate.
//
// The bf16 form with ABSORB (K5's backward on the routed pack's bf16
// streams, _bwd_kernel_absorb on bf16 operands, interact.py:203-227): the
// i row of edge e staged from i_t1[e_pi], c2[e_pi] staged beside c1[e] in
// a plane of its own, and the merged cotangent formed as Pallas forms it,
// in bf16: cot = round_bf16(c1 + c2) (one rounding of the exact f32 sum of
// two bf16 values), then times the mask (0 or 1, exact). The merge runs in
// shared memory, each thread on the vectors it copied, before the barrier
// that shows the tile to all, so the dW product, the data product and db
// all read the one rounded bf16 cotangent; di is stored at e_pi. Two
// stages, as the direct bf16 form, each with its c2 plane; the chunk's
// e_pi and mask are read once into shared memory. On the edges of one
// [R, C] grid it is bit for bit the direct bf16 form on the pre-permuted
// inputs. Bound: bytes, the direct bf16 form's
// plus c2 (128 MB at the routed pack's 2,097,152 edges), pi and the mask.

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kReduceOut = 32;   // outputs a reduce block owns
constexpr int kReduceLanes = 16; // chunk lanes of a reduce block
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

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
__global__ void __launch_bounds__(kFusedThreads)
interact_bwd_fused_kernel(const float* __restrict__ u,
                          const float* __restrict__ q,
                          const float* __restrict__ it,
                          const float* __restrict__ w,
                          const float* __restrict__ cot,
                          const float* __restrict__ cot2,
                          const int* __restrict__ pi,
                          const float* __restrict__ mask,
                          float* __restrict__ droles,
                          float* __restrict__ partial, int edges, int d,
                          int chunk_edges, int cols) {
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

    // 1. dW^T += cot^T . parts, 8 edges a k step
    if (has2) {
      const int f = F2 + g;
      const bool fv = f < d;
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
          mma_3xtf32<P>(acc[m], ah, al, bh, bl);
        }
      }
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

// ---------------------------------------------------------------------------
// The bf16 form (interact_bwd on bf16 streams)
// ---------------------------------------------------------------------------
//
// grid (chunks, slabs), kFusedThreads threads, as the fused kernel above.
// Shared memory: W rounded to bf16 [parts * d][OUT + 8] (slab 0), then two
// stages of u, q, i rows [kFusedTile][d + 8] and cot rows [kFusedTile][OUT
// + 8], all bf16 (16 bytes of pad a row); ABSORB adds to each stage the
// gathered c2 rows [kFusedTile][OUT + 8], and after the two stages the
// chunk's e_pi (int32) and mask (f32), chunk_edges each.
//
// 1. dW^T [OUT, parts * d] += cot^T [OUT, T] . parts [T, parts * d]: warp w
//    owns the features f = 32 fs + 8 w + g (the mma's n) and, for each
//    16-output tile of slab os, an accumulator tile a part, as above. A k
//    step is 16 edges: the lane's edges e = 16 ks + 2 t, + 1, + 8, + 9; its
//    B pairs are the parts at (e, f) and its A pairs cot at (e, o), packed
//    from two rows.
// 2. Slab 0: dparts [16 edges, 8 features] = cot . W^T, k steps of 16
//    outputs: A pairs from a staged cot row, B pairs from a staged W row;
//    then the product rule in f32 and du, dq, di rounded to bf16, 4 bytes
//    a store (ABSORB: di at row e_pi). Slab 0 also sums db in f32.
//
// ABSORB: i and c2 through pi, the merged cotangent and the rho store of
// di (the top of the file); cot2, pi, mask (or null) and cols are unused
// without it. Before its first tile a block reads its chunk's slice of pi
// and of the mask once, turns each pi into e_pi (the grid row's first edge
// plus pi, the row found once for a chunk inside one grid row, else an
// edge at a time) and keeps both in shared memory, so every tile's i and
// c2 copies, the merge's mask and the di rows take their addresses from
// shared memory and no copy waits on a load of pi.
//
// Shared memory and registers a block at order 3, d = out = 32 (ptxas,
// sm_90a): the direct form 38,400 bytes and 160 registers a thread;
// ABSORB 51,712 bytes and 164 registers, where the design that read pi
// for each copy took 43,776 bytes and 158 registers (the chunk's 8,192
// bytes of e_pi and mask replace each stage's 128 bytes of e_pi). Both
// forms run 3 blocks an SM (12 warps), bound by registers, before and
// after.
template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(kFusedThreads)
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
                         int chunk_edges, int cols) {
  constexpr int P = parts_of<ORDER>();
  constexpr int T = kFusedTile;
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

  extern __shared__ float4 smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);       // [R][SW], slab 0
  bf16* stages = ws + (data ? static_cast<size_t>(R) * SW : 0);
  // a stage: u, q, i rows [T][sd] and cot rows [T][SC]; ABSORB adds the
  // gathered c2 rows [T][SC]
  const int stage_elems = T * (3 * sd + SC) + (ABSORB ? T * SC : 0);
  // ABSORB: the chunk's e_pi and mask, after the two stages
  int* epis = reinterpret_cast<int*>(stages + 2 * stage_elems);
  float* masks = reinterpret_cast<float*>(epis + chunk_edges);

  if (data) {
    for (int idx = threadIdx.x; idx < R * (OUT / 4); idx += kFusedThreads) {
      const int r = idx / (OUT / 4);
      const int v = idx - r * (OUT / 4);
      reinterpret_cast<uint2*>(ws + r * SW)[v] =
          round_bf16x4(__ldg(reinterpret_cast<const float4*>(w) + idx));
    }
  }

  const long long begin = static_cast<long long>(blockIdx.x) * chunk_edges;
  const int e_begin = static_cast<int>(begin);
  const int e_end = static_cast<int>(
      begin + chunk_edges < edges ? begin + chunk_edges : edges);
  const int tiles = (e_end - e_begin + T - 1) / T;
  const int v8 = d >> 3;

  if constexpr (ABSORB) {
    // the chunk's e_pi and mask, read once; a chunk inside one grid row
    // finds the row's first edge once
    const bool one_row = e_begin / cols == (e_end - 1) / cols;
    const int row_base = e_begin - e_begin % cols;
    for (int te = threadIdx.x; te < e_end - e_begin; te += kFusedThreads) {
      const int e = e_begin + te;
      epis[te] = (one_row ? row_base : e - e % cols) + __ldg(pi + e);
      masks[te] = mask != nullptr ? __ldg(mask + e) : 1.f;
    }
    __syncthreads();
  }

  auto issue = [&](int tile) {
    bf16* buf = stages + (tile & 1) * stage_elems;
    const int t0 = tile * T;                // the tile's first chunk edge
    const int e0 = e_begin + t0;
    const int n_e = min(T, e_end - e0);
    for (int idx = threadIdx.x; idx < 3 * T * v8; idx += kFusedThreads) {
      const int a = idx / (T * v8);
      const int rem = idx - a * T * v8;
      const int te = rem / v8;
      const int v = rem - te * v8;
      const bool valid = te < n_e;
      const bf16* src = a == 0 ? u : (a == 1 ? q : it);
      int e = e0 + te;
      if (ABSORB && a == 2 && valid) e = epis[t0 + te];
      cp_async16(buf + (a * T + te) * sd + 8 * v,
                 valid ? src + static_cast<size_t>(e) * d + 8 * v : u,
                 valid);
    }
    for (int idx = threadIdx.x; idx < T * C8; idx += kFusedThreads) {
      const int te = idx / C8;
      const int v = idx - te * C8;
      const bool valid = te < n_e;
      cp_async16(buf + 3 * T * sd + te * SC + 8 * v,
                 valid ? cot + static_cast<size_t>(e0 + te) * OUT + 8 * v
                       : cot,
                 valid);
      if constexpr (ABSORB) {
        // c2 at e_pi, copied by the thread that copies the same c1 vector
        // (it merges them)
        cp_async16(buf + 3 * T * sd + (T + te) * SC + 8 * v,
                   valid ? cot2 + static_cast<size_t>(epis[t0 + te]) * OUT +
                               8 * v
                         : cot2,
                   valid);
      }
    }
    cp_async_commit();
  };

  // ABSORB: this thread's c1 vectors of the tile, merged with the c2
  // vectors it copied: round_bf16(c1 + c2), then times the mask
  auto merge = [&](bf16* buf, int t0, int n_e) {
    bf16* cs = buf + 3 * T * sd;
    const bf16* c2s = cs + T * SC;
    for (int idx = threadIdx.x; idx < T * C8; idx += kFusedThreads) {
      const int te = idx / C8;
      if (te >= n_e) continue;
      const int at = te * SC + 8 * (idx - te * C8);
      const float m = masks[t0 + te];
      uint4 x = *reinterpret_cast<const uint4*>(cs + at);
      const uint4 y = *reinterpret_cast<const uint4*>(c2s + at);
      unsigned* xs = reinterpret_cast<unsigned*>(&x);
      const unsigned* ys = reinterpret_cast<const unsigned*>(&y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 a = __bfloat1622float2(bits_bf16x2(xs[k]));
        const float2 c = __bfloat1622float2(bits_bf16x2(ys[k]));
        const float2 r = __bfloat1622float2(
            __floats2bfloat162_rn(a.x + c.x, a.y + c.y));
        xs[k] = pack_bf16(r.x * m, r.y * m);
      }
      *reinterpret_cast<uint4*>(cs + at) = x;
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
  const bf16 zero = __float2bfloat16_rn(0.f);

  if (tiles > 0) issue(0);
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * T;
    const int e0 = e_begin + t0;
    const int n_e = min(T, e_end - e0);
    if (tile + 1 < tiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // ABSORB: the tile has landed for this thread, which merges what it
    // copied
    if (ABSORB) merge(stages + (tile & 1) * stage_elems, t0, n_e);
    __syncthreads();  // the tile (and W) has landed for every thread
    const bf16* us = stages + (tile & 1) * stage_elems;
    const bf16* qs = us + T * sd;
    const bf16* is = qs + T * sd;
    const bf16* cs = is + T * sd;

    // 1. dW^T += cot^T . parts, 16 edges a k step
    if (has2) {
      const int f = F2 + g;
      const bool fv = f < d;
#pragma unroll
      for (int ks = 0; ks < T / 16; ++ks) {
        // the lane's edges: k = 2 t, 2 t + 1 (pair 0), 2 t + 8, 2 t + 9
        // (pair 1)
        const int ea = 16 * ks + 2 * t;
        const int ek[4] = {ea, ea + 1, ea + 8, ea + 9};
        __nv_bfloat162 x[2], y[2], z[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e_lo = ek[2 * h], e_hi = ek[2 * h + 1];
          x[h] = __halves2bfloat162(fv ? us[e_lo * sd + f] : zero,
                                    fv ? us[e_hi * sd + f] : zero);
          y[h] = __halves2bfloat162(fv ? qs[e_lo * sd + f] : zero,
                                    fv ? qs[e_hi * sd + f] : zero);
          z[h] = __halves2bfloat162(fv ? is[e_lo * sd + f] : zero,
                                    fv ? is[e_hi * sd + f] : zero);
        }
        unsigned bp[P][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bp[0][h] = bf16x2_bits(x[h]);
          bp[1][h] = bf16x2_bits(y[h]);
          bp[2][h] = bf16x2_bits(z[h]);
          if constexpr (P >= 6) {
            const __nv_bfloat162 uq = __hmul2(x[h], y[h]);
            bp[3][h] = bf16x2_bits(uq);
            bp[4][h] = bf16x2_bits(__hmul2(y[h], z[h]));
            bp[5][h] = bf16x2_bits(__hmul2(z[h], x[h]));
            if constexpr (P >= 7) bp[6][h] = bf16x2_bits(__hmul2(uq, z[h]));
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int o = 32 * os + 16 * m + g;
          auto c_at = [&](int e, int oo) {
            return oo < OUT ? cs[e * SC + oo] : zero;
          };
          const unsigned a[4] = {
              pack_bf16(c_at(ek[0], o), c_at(ek[1], o)),
              pack_bf16(c_at(ek[0], o + 8), c_at(ek[1], o + 8)),
              pack_bf16(c_at(ek[2], o), c_at(ek[3], o)),
              pack_bf16(c_at(ek[2], o + 8), c_at(ek[3], o + 8))};
#pragma unroll
          for (int j = 0; j < P; ++j)
            mma_bf16(acc[m][j], a, bp[j][0], bp[j][1]);
        }
      }
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
          const bf16* c_lo = cs + (16 * mt + g) * SC;
          const bf16* c_hi = c_lo + 8 * SC;
#pragma unroll
          for (int kk = 0; kk < KO; ++kk) {
            const int o = 16 * kk + 2 * t;
            const bool up = o + 8 < OUT;    // outputs o + 8, o + 9 exist
            const unsigned a[4] = {
                *reinterpret_cast<const unsigned*>(c_lo + o),
                *reinterpret_cast<const unsigned*>(c_hi + o),
                up ? *reinterpret_cast<const unsigned*>(c_lo + o + 8) : 0u,
                up ? *reinterpret_cast<const unsigned*>(c_hi + o + 8) : 0u};
#pragma unroll
            for (int j = 0; j < P; ++j) {
              const bf16* wr = ws + static_cast<size_t>(j * d + F1 + g) * SW;
              const unsigned b0 =
                  bv ? *reinterpret_cast<const unsigned*>(wr + o) : 0u;
              const unsigned b1 =
                  bv && up ? *reinterpret_cast<const unsigned*>(wr + o + 8)
                           : 0u;
              mma_bf16(dp[j], a, b0, b1);
            }
          }
          // the product rule in f32 (interact.py:111-122), at features f,
          // f + 1 of edges 16 mt + g and 16 mt + g + 8
          const int f = F1 + 2 * t;
          if (f < d) {
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
              const size_t at = static_cast<size_t>(e0 + te) * d + f;
              // ABSORB: di for i_t1, at row e_pi
              const size_t at_i =
                  ABSORB ? static_cast<size_t>(epis[t0 + te]) * d + f : at;
              *reinterpret_cast<unsigned*>(droles + at) =
                  pack_bf16(gu[0], gu[1]);
              *reinterpret_cast<unsigned*>(droles + plane + at) =
                  pack_bf16(gq[0], gq[1]);
              *reinterpret_cast<unsigned*>(droles + 2 * plane + at_i) =
                  pack_bf16(gi[0], gi[1]);
            }
          }
        }
      }
      if (threadIdx.x < OUT) {
        for (int te = 0; te < n_e; ++te)
          bacc += __bfloat162float(cs[te * SC + threadIdx.x]);
      }
    }
    __syncthreads();  // the stage is read before it is refilled
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
  auto kernel = interact_bwd_fused_kernel<OUT, ORDER, ABSORB, WS>;
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

// The bf16 form's shared memory: W [parts * d][OUT + 8] and two stages,
// all bf16 (ABSORB: each stage with its c2 plane, then the chunk's e_pi and
// mask, 8 bytes an edge); 0 when it does not fit in one block.
size_t bf16_smem(int d, int out, int parts, bool absorb, int chunk_edges) {
  const size_t bytes =
      sizeof(__nv_bfloat16) *
          (static_cast<size_t>(parts) * d * (out + 8) +
           2 * static_cast<size_t>(kFusedTile) *
               (3 * (d + 8) + out + 8 + (absorb ? out + 8 : 0))) +
      (absorb ? 8 * static_cast<size_t>(chunk_edges) : 0);
  return bytes <= kSmemLimit ? bytes : 0;
}

template <int OUT, int ORDER, bool ABSORB>
cudaError_t launch_bf16(const void* u, const void* q, const void* i,
                        const void* w, const void* cot, Absorb ab,
                        void* droles, void* partial, void* dw_ext, int edges,
                        int d, int chunk_edges, cudaStream_t stream) {
  const int R = parts_of<ORDER>() * d;
  const size_t smem =
      bf16_smem(d, OUT, parts_of<ORDER>(), ABSORB, chunk_edges);
  if (smem == 0 || d % 8 != 0) return cudaErrorInvalidValue;
  auto kernel = interact_bwd_bf16_kernel<OUT, ORDER, ABSORB>;
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
      static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(i), static_cast<const float*>(w),
      static_cast<const __nv_bfloat16*>(cot),
      static_cast<const __nv_bfloat16*>(ab.cot2),
      static_cast<const int*>(ab.pi), static_cast<const float*>(ab.mask),
      static_cast<__nv_bfloat16*>(droles), static_cast<float*>(partial),
      edges, d, chunk_edges, ab.cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, dw_ext, chunk_count(edges, chunk_edges),
                         (R + 1) * OUT, stream);
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
// when W and two stages do not fit in one block's shared memory.
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
