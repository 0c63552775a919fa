// K3 interact_bwd: fused hyperedge feature interaction, backward.
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
// with its kernels _bwd_kernel (:253) and _bwd_kernel_batchk (:80). The
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
// element by every warp that needs it, at 12 warps an SM.
//
// K5's absorbed backward (ABSORB below) still runs the first design: a
// data kernel (one thread an edge, W in shared memory, f32 FMAs) and a
// param kernel (per-chunk dW partials, cp.async tiles), each reading u, q,
// i and cot, then the same reduction.
//
// Layout: u/q/i [E, d] f32 row-major (d % 4 == 0), W [parts * d, out] f32,
// cot [E, out] f32; droles [3, E, d] f32; partial [chunks, parts * d + 1,
// out] f32 scratch; dw_ext [parts * d + 1, out] f32 (dW, then db). out is
// one of 8, 16, 32, 64.
//
// ABSORB (K5, interact_bwd_absorb, interact.py:422): the backward of the
// absorbed forward (csrc/interact.cu), for the edges of an [R, C] grid in
// sigma order with i given in t1 order and pi [R, C] the row-local stage
// between them (rho = pi^-1). Both kernels read i through pi (i_sigma[e] =
// i_t1[e_pi], e_pi = r C + pi[r, c] for e = r C + c) and form the merged
// cotangent cot[e] = (c1[e] + c2[e_pi]) * mask[e]: o2 = rho(o1), whose
// vector-Jacobian product is the pi-gather of c2, and the mask zeroes the
// sigma pads (copies of real rows, which must reach no gradient). The data
// kernel reads each edge's c2 row straight into registers (staging it too
// would halve the blocks an SM holds) and stores di for i_t1, di_t1[e_pi]
// = di_sigma[e] (the rho-gather, a scatter store that writes each row
// once); the param kernel stages c2 beside c1 and merges them in shared
// memory. dW/db keep the fixed-order
// chunk partials, so a step repeats bit for bit. On the TPU pi and rho
// were dynamic gathers inside the VMEM block; here they are the row
// addresses of cp.async copies.

#include <cuda_runtime.h>

#include "tf32.cuh"

namespace {

constexpr int kDataThreads = 128;
constexpr int kParamThreads = 256;
constexpr int kTileEdges = 32;   // edges staged at once by the param kernel
constexpr int kMaxRows = 8;      // dW rows a param-kernel thread owns
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

// K5's data kernel. A block stages a tile of blockDim.x edges (u, q, i and
// cot rows) in shared memory by cp.async, 16 bytes a copy. Rows are padded
// by four floats, so the 16-byte reads of one row by each of 8
// neighbouring threads fall in distinct banks. Each thread computes its
// edge's du/dq/di in place over u/q/i, and the block stores the tile back,
// 16 bytes a thread.

template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(kDataThreads)
interact_bwd_data_kernel(const float* __restrict__ u,
                         const float* __restrict__ q,
                         const float* __restrict__ it,
                         const float* __restrict__ w,
                         const float* __restrict__ cot,
                         const float* __restrict__ cot2,
                         const int* __restrict__ pi,
                         const float* __restrict__ mask,
                         float* __restrict__ droles, int edges, int d,
                         int cols) {
  constexpr int P = parts_of<ORDER>();
  constexpr int SC = OUT + 4;  // padded cotangent row
  constexpr int C4 = OUT / 4;
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);
  const int wn = P * d * OUT;
  const int T = blockDim.x;
  const int sd = d + 4;        // padded role row
  const int v4 = d / 4;        // 16-byte vectors a role row
  float* us = ws + wn;         // [T][sd] u, then du
  float* qs = us + T * sd;     // [T][sd] q, then dq
  float* is = qs + T * sd;     // [T][sd] i, then di
  float* cs = is + T * sd;     // [T][SC] cot
  for (int t = threadIdx.x; t < wn; t += T) ws[t] = w[t];

  const size_t plane = static_cast<size_t>(edges) * d;
  for (long long base = static_cast<long long>(blockIdx.x) * T;
       base < edges; base += static_cast<long long>(gridDim.x) * T) {
    const int rows = static_cast<int>(edges - base < T ? edges - base : T);
    __syncthreads();  // W is staged; the previous tile is stored
    for (int idx = threadIdx.x; idx < T * v4; idx += T) {
      const int te = idx / v4;
      const int s4 = te * sd + 4 * (idx - te * v4);
      const bool in = te < rows;
      const size_t g = static_cast<size_t>(base) * d + 4 * idx;
      size_t gi = g;
      if (ABSORB && in) {
        const int e = static_cast<int>(base) + te;
        gi = static_cast<size_t>(permuted_edge(pi, e, cols)) * d +
             4 * (idx - te * v4);
      }
      cp_async16(us + s4, in ? u + g : u, in);
      cp_async16(qs + s4, in ? q + g : q, in);
      cp_async16(is + s4, in ? it + gi : it, in);
    }
    for (int idx = threadIdx.x; idx < T * C4; idx += T) {
      const int te = idx / C4;
      const bool in = te < rows;
      const size_t g = static_cast<size_t>(base) * OUT + 4 * idx;
      cp_async16(cs + te * SC + 4 * (idx - te * C4), in ? cot + g : cot, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float c[OUT];
    const float4* cr = reinterpret_cast<const float4*>(cs + threadIdx.x * SC);
#pragma unroll
    for (int o4 = 0; o4 < C4; ++o4) {
      const float4 v = cr[o4];
      c[4 * o4 + 0] = v.x;
      c[4 * o4 + 1] = v.y;
      c[4 * o4 + 2] = v.z;
      c[4 * o4 + 3] = v.w;
    }
    if (ABSORB && threadIdx.x < rows) {
      // the merged, masked cotangent: the thread's own row of cot2 at e_pi
      // goes straight to registers (a whole 16-byte-vector row, no staging,
      // so the tile's shared memory and the blocks an SM holds stay as
      // without ABSORB); rows past the tile's end are zeros
      const int e = static_cast<int>(base) + threadIdx.x;
      const float4* c2r = reinterpret_cast<const float4*>(cot2) +
                          static_cast<size_t>(permuted_edge(pi, e, cols)) * C4;
      const float m = mask != nullptr ? mask[e] : 1.f;
#pragma unroll
      for (int o4 = 0; o4 < C4; ++o4) {
        const float4 v = __ldg(c2r + o4);
        c[4 * o4 + 0] = (c[4 * o4 + 0] + v.x) * m;
        c[4 * o4 + 1] = (c[4 * o4 + 1] + v.y) * m;
        c[4 * o4 + 2] = (c[4 * o4 + 2] + v.z) * m;
        c[4 * o4 + 3] = (c[4 * o4 + 3] + v.w) * m;
      }
    }
    float4* ur = reinterpret_cast<float4*>(us + threadIdx.x * sd);
    float4* qr = reinterpret_cast<float4*>(qs + threadIdx.x * sd);
    float4* ir = reinterpret_cast<float4*>(is + threadIdx.x * sd);
    for (int k4 = 0; k4 < v4; ++k4) {
      const float4 a = ur[k4];
      const float4 bq = qr[k4];
      const float4 cc = ir[k4];
      const float uv[4] = {a.x, a.y, a.z, a.w};
      const float qv[4] = {bq.x, bq.y, bq.z, bq.w};
      const float iv[4] = {cc.x, cc.y, cc.z, cc.w};
      float gu[4], gq[4], gi[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * k4 + kk;
        float dp[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float4* wrow = reinterpret_cast<const float4*>(
              ws + static_cast<size_t>(j * d + k) * OUT);
          // four partial sums shorten the dependent FMA chain
          float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int o4 = 0; o4 < C4; ++o4) {
            const float4 wv = wrow[o4];
            s[0] = fmaf(c[4 * o4 + 0], wv.x, s[0]);
            s[1] = fmaf(c[4 * o4 + 1], wv.y, s[1]);
            s[2] = fmaf(c[4 * o4 + 2], wv.z, s[2]);
            s[3] = fmaf(c[4 * o4 + 3], wv.w, s[3]);
          }
          dp[j] = (s[0] + s[1]) + (s[2] + s[3]);
        }
        // the product rule as _bwd_kernel writes it (interact.py:284-294)
        const float x = uv[kk], y = qv[kk], z = iv[kk];
        float du = dp[0], dq = dp[1], di = dp[2];
        if constexpr (P >= 6) {
          du += dp[3] * y + dp[5] * z;
          dq += dp[3] * x + dp[4] * z;
          di += dp[4] * y + dp[5] * x;
        }
        if constexpr (P >= 7) {
          du += dp[6] * (y * z);
          dq += dp[6] * (x * z);
          di += dp[6] * (x * y);
        }
        gu[kk] = du;
        gq[kk] = dq;
        gi[kk] = di;
      }
      ur[k4] = make_float4(gu[0], gu[1], gu[2], gu[3]);
      qr[k4] = make_float4(gq[0], gq[1], gq[2], gq[3]);
      ir[k4] = make_float4(gi[0], gi[1], gi[2], gi[3]);
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(droles) + base * v4;
    const size_t plane4 = plane / 4;
    for (int idx = threadIdx.x; idx < rows * v4; idx += T) {
      const int te = idx / v4;
      const int s4 = te * sd + 4 * (idx - te * v4);
      long long di_at = idx;   // ABSORB: di for i_t1, at row e_pi
      if (ABSORB) {
        const int e = static_cast<int>(base) + te;
        di_at = (static_cast<long long>(permuted_edge(pi, e, cols)) - base) *
                    v4 + (idx - te * v4);
      }
      out[idx] = *reinterpret_cast<const float4*>(us + s4);
      out[plane4 + idx] = *reinterpret_cast<const float4*>(qs + s4);
      out[2 * plane4 + di_at] = *reinterpret_cast<const float4*>(is + s4);
    }
  }
}

// acc[m] += parts row pr[m * RG] (x) the cotangent columns 4 cg .. 4 cg + 3,
// over the staged tile's edges; MR rows, known at compile time, so the
// loop has no branch.
template <int MR, int CG, int RG>
__device__ __forceinline__ void accumulate(const float* __restrict__ pr,
                                           const float4* __restrict__ cs,
                                           int slab_rows, int cg,
                                           float (&acc)[kMaxRows][4]) {
#pragma unroll 4
  for (int te = 0; te < kTileEdges; ++te) {
    const float4 cv = cs[te * CG + cg];
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const float pv = pr[te * slab_rows + m * RG];
      acc[m][0] = fmaf(pv, cv.x, acc[m][0]);
      acc[m][1] = fmaf(pv, cv.y, acc[m][1]);
      acc[m][2] = fmaf(pv, cv.z, acc[m][2]);
      acc[m][3] = fmaf(pv, cv.w, acc[m][3]);
    }
  }
}

// K5's param kernel. grid (chunks, slabs). The block's chunk streams
// through shared memory 32 edges at a time, in two stages: while one
// tile's raw rows are used, the next tile's arrive by cp.async. Thread
// (rg, cg) owns dW rows
// slab_lo + rg + m * RG (m < kMaxRows) and columns 4 cg .. 4 cg + 3.
template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(kParamThreads)
interact_bwd_param_kernel(const float* __restrict__ u,
                          const float* __restrict__ q,
                          const float* __restrict__ it,
                          const float* __restrict__ cot,
                          const float* __restrict__ cot2,
                          const int* __restrict__ pi,
                          const float* __restrict__ mask,
                          float* __restrict__ partial, int edges, int d,
                          int chunk_edges, int slab_rows, int cols) {
  constexpr int P = parts_of<ORDER>();
  constexpr int CG = OUT / 4;
  constexpr int RG = kParamThreads / CG;
  const int R = P * d;
  const int slab_lo = blockIdx.y * slab_rows;
  const int rows = min(slab_rows, R - slab_lo);
  // per stage: u, q, i rows [kTileEdges][d] each, then cot [kTileEdges][OUT]
  // (ABSORB: then cot2 [kTileEdges][OUT], gathered)
  const int plane = kTileEdges * d;
  const int stage_floats = 3 * plane + (ABSORB ? 2 : 1) * kTileEdges * OUT;
  extern __shared__ float4 smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float* ps = stages + 2 * stage_floats;  // [kTileEdges][slab_rows] parts
  const int cg = threadIdx.x % CG;
  const int rg = threadIdx.x / CG;
  const bool db_lane = blockIdx.y == 0 && threadIdx.x < OUT;
  // this thread's rows: rg + m * RG < rows for m < my_rows (<= kMaxRows)
  const int my_rows = rg < rows ? (rows - rg + RG - 1) / RG : 0;

  float acc[kMaxRows][4];
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
  float bacc = 0.f;

  const long long begin = static_cast<long long>(blockIdx.x) * chunk_edges;
  const int e_begin = static_cast<int>(begin);
  const int e_end = static_cast<int>(
      begin + chunk_edges < edges ? begin + chunk_edges : edges);
  const int tiles = (e_end - e_begin + kTileEdges - 1) / kTileEdges;

  auto issue = [&](int t) {
    float* buf = stages + (t & 1) * stage_floats;
    const int e0 = e_begin + t * kTileEdges;
    const int n_e = min(kTileEdges, e_end - e0);
    const int v4 = plane / 4;
    for (int idx = threadIdx.x; idx < 3 * v4; idx += kParamThreads) {
      const int a = idx / v4;
      const int v = idx - a * v4;
      const float* src = a == 0 ? u : (a == 1 ? q : it);
      const bool valid = 4 * v < n_e * d;
      size_t g = static_cast<size_t>(e0) * d + 4 * v;
      if (ABSORB && a == 2 && valid) {
        const int te = 4 * v / d;
        g = static_cast<size_t>(permuted_edge(pi, e0 + te, cols)) * d +
            (4 * v - te * d);
      }
      cp_async16(buf + a * plane + 4 * v, valid ? src + g : src, valid);
    }
    for (int idx = threadIdx.x; idx < kTileEdges * CG;
         idx += kParamThreads) {
      const bool valid = idx < n_e * CG;
      cp_async16(buf + 3 * plane + 4 * idx,
                 valid ? cot + static_cast<size_t>(e0) * OUT + 4 * idx : cot,
                 valid);
      if (ABSORB) {
        size_t g2 = 0;
        if (valid) {
          const int te = idx / CG;
          g2 = static_cast<size_t>(permuted_edge(pi, e0 + te, cols)) * OUT +
               4 * (idx - te * CG);
        }
        cp_async16(buf + 3 * plane + kTileEdges * OUT + 4 * idx, cot2 + g2,
                   valid);
      }
    }
    cp_async_commit();
  };

  if (tiles > 0) issue(0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    float* buf = stages + (t & 1) * stage_floats;
    if (ABSORB) {
      // the merged, masked cotangent, in place over cot; read after the
      // barrier below
      const int e0 = e_begin + t * kTileEdges;
      const int n_e = min(kTileEdges, e_end - e0);
      float* c1 = buf + 3 * plane;
      const float* c2 = c1 + kTileEdges * OUT;
      for (int idx = threadIdx.x; idx < n_e * OUT; idx += kParamThreads) {
        const float m = mask != nullptr ? mask[e0 + idx / OUT] : 1.f;
        c1[idx] = (c1[idx] + c2[idx]) * m;
      }
    }
    for (int idx = threadIdx.x; idx < plane; idx += kParamThreads) {
      const int te = idx / d;
      const int k = idx - te * d;
      float p[P];
      make_parts<P>(buf[idx], buf[plane + idx], buf[2 * plane + idx], p);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int r = j * d + k - slab_lo;
        if (r >= 0 && r < rows) ps[te * slab_rows + r] = p[j];
      }
    }
    __syncthreads();
    const float4* cs = reinterpret_cast<const float4*>(buf + 3 * plane);
    const float* pr = ps + rg;
    switch (my_rows) {
      case 1: accumulate<1, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      case 2: accumulate<2, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      case 3: accumulate<3, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      case 4: accumulate<4, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      case 5: accumulate<5, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      case 6: accumulate<6, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      case 7: accumulate<7, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      case 8: accumulate<8, CG, RG>(pr, cs, slab_rows, cg, acc); break;
      default: break;
    }
    if (db_lane) {
      const float* cf = reinterpret_cast<const float*>(cs) + threadIdx.x;
      for (int te = 0; te < kTileEdges; ++te) bacc += cf[te * OUT];
    }
    __syncthreads();  // ps and this stage are read before they are reused
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * (R + 1) * OUT;
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m) {
    const int r = rg + m * RG;
    if (r < rows) {
      reinterpret_cast<float4*>(out + static_cast<size_t>(slab_lo + r) * OUT)
          [cg] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
  if (db_lane) out[static_cast<size_t>(R) * OUT + threadIdx.x] = bacc;
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
// The fused backward on the tensor cores (interact_bwd)
// ---------------------------------------------------------------------------

constexpr int kFusedWarps = 4;
constexpr int kFusedThreads = 32 * kFusedWarps;
constexpr int kFusedTile = 32;    // edges staged at once

// Fragments of mma.m16n8k8: see tf32.cuh.
//
// grid (chunks, slabs), kFusedThreads threads. A block owns chunk
// blockIdx.x of chunk_edges edges and streams it through shared memory
// kFusedTile edges at a time, double-buffered by cp.async: u, q, i rows
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
//    shared memory once, in [16 edges, 8 features] tiles, warp w taking the
//    feature blocks 8 w, 8 (w + 4), ...; the product rule runs on the
//    accumulator fragments in f32, each thread holding every part's dpart at
//    its (edge, feature) positions beside u, q, i read from the stage, and
//    du, dq, di go from registers to the [3, E, d] buffer, 32-byte row pieces
//    a store. No dpart leaves registers. Slab 0 also sums db.
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
// The role rows are addressed through role_row: K5's absorbed backward
// (interact_bwd_absorb) reads i and c2 through pi, and can take this kernel
// by routing those two through pi there.
template <int OUT, int ORDER>
__global__ void __launch_bounds__(kFusedThreads)
interact_bwd_fused_kernel(const float* __restrict__ u,
                          const float* __restrict__ q,
                          const float* __restrict__ it,
                          const float* __restrict__ w,
                          const float* __restrict__ cot,
                          float* __restrict__ droles,
                          float* __restrict__ partial, int edges, int d,
                          int chunk_edges) {
  constexpr int P = parts_of<ORDER>();
  constexpr int T = kFusedTile;
  constexpr int SC = OUT + 8;              // staged cot row
  constexpr int SW = OUT <= 32 ? 36 : 68;  // staged W row
  constexpr int MT = OUT >= 32 ? 2 : 1;    // 16-output tiles of a slab
  constexpr int OS = (OUT + 31) / 32;      // output slabs
  constexpr int KO = OUT / 8;              // k steps of the data product
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
  float* ws = reinterpret_cast<float*>(smem);   // [R][SW] W
  float* stages = ws + static_cast<size_t>(R) * SW;
  const int stage_floats = T * (3 * sd + SC);

  if (data) {
    const int c4 = OUT / 4;
    for (int idx = threadIdx.x; idx < R * c4; idx += kFusedThreads) {
      const int r = idx / c4;
      const int v = idx - r * c4;
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

  // the row of role a (0 u, 1 q, 2 i) of edge e
  auto role_row = [&](int a, int e) -> const float* {
    const float* src = a == 0 ? u : (a == 1 ? q : it);
    return src + static_cast<size_t>(e) * d;
  };

  auto issue = [&](int tile) {
    float* buf = stages + (tile & 1) * stage_floats;
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
    constexpr int C4 = OUT / 4;
    for (int idx = threadIdx.x; idx < T * C4; idx += kFusedThreads) {
      const int te = idx / C4;
      const int v = idx - te * C4;
      const bool valid = te < n_e;
      cp_async16(buf + 3 * T * sd + te * SC + 4 * v,
                 valid ? cot + static_cast<size_t>(e0 + te) * OUT + 4 * v
                       : cot,
                 valid);
    }
    cp_async_commit();
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

  if (tiles > 0) issue(0);
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and W) has landed for every thread
    const float* us = stages + (tile & 1) * stage_floats;
    const float* qs = us + T * sd;
    const float* is = qs + T * sd;
    const float* cs = is + T * sd;
    const int e0 = e_begin + tile * T;
    const int n_e = min(T, e_end - e0);

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
              const float* wr = ws + (j * d + F1 + g) * SW;
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
              *reinterpret_cast<float2*>(droles + at) =
                  make_float2(gu[0], gu[1]);
              *reinterpret_cast<float2*>(droles + plane + at) =
                  make_float2(gq[0], gq[1]);
              *reinterpret_cast<float2*>(droles + 2 * plane + at) =
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

cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            long long needed, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(needed < resident ? needed : resident);
  return cudaSuccess;
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

// interact_bwd: the fused kernel, then the sum over chunks. A shape whose
// W and two stages do not fit in one block's shared memory is refused
// before anything is launched.
template <int OUT, int ORDER>
cudaError_t launch_fused(const void* u, const void* q, const void* i,
                         const void* w, const void* cot, void* droles,
                         void* partial, void* dw_ext, int edges, int d,
                         int chunk_edges, cudaStream_t stream) {
  constexpr int P = parts_of<ORDER>();
  constexpr int SW = OUT <= 32 ? 36 : 68;
  const int R = P * d;
  const size_t smem =
      (static_cast<size_t>(R) * SW +
       2 * static_cast<size_t>(kFusedTile) * (3 * (d + 8) + OUT + 8)) *
      sizeof(float);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = interact_bwd_fused_kernel<OUT, ORDER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it as the return value
    return err;
  }
  const int chunks = chunk_count(edges, chunk_edges);
  const int slabs = ((d + 31) / 32) * ((OUT + 31) / 32);
  kernel<<<dim3(chunks, slabs), kFusedThreads, smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(q),
      static_cast<const float*>(i), static_cast<const float*>(w),
      static_cast<const float*>(cot), static_cast<float*>(droles),
      static_cast<float*>(partial), edges, d, chunk_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, dw_ext, chunks, (R + 1) * OUT, stream);
}

template <int OUT, int ORDER, bool ABSORB>
cudaError_t launch(const void* u, const void* q, const void* i, const void* w,
                   const void* cot, Absorb ab, void* droles, void* partial,
                   void* dw_ext, int edges, int d, int chunk_edges,
                   cudaStream_t stream) {
  if constexpr (!ABSORB) {
    return launch_fused<OUT, ORDER>(u, q, i, w, cot, droles, partial, dw_ext,
                                    edges, d, chunk_edges, stream);
  }
  constexpr int P = parts_of<ORDER>();
  constexpr int RG = kParamThreads / (OUT / 4);
  const int R = P * d;

  // Shared memory of both main kernels; a shape that does not fit is
  // refused before anything is launched. Kernel 1 holds W and a tile of T
  // edges, T the largest of 128, 64, 32 that fits; kernel 2 holds two
  // 32-edge stages and a slab of parts.
  const size_t w_smem = static_cast<size_t>(R) * OUT * sizeof(float);
  int threads = kDataThreads;
  size_t d_smem = 0;
  for (;; threads /= 2) {
    d_smem = w_smem + static_cast<size_t>(threads) *
                          (3 * (d + 4) + OUT + 4) * sizeof(float);
    if (d_smem <= kSmemLimit || threads == 32) break;
  }
  const int slab_rows = R < RG * kMaxRows ? R : RG * kMaxRows;
  const size_t p_smem =
      (2 * static_cast<size_t>(kTileEdges) * (3 * d + (ABSORB ? 2 : 1) *
                                                  OUT) +
       static_cast<size_t>(kTileEdges) * slab_rows) * sizeof(float);
  if (d_smem > kSmemLimit || p_smem > kSmemLimit)
    return cudaErrorInvalidValue;

  // 1. data gradients
  auto data = interact_bwd_data_kernel<OUT, ORDER, ABSORB>;
  cudaError_t err = cudaFuncSetAttribute(
      data, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(d_smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = resident_blocks(reinterpret_cast<const void*>(data), threads,
                          d_smem, (static_cast<long long>(edges) + threads -
                                   1) / threads, &blocks);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it as the return value
    return err;
  }
  data<<<blocks, threads, d_smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(q),
      static_cast<const float*>(i), static_cast<const float*>(w),
      static_cast<const float*>(cot), static_cast<const float*>(ab.cot2),
      static_cast<const int*>(ab.pi), static_cast<const float*>(ab.mask),
      static_cast<float*>(droles), edges, d, ab.cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. dW/db partials, one per chunk of edges
  const int slabs = (R + slab_rows - 1) / slab_rows;
  const int chunks = chunk_count(edges, chunk_edges);
  auto param = interact_bwd_param_kernel<OUT, ORDER, ABSORB>;
  err = cudaFuncSetAttribute(param,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p_smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  param<<<dim3(chunks, slabs), kParamThreads, p_smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(q),
      static_cast<const float*>(i), static_cast<const float*>(cot),
      static_cast<const float*>(ab.cot2), static_cast<const int*>(ab.pi),
      static_cast<const float*>(ab.mask), static_cast<float*>(partial), edges,
      d, chunk_edges, slab_rows, ab.cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 3. the fixed-order sum over chunks
  return reduce_partials(partial, dw_ext, chunks, (R + 1) * OUT, stream);
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
  if (edges <= 0 || chunk_edges <= 0 || chunk_edges % kTileEdges != 0)
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
