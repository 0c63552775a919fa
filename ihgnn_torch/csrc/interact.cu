// K3 interact_fwd: fused hyperedge feature interaction, forward.
//
//   out[e, :] = b + sum_j part_j[e, :] . W[j*d:(j+1)*d, :]
//   parts: [u, q, i] (order 1), + [u*q, q*i, i*u] (order 2), + [u*q*i] (3)
//
// Replaces ihgnn_tpu/ops/pallas/interact.py interact_fwd (interact.py:319,
// kernel _fwd_kernel :49) and, with ABSORB, interact_fwd_absorb (:397,
// kernel _fwd_kernel_absorb :177). The TPU kernel stacks the parts of a
// 2048-edge block in VMEM and runs one bf16 MXU matmul; this kernel runs
// the same product on the tensor cores in 3xTF32, which keeps f32
// accuracy (tf32.cuh).
//
// Bound on the H100: bytes at every order. Per edge the kernel reads 3d
// floats and writes `out` floats (0.306 ms for 2M edges at d = out = 32),
// and does 2 * parts * d * out FLOPs (14,336 at order 3): three TF32
// products of it take 0.17 ms at 495 TFLOP/s, where the f32 CUDA cores
// would take 0.43 ms.
//
// Two forms, chosen from the shape alone (interact_fwd_form):
//
// 1. The tensor-core form, for d % 8 == 0 when W's split and one warp's
//    ring fit in shared memory (every width the model uses). A block
//    splits W once into hi/lo TF32 halves, stored in mma fragment order
//    ([k step][n8 tile][lane] of uint4 {b0 hi, b1 hi, b0 lo, b1 lo}), so a
//    lane reads its B fragments with one 16-byte load. Each warp then
//    streams its own 16-edge tiles (one m16 row tile) through a ring of
//    two cp.async stages (u, q and i as [16][d + pad] rows; a warp's
//    16-byte copies cover whole rows, neighbouring lanes on neighbouring
//    addresses; the ragged tail is zero-filled), so no barrier joins the
//    warps after W is staged. For each 8-feature block a lane reads its
//    u, q, i values (two features of two edges, float2 loads), forms the
//    parts and splits each once for its own edges; A is the parts [16,
//    parts * d], B is W, C the f32 accumulators (out / 8 n8 tiles). The
//    sum over the parts is the k loop of one product: parts * d / 8 k
//    steps of 3 mma.sync.m16n8k8 an n8 tile. The accumulators plus b go
//    through the warp's stage (free by then) as a [16][out + pad] tile,
//    and leave as whole rows, 16 bytes a lane. Pads keep the float2
//    fragment accesses free of bank conflicts. Shared memory sets the
//    warps an SM holds (W's 57 KB of fragments at order 3, d = out = 32,
//    then 15 KB a warp): 16-edge tiles let 11 warps fit at order 3, where
//    32-edge tiles (W's fragments read once for two row tiles) let 5 fit
//    and ran slower, as did a third stage and W split at every use.
// 2. The f32-core form, for any other shape (d % 4 == 0): one thread an
//    edge, W in shared memory, the parts formed four features at a time in
//    registers and FMAed into `out` accumulators; persistent blocks.
//
// Layout: u/q/i [E, d] f32 row-major (d % 4 == 0), W [parts * d, out] f32,
// b [out] f32, out [E, out] f32; out is one of 8, 16, 32, 64.
//
// ABSORB (K5, interact_fwd_absorb): the routed path's absorbed
// interaction. The edges are an [R, C] grid in sigma order and i arrives
// one row-local stage early (t1 order); pi [R, C] int32 is that stage (i's
// stage 2 composed with sigma) and rho = pi^-1 row-locally. The kernel
// reads i through pi, i_sigma[r C + c] = i_t1[r C + pi[r, c]] (the i
// tile's source rows), and writes o1 = out as above and a second output
// o2 = rho(o1), the first stage of the scatter's i chain, as a scatter
// store o2[r C + pi[r, c]] = o1[r C + c] of the same staged output rows:
// each position is written once. On the TPU pi and rho had to nest inside
// the kernel's VMEM block; here each is one index load an edge, and the
// bound is K3's plus one more [E, out] write.
//
// 3. The bf16 form (ModelConfig.bf16_stream), for bf16 roles: the Pallas
//    kernel's own contract (interact.py:49-60, :334): u*q, q*i and i*u are
//    each rounded to bf16, u*q*i = round(round(u*q) * i), W is rounded to
//    bf16, the product accumulates in f32 and out = acc + b (f32) is
//    rounded to a bf16 [E, out]. A bf16 x bf16 product is exact in f32, so
//    this is one mma.sync.m16n8k16 bf16 pass (bf16.cuh), no split. The
//    design is the tensor-core form's in bf16: a block rounds W once into
//    B-fragment order (a uint2 {b0, b1} a lane: rows 16 kf + 2 t, + 1 and
//    16 kf + 2 t + 8, + 9 of a part, column 8 n + g; zero past the part's
//    d), each warp streams its own 16-edge tiles of bf16 rows through a
//    two-stage cp.async ring, forms the parts on bf16x2 pairs (__hmul2,
//    rounded to nearest even) straight in A-fragment order, and its output
//    tile leaves through the stage as whole bf16 rows. It takes d % 8 == 0
//    (16-byte row copies; when d % 16 == 8 the last k step's upper half is
//    zero) when W's fragments and one warp's ring fit in shared memory.
//    Bound: bytes. At E = 2M, d = out = 32 it reads 3 x 128 MB of roles
//    and writes 128 MB (0.153 ms at 3.35 TB/s); its 14,336 FLOPs an edge
//    at order 3 take 0.029 ms at the 989 TFLOP/s bf16 rate.
//    With ABSORB (K5 on the routed pack's bf16 streams, the Pallas
//    _fwd_kernel_absorb on bf16 operands) the bf16 form reads i through pi
//    and writes o2 = rho(o1) as the tensor-core form does: a copy of the
//    bf16 o1 rows, so o2 holds o1's values bit for bit. Each copy of an i
//    row and each o2 store loads its row's pi entry (an L1 hit for the
//    tile's other vectors of the row), so no shuffle depends on how many
//    lanes a row takes. Bound: bytes, K3's bf16 form plus one more
//    [E, out] bf16 write and E int32 reads of pi.

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
constexpr int kTileEdges = 16;     // edges a warp stages at once: one m16 tile
constexpr int kStages = 2;         // cp.async ring of a warp
constexpr int kMaxWarps = 12;      // warps a tensor-core block
constexpr int kCoreThreads = 128;  // threads an f32-core block

template <int ORDER>
__host__ __device__ constexpr int parts_of() {
  return ORDER == 1 ? 3 : (ORDER == 2 ? 6 : 7);
}

// Staged row of `width` floats (a multiple of 8): the stride is 8 or 24
// mod 32 floats, so the float2 loads and stores of a fragment, four rows
// by four lane pairs each half warp, meet no bank conflict.
__host__ __device__ constexpr int row_stride(int width) {
  return width + (width % 16 == 0 ? 8 : 16);
}

// Floats of one stage of a warp's ring: u, q and i rows, later the output
// tile.
__host__ __device__ constexpr int stage_floats(int d, int out) {
  return 3 * row_stride(d) > row_stride(out)
             ? 3 * kTileEdges * row_stride(d)
             : kTileEdges * row_stride(out);
}

// Bytes of W's hi/lo fragments: two TF32 halves of each of its values.
size_t w_fragment_bytes(int d, int out, int parts) {
  return static_cast<size_t>(parts) * d * out * 2 * sizeof(float);
}

// Warps a block of the tensor-core form runs for this shape, or 0 when
// the form does not take it: d % 8 != 0, or W's fragments and one warp's
// ring do not fit in shared memory. At d = out = 32 a block runs 11 warps
// at order 3 (57 KB of W) and 12 at order 1; one block fits an SM.
int mma_warps(int d, int out, int parts) {
  if (d <= 0 || d % 8 != 0) return 0;
  const size_t w_bytes = w_fragment_bytes(d, out, parts);
  const size_t warp_bytes = static_cast<size_t>(kStages) *
                            stage_floats(d, out) * sizeof(float);
  if (w_bytes + warp_bytes > kSmemLimit) return 0;
  const size_t warps = (kSmemLimit - w_bytes) / warp_bytes;
  return static_cast<int>(warps < kMaxWarps ? warps : kMaxWarps);
}

// Part J of the (x, y, z) = (u, q, i) values at one position, rounded as
// the plain twin forms it.
template <int J>
__device__ __forceinline__ float part(float x, float y, float z) {
  if constexpr (J == 0) return x;
  if constexpr (J == 1) return y;
  if constexpr (J == 2) return z;
  if constexpr (J == 3) return x * y;
  if constexpr (J == 4) return y * z;
  if constexpr (J == 5) return z * x;
  return (x * y) * z;
}

// acc[n] += part J [16 edges, k block] . W's fragments wj of the block
// (NT n8 tiles), in 3xTF32, the small terms first. x, y, z hold u, q, i at
// rows g ([0]) and g + 8 ([1]), features f (.x, the mma's k = t) and f + 1
// (.y, k = t + 4): a0 a1 a2 a3 of the A fragment.
template <int J, int NT>
__device__ __forceinline__ void part_product(const float2 (&x)[2],
                                             const float2 (&y)[2],
                                             const float2 (&z)[2],
                                             const uint4* __restrict__ wj,
                                             float (&acc)[NT][4]) {
  unsigned ah[4], al[4];
  split_tf32(part<J>(x[0].x, y[0].x, z[0].x), ah[0], al[0]);
  split_tf32(part<J>(x[1].x, y[1].x, z[1].x), ah[1], al[1]);
  split_tf32(part<J>(x[0].y, y[0].y, z[0].y), ah[2], al[2]);
  split_tf32(part<J>(x[1].y, y[1].y, z[1].y), ah[3], al[3]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint4 bf = wj[n * 32];   // b0 hi, b1 hi, b0 lo, b1 lo
    mma_tf32(acc[n], ah, bf.z, bf.w);
    mma_tf32(acc[n], al, bf.x, bf.y);
    mma_tf32(acc[n], ah, bf.x, bf.y);
  }
}

// The tensor-core form (see the top of the file). blockDim.x is 32 times
// the warps of mma_warps; dynamic shared memory holds W's fragments, then
// each warp's ring.
template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(32 * kMaxWarps)
interact_fwd_mma_kernel(const float* __restrict__ u,
                        const float* __restrict__ q,
                        const float* __restrict__ it,
                        const float* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ out,
                        const int* __restrict__ pi, float* __restrict__ out2,
                        int edges, int d, int cols) {
  constexpr int P = parts_of<ORDER>();
  constexpr int NT = OUT / 8;             // n8 tiles of the output
  constexpr int TE = kTileEdges;
  constexpr int SO = row_stride(OUT);     // staged output row
  constexpr int C4 = OUT / 4;             // 16-byte vectors an output row
  const int sd = row_stride(d);           // staged role row
  const int kb = d >> 3;                  // 8-feature blocks a part
  const int v4 = d >> 2;                  // 16-byte vectors a role row
  const int stage = stage_floats(d, OUT);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ float4 smem[];
  uint4* wf = reinterpret_cast<uint4*>(smem);  // [P kb][NT][32] fragments
  float* ring = reinterpret_cast<float*>(wf + static_cast<size_t>(P) * kb *
                                                  NT * 32) +
                static_cast<size_t>(warp) * kStages * stage;

  const int tiles = (edges + TE - 1) / TE;
  const int stride = gridDim.x * warps;
  const int first = blockIdx.x * warps + warp;
  // a lane's copies walk the tile's (row, vector) pairs 32 at a time
  const int rstep = 32 / v4;
  const int vstep = 32 % v4;

  // tile `tile` into stage `slot`: u, q and i rows (ABSORB: i at row
  // e_pi); rows past the last edge are zero-filled. Commits one group,
  // empty past the last tile.
  auto issue = [&](int tile, int slot) {
    if (tile < tiles) {
      float* buf = ring + slot * stage;
      const int e0 = tile * TE;
      int src_i = 0;   // ABSORB: lane r holds the i row of the tile's row r
      if (ABSORB) {
        const int e = e0 + lane;
        if (lane < TE && e < edges) src_i = e - e % cols + __ldg(pi + e);
      }
      int r = lane / v4;
      int v = lane % v4;
      for (int c = lane; c < TE * v4; c += 32) {
        const int e = e0 + r;
        const bool valid = e < edges;
        const int ei = ABSORB ? __shfl_sync(0xffffffffu, src_i, r) : e;
        const size_t at = static_cast<size_t>(e) * d + 4 * v;
        float* dst = buf + r * sd + 4 * v;
        cp_async16(dst, valid ? u + at : u, valid);
        cp_async16(dst + TE * sd, valid ? q + at : q, valid);
        cp_async16(dst + 2 * TE * sd,
                   valid ? it + static_cast<size_t>(ei) * d + 4 * v : it,
                   valid);
        r += rstep;
        v += vstep;
        if (v >= v4) {
          v -= v4;
          ++r;
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(first + s * stride, s);

  // W's fragments: k step ks = j kb + kf, n8 tile n, lane l holds
  // b0 = W[8 ks + 2 t][8 n + g] and b1 = W[8 ks + 2 t + 1][8 n + g] (the
  // mma's k = t and k = t + 4 are features 2 t and 2 t + 1 of the block)
  for (int idx = threadIdx.x; idx < P * kb * NT * 32; idx += blockDim.x) {
    const int l = idx & 31;
    const int n = (idx >> 5) % NT;
    const int ks = (idx >> 5) / NT;
    const int row = 8 * ks + 2 * (l & 3);
    const int col = 8 * n + (l >> 2);
    unsigned h0, l0, h1, l1;
    split_tf32(__ldg(w + static_cast<size_t>(row) * OUT + col), h0, l0);
    split_tf32(__ldg(w + static_cast<size_t>(row + 1) * OUT + col), h1, l1);
    wf[idx] = make_uint4(h0, h1, l0, l1);
  }
  float bias[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    bias[n][0] = __ldg(b + 8 * n + 2 * t);
    bias[n][1] = __ldg(b + 8 * n + 2 * t + 1);
  }
  __syncthreads();  // W's fragments are staged

  int step = 0;
  for (int tile = first; tile < tiles; tile += stride, ++step) {
    issue(tile + (kStages - 1) * stride, (step + kStages - 1) % kStages);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // the tile has landed for every lane
    float* buf = ring + (step % kStages) * stage;
    const float* us = buf;
    const float* qs = us + TE * sd;
    const float* is = qs + TE * sd;

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int kf = 0; kf < kb; ++kf) {
      // features f, f + 1 of rows g and g + 8
      const int at = g * sd + 8 * kf + 2 * t;
      float2 x[2], y[2], z[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[h] = *reinterpret_cast<const float2*>(us + at + 8 * h * sd);
        y[h] = *reinterpret_cast<const float2*>(qs + at + 8 * h * sd);
        z[h] = *reinterpret_cast<const float2*>(is + at + 8 * h * sd);
      }
      const uint4* wk = wf + static_cast<size_t>(kf) * NT * 32 + lane;
      const size_t part_step = static_cast<size_t>(kb) * NT * 32;
      part_product<0, NT>(x, y, z, wk, acc);
      part_product<1, NT>(x, y, z, wk + part_step, acc);
      part_product<2, NT>(x, y, z, wk + 2 * part_step, acc);
      if constexpr (P >= 6) {
        part_product<3, NT>(x, y, z, wk + 3 * part_step, acc);
        part_product<4, NT>(x, y, z, wk + 4 * part_step, acc);
        part_product<5, NT>(x, y, z, wk + 5 * part_step, acc);
      }
      if constexpr (P >= 7)
        part_product<6, NT>(x, y, z, wk + 6 * part_step, acc);
    }

    // out rows through the stage: the roles are read, so the stage holds
    // the [TE][SO] output tile; then whole rows, 16 bytes a lane
    __syncwarp();
    float* ot = buf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(ot + g * SO + c) =
          make_float2(acc[n][0] + bias[n][0], acc[n][1] + bias[n][1]);
      *reinterpret_cast<float2*>(ot + (g + 8) * SO + c) =
          make_float2(acc[n][2] + bias[n][0], acc[n][3] + bias[n][1]);
    }
    __syncwarp();
    const int e0 = tile * TE;
    int dst2 = 0;      // ABSORB: lane r holds the o2 row of the tile's row r
    if (ABSORB) {
      const int e = e0 + lane;
      if (lane < TE && e < edges) dst2 = e - e % cols + __ldg(pi + e);
    }
#pragma unroll
    for (int c = lane; c < TE * C4; c += 32) {
      const int r = c / C4;
      const int v = c % C4;
      const float4 val = *reinterpret_cast<const float4*>(ot + r * SO + 4 * v);
      const int e = e0 + r;
      const int e2 = ABSORB ? __shfl_sync(0xffffffffu, dst2, r) : 0;
      if (e < edges) {
        reinterpret_cast<float4*>(out + static_cast<size_t>(e) * OUT)[v] =
            val;
        if (ABSORB)
          reinterpret_cast<float4*>(out2 + static_cast<size_t>(e2) * OUT)[v] =
              val;
      }
    }
    __syncwarp();  // the stage is read before the ring refills it
  }
}

// The f32-core form (see the top of the file).
template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(kCoreThreads)
interact_fwd_cores_kernel(const float* __restrict__ u,
                          const float* __restrict__ q,
                          const float* __restrict__ it,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          float* __restrict__ out, const int* __restrict__ pi,
                          float* __restrict__ out2, int edges, int d,
                          int cols) {
  constexpr int P = parts_of<ORDER>();
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);
  const int wn = P * d * OUT;
  for (int t = threadIdx.x; t < wn; t += kCoreThreads) ws[t] = w[t];
  __syncthreads();

  const int vecs = d / 4;
  for (int e = blockIdx.x * kCoreThreads + threadIdx.x; e < edges;
       e += gridDim.x * kCoreThreads) {
    float acc[OUT];
#pragma unroll
    for (int o = 0; o < OUT; ++o) acc[o] = 0.f;
    const size_t row = static_cast<size_t>(e) * vecs;
    // ABSORB: the pi-permuted edge of e's grid row
    const int e_pi = ABSORB ? e - e % cols + pi[e] : e;
    const float4* u4 = reinterpret_cast<const float4*>(u) + row;
    const float4* q4 = reinterpret_cast<const float4*>(q) + row;
    const float4* i4 = reinterpret_cast<const float4*>(it) +
                       static_cast<size_t>(e_pi) * vecs;
    for (int k4 = 0; k4 < vecs; ++k4) {
      const float4 a = u4[k4];
      const float4 bq = q4[k4];
      const float4 c = i4[k4];
      const float uv[4] = {a.x, a.y, a.z, a.w};
      const float qv[4] = {bq.x, bq.y, bq.z, bq.w};
      const float iv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float p[P];
        p[0] = uv[kk];
        p[1] = qv[kk];
        p[2] = iv[kk];
        if constexpr (P >= 6) {
          p[3] = uv[kk] * qv[kk];
          p[4] = qv[kk] * iv[kk];
          p[5] = iv[kk] * uv[kk];
        }
        if constexpr (P >= 7) p[6] = p[3] * iv[kk];
        const int k = 4 * k4 + kk;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float4* wrow = reinterpret_cast<const float4*>(
              ws + static_cast<size_t>(j * d + k) * OUT);
#pragma unroll
          for (int o4 = 0; o4 < OUT / 4; ++o4) {
            const float4 wv = wrow[o4];
            acc[4 * o4 + 0] = fmaf(p[j], wv.x, acc[4 * o4 + 0]);
            acc[4 * o4 + 1] = fmaf(p[j], wv.y, acc[4 * o4 + 1]);
            acc[4 * o4 + 2] = fmaf(p[j], wv.z, acc[4 * o4 + 2]);
            acc[4 * o4 + 3] = fmaf(p[j], wv.w, acc[4 * o4 + 3]);
          }
        }
      }
    }
    float4* o4p = reinterpret_cast<float4*>(out) +
                  static_cast<size_t>(e) * (OUT / 4);
    float4* o4q = reinterpret_cast<float4*>(out2) +
                  static_cast<size_t>(e_pi) * (OUT / 4);
#pragma unroll
    for (int o4 = 0; o4 < OUT / 4; ++o4) {
      const float4 v = make_float4(acc[4 * o4 + 0] + b[4 * o4 + 0],
                                   acc[4 * o4 + 1] + b[4 * o4 + 1],
                                   acc[4 * o4 + 2] + b[4 * o4 + 2],
                                   acc[4 * o4 + 3] + b[4 * o4 + 3]);
      o4p[o4] = v;
      if (ABSORB) o4q[o4] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. The bf16 form
// ---------------------------------------------------------------------------

// Staged bf16 row of `width` elements (a multiple of 8): 16 bytes of pad,
// so the 32-bit fragment loads of a quarter warp (rows g, words t) meet no
// bank conflict at the model's widths.
__host__ __device__ constexpr int bf16_row(int width) { return width + 8; }

// bf16 elements of one stage of a warp's ring: u, q and i rows, later the
// output tile.
__host__ __device__ constexpr int bf16_stage(int d, int out) {
  return 3 * bf16_row(d) > bf16_row(out) ? 3 * kTileEdges * bf16_row(d)
                                         : kTileEdges * bf16_row(out);
}

// Bytes of W's bf16 fragments: (d + 15) / 16 k steps a part, out / 8 n8
// tiles, a uint2 a lane.
size_t bf16_w_bytes(int d, int out, int parts) {
  return static_cast<size_t>(parts) * ((d + 15) / 16) * (out / 8) * 32 *
         sizeof(uint2);
}

// Warps a block of the bf16 form runs, or 0 when it does not take the
// shape (d % 8 != 0, or W's fragments and one warp's ring do not fit).
int bf16_warps(int d, int out, int parts) {
  if (d <= 0 || d % 8 != 0) return 0;
  const size_t w_bytes = bf16_w_bytes(d, out, parts);
  const size_t warp_bytes = static_cast<size_t>(kStages) *
                            bf16_stage(d, out) * sizeof(__nv_bfloat16);
  if (w_bytes + warp_bytes > kSmemLimit) return 0;
  const size_t warps = (kSmemLimit - w_bytes) / warp_bytes;
  return static_cast<int>(warps < kMaxWarps ? warps : kMaxWarps);
}

// Part J of bf16x2 pairs of (u, q, i), each product rounded to bf16.
template <int J>
__device__ __forceinline__ __nv_bfloat162 part_bf16(__nv_bfloat162 x,
                                                    __nv_bfloat162 y,
                                                    __nv_bfloat162 z) {
  if constexpr (J == 0) return x;
  if constexpr (J == 1) return y;
  if constexpr (J == 2) return z;
  if constexpr (J == 3) return __hmul2(x, y);
  if constexpr (J == 4) return __hmul2(y, z);
  if constexpr (J == 5) return __hmul2(z, x);
  return __hmul2(__hmul2(x, y), z);
}

// acc[n] += part J [16 edges, 16 features] . W's fragments wj of the k
// step (NT n8 tiles). x, y, z hold the A-fragment pairs of u, q, i.
template <int J, int NT>
__device__ __forceinline__ void part_product_bf16(
    const __nv_bfloat162 (&x)[4], const __nv_bfloat162 (&y)[4],
    const __nv_bfloat162 (&z)[4], const uint2* __restrict__ wj,
    float (&acc)[NT][4]) {
  unsigned a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = bf16x2_bits(part_bf16<J>(x[r], y[r], z[r]));
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint2 bf = wj[n * 32];
    mma_bf16(acc[n], a, bf.x, bf.y);
  }
}

// The bf16 form (see the top of the file). blockDim.x is 32 times the warps
// of bf16_warps; dynamic shared memory holds W's fragments, then each
// warp's ring.
template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(32 * kMaxWarps)
interact_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ it,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         __nv_bfloat16* __restrict__ out,
                         const int* __restrict__ pi,
                         __nv_bfloat16* __restrict__ out2, int edges, int d,
                         int cols) {
  constexpr int P = parts_of<ORDER>();
  constexpr int NT = OUT / 8;             // n8 tiles of the output
  constexpr int TE = kTileEdges;
  constexpr int SO = bf16_row(OUT);       // staged output row
  constexpr int C8 = OUT / 8;             // 16-byte vectors an output row
  const int sd = bf16_row(d);             // staged role row
  const int kb = (d + 15) >> 4;           // k16 steps a part
  const int v8 = d >> 3;                  // 16-byte vectors a role row
  const int stage = bf16_stage(d, OUT);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ float4 smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);  // [P kb][NT][32] fragments
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(wf + static_cast<size_t>(P) * kb *
                                                NT * 32) +
      static_cast<size_t>(warp) * kStages * stage;

  const int tiles = (edges + TE - 1) / TE;
  const int stride = gridDim.x * warps;
  const int first = blockIdx.x * warps + warp;

  // tile `tile` into stage `slot`: u, q and i rows (ABSORB: i at row
  // e_pi); rows past the last edge are zero-filled. Commits one group,
  // empty past the last tile.
  auto issue = [&](int tile, int slot) {
    if (tile < tiles) {
      __nv_bfloat16* buf = ring + slot * stage;
      const int e0 = tile * TE;
      for (int c = lane; c < TE * v8; c += 32) {
        const int r = c / v8;
        const int v = c - r * v8;
        const int e = e0 + r;
        const bool valid = e < edges;
        const size_t at = static_cast<size_t>(e) * d + 8 * v;
        const int ei = ABSORB && valid ? e - e % cols + __ldg(pi + e) : e;
        __nv_bfloat16* dst = buf + r * sd + 8 * v;
        cp_async16(dst, valid ? u + at : u, valid);
        cp_async16(dst + TE * sd, valid ? q + at : q, valid);
        cp_async16(dst + 2 * TE * sd,
                   valid ? it + static_cast<size_t>(ei) * d + 8 * v : it,
                   valid);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(first + s * stride, s);

  // W's fragments: k step ks = j kb + kf, n8 tile n, lane l holds
  // b0 = W[j d + f][8 n + g], W[j d + f + 1][8 n + g] and b1 the same at
  // f + 8, f + 9, for f = 16 kf + 2 t; rows past the part's d are zero
  for (int idx = threadIdx.x; idx < P * kb * NT * 32; idx += blockDim.x) {
    const int l = idx & 31;
    const int n = (idx >> 5) % NT;
    const int ks = (idx >> 5) / NT;
    const int j = ks / kb;
    const int f = 16 * (ks - j * kb) + 2 * (l & 3);
    const float* wc = w + static_cast<size_t>(j) * d * OUT + 8 * n + (l >> 2);
    auto wv = [&](int ff) {
      return ff < d ? __ldg(wc + static_cast<size_t>(ff) * OUT) : 0.f;
    };
    wf[idx] = make_uint2(pack_bf16(wv(f), wv(f + 1)),
                         pack_bf16(wv(f + 8), wv(f + 9)));
  }
  float bias[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    bias[n][0] = __ldg(b + 8 * n + 2 * t);
    bias[n][1] = __ldg(b + 8 * n + 2 * t + 1);
  }
  __syncthreads();  // W's fragments are staged

  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  int step = 0;
  for (int tile = first; tile < tiles; tile += stride, ++step) {
    issue(tile + (kStages - 1) * stride, (step + kStages - 1) % kStages);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // the tile has landed for every lane
    __nv_bfloat16* buf = ring + (step % kStages) * stage;
    const __nv_bfloat16* us = buf;
    const __nv_bfloat16* qs = us + TE * sd;
    const __nv_bfloat16* is = qs + TE * sd;

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int kf = 0; kf < kb; ++kf) {
      // the A pairs: rows g, g + 8 at features f, f + 1 (registers 0, 1)
      // and f + 8, f + 9 (2, 3), for f = 16 kf + 2 t
      const bool hi = 16 * kf + 8 < d;
      const int at = g * sd + 16 * kf + 2 * t;
      const int off[4] = {at, at + 8 * sd, at + 8, at + 8 * sd + 8};
      __nv_bfloat162 x[4], y[4], z[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool on = r < 2 || hi;
        x[r] = on ? *reinterpret_cast<const __nv_bfloat162*>(us + off[r])
                  : zero;
        y[r] = on ? *reinterpret_cast<const __nv_bfloat162*>(qs + off[r])
                  : zero;
        z[r] = on ? *reinterpret_cast<const __nv_bfloat162*>(is + off[r])
                  : zero;
      }
      const uint2* wk = wf + static_cast<size_t>(kf) * NT * 32 + lane;
      const size_t part_step = static_cast<size_t>(kb) * NT * 32;
      part_product_bf16<0, NT>(x, y, z, wk, acc);
      part_product_bf16<1, NT>(x, y, z, wk + part_step, acc);
      part_product_bf16<2, NT>(x, y, z, wk + 2 * part_step, acc);
      if constexpr (P >= 6) {
        part_product_bf16<3, NT>(x, y, z, wk + 3 * part_step, acc);
        part_product_bf16<4, NT>(x, y, z, wk + 4 * part_step, acc);
        part_product_bf16<5, NT>(x, y, z, wk + 5 * part_step, acc);
      }
      if constexpr (P >= 7)
        part_product_bf16<6, NT>(x, y, z, wk + 6 * part_step, acc);
    }

    // out = acc + b rounded to bf16, through the stage as a [TE][SO] tile,
    // then whole rows, 16 bytes a lane
    __syncwarp();
    __nv_bfloat16* ot = buf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<unsigned*>(ot + g * SO + c) =
          pack_bf16(acc[n][0] + bias[n][0], acc[n][1] + bias[n][1]);
      *reinterpret_cast<unsigned*>(ot + (g + 8) * SO + c) =
          pack_bf16(acc[n][2] + bias[n][0], acc[n][3] + bias[n][1]);
    }
    __syncwarp();
    const int e0 = tile * TE;
#pragma unroll
    for (int c = lane; c < TE * C8; c += 32) {
      const int r = c / C8;
      const int v = c % C8;
      const int e = e0 + r;
      if (e < edges) {
        const uint4 val = *reinterpret_cast<const uint4*>(ot + r * SO + 8 * v);
        reinterpret_cast<uint4*>(out + static_cast<size_t>(e) * OUT)[v] = val;
        if (ABSORB) {
          const int e2 = e - e % cols + __ldg(pi + e);
          reinterpret_cast<uint4*>(out2 + static_cast<size_t>(e2) * OUT)[v] =
              val;
        }
      }
    }
    __syncwarp();  // the stage is read before the ring refills it
  }
}

// Persistent grid: as many blocks as `needed`, at most those resident.
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

struct Args {
  const void* u;
  const void* q;
  const void* i;
  const void* w;
  const void* b;
  void* out;
  const void* pi;    // ABSORB only
  void* out2;        // ABSORB only
  int edges;
  int d;
  int cols;          // ABSORB only
};

template <int OUT, int ORDER, bool ABSORB>
cudaError_t launch(const Args& a, bool cores, cudaStream_t stream) {
  constexpr int P = parts_of<ORDER>();
  const int warps = cores ? 0 : mma_warps(a.d, OUT, P);
  const void* kernel;
  int threads;
  size_t smem;
  long long needed;
  if (warps > 0) {
    kernel = reinterpret_cast<const void*>(
        interact_fwd_mma_kernel<OUT, ORDER, ABSORB>);
    threads = 32 * warps;
    smem = w_fragment_bytes(a.d, OUT, P) +
           static_cast<size_t>(warps) * kStages * stage_floats(a.d, OUT) *
               sizeof(float);
    const long long tiles =
        (static_cast<long long>(a.edges) + kTileEdges - 1) / kTileEdges;
    needed = (tiles + warps - 1) / warps;
  } else {
    kernel = reinterpret_cast<const void*>(
        interact_fwd_cores_kernel<OUT, ORDER, ABSORB>);
    threads = kCoreThreads;
    smem = static_cast<size_t>(P) * a.d * OUT * sizeof(float);
    needed = (static_cast<long long>(a.edges) + kCoreThreads - 1) /
             kCoreThreads;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = resident_blocks(kernel, threads, smem, needed, &blocks);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it as the return value
    return err;
  }
  const float* u = static_cast<const float*>(a.u);
  const float* q = static_cast<const float*>(a.q);
  const float* i = static_cast<const float*>(a.i);
  const float* w = static_cast<const float*>(a.w);
  const float* b = static_cast<const float*>(a.b);
  float* out = static_cast<float*>(a.out);
  const int* pi = static_cast<const int*>(a.pi);
  float* out2 = static_cast<float*>(a.out2);
  if (warps > 0)
    interact_fwd_mma_kernel<OUT, ORDER, ABSORB>
        <<<blocks, threads, smem, stream>>>(u, q, i, w, b, out, pi, out2,
                                            a.edges, a.d, a.cols);
  else
    interact_fwd_cores_kernel<OUT, ORDER, ABSORB>
        <<<blocks, threads, smem, stream>>>(u, q, i, w, b, out, pi, out2,
                                            a.edges, a.d, a.cols);
  return cudaGetLastError();
}

template <int OUT, bool ABSORB>
cudaError_t launch_order(int order, const Args& a, bool cores,
                         cudaStream_t stream) {
  switch (order) {
    case 1: return launch<OUT, 1, ABSORB>(a, cores, stream);
    case 2: return launch<OUT, 2, ABSORB>(a, cores, stream);
    case 3: return launch<OUT, 3, ABSORB>(a, cores, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ABSORB>
int launch_out(const Args& a, int out_dim, int order, bool cores,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ABSORB && (a.cols <= 0 || a.edges % a.cols != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (out_dim) {
    case 8: err = launch_order<8, ABSORB>(order, a, cores, s); break;
    case 16: err = launch_order<16, ABSORB>(order, a, cores, s); break;
    case 32: err = launch_order<32, ABSORB>(order, a, cores, s); break;
    case 64: err = launch_order<64, ABSORB>(order, a, cores, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

template <int OUT, int ORDER, bool ABSORB>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int P = parts_of<ORDER>();
  const int d = a.d;
  const int warps = bf16_warps(d, OUT, P);
  if (warps == 0) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(
      interact_fwd_bf16_kernel<OUT, ORDER, ABSORB>);
  const size_t smem = bf16_w_bytes(d, OUT, P) +
                      static_cast<size_t>(warps) * kStages *
                          bf16_stage(d, OUT) * sizeof(__nv_bfloat16);
  const long long tiles =
      (static_cast<long long>(a.edges) + kTileEdges - 1) / kTileEdges;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = resident_blocks(kernel, 32 * warps, smem, (tiles + warps - 1) / warps,
                          &blocks);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it as the return value
    return err;
  }
  interact_fwd_bf16_kernel<OUT, ORDER, ABSORB>
      <<<blocks, 32 * warps, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(a.u),
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const __nv_bfloat16*>(a.i),
          static_cast<const float*>(a.w), static_cast<const float*>(a.b),
          static_cast<__nv_bfloat16*>(a.out), static_cast<const int*>(a.pi),
          static_cast<__nv_bfloat16*>(a.out2), a.edges, d, a.cols);
  return cudaGetLastError();
}

template <int OUT, bool ABSORB>
cudaError_t launch_bf16_order(int order, const Args& a, cudaStream_t stream) {
  switch (order) {
    case 1: return launch_bf16<OUT, 1, ABSORB>(a, stream);
    case 2: return launch_bf16<OUT, 2, ABSORB>(a, stream);
    case 3: return launch_bf16<OUT, 3, ABSORB>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 form for out_dim (ABSORB: K5, as launch_out checks its grid).
template <bool ABSORB>
int launch_bf16_out(const Args& a, int out_dim, int order, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ABSORB && (a.cols <= 0 || a.edges % a.cols != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (out_dim) {
    case 8: err = launch_bf16_order<8, ABSORB>(order, a, s); break;
    case 16: err = launch_bf16_order<16, ABSORB>(order, a, s); break;
    case 32: err = launch_bf16_order<32, ABSORB>(order, a, s); break;
    case 64: err = launch_bf16_order<64, ABSORB>(order, a, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when the tensor-core form takes (d, out_dim, order), 0 when the
// f32-core form does.
extern "C" int ihgnn_interact_fwd_form(int d, int out_dim, int order) {
  return mma_warps(d, out_dim, order == 1 ? 3 : (order == 2 ? 6 : 7)) > 0;
}

extern "C" int ihgnn_interact_fwd(const void* u, const void* q, const void* i,
                                  const void* w, const void* b, void* out,
                                  int edges, int d, int out_dim, int order,
                                  void* stream) {
  return launch_out<false>(Args{u, q, i, w, b, out, nullptr, nullptr, edges,
                                d, 1},
                           out_dim, order, false, stream);
}

// K5 forward: i_t1 read through pi [edges / cols, cols]; out2 = rho(out).
extern "C" int ihgnn_interact_fwd_absorb(const void* u, const void* q,
                                         const void* i_t1, const void* pi,
                                         const void* w, const void* b,
                                         void* out, void* out2, int edges,
                                         int d, int out_dim, int order,
                                         int cols, void* stream) {
  return launch_out<true>(Args{u, q, i_t1, w, b, out, pi, out2, edges, d,
                               cols},
                          out_dim, order, false, stream);
}

// The same two functions in the f32-core form whatever the shape: its
// card tests, and its time beside the tensor-core form's.
extern "C" int ihgnn_interact_fwd_cores(const void* u, const void* q,
                                        const void* i, const void* w,
                                        const void* b, void* out, int edges,
                                        int d, int out_dim, int order,
                                        void* stream) {
  return launch_out<false>(Args{u, q, i, w, b, out, nullptr, nullptr, edges,
                                d, 1},
                           out_dim, order, true, stream);
}

extern "C" int ihgnn_interact_fwd_absorb_cores(
    const void* u, const void* q, const void* i_t1, const void* pi,
    const void* w, const void* b, void* out, void* out2, int edges, int d,
    int out_dim, int order, int cols, void* stream) {
  return launch_out<true>(Args{u, q, i_t1, w, b, out, pi, out2, edges, d,
                               cols},
                          out_dim, order, true, stream);
}

// The bf16 form: u/q/i [edges, d] bf16, W [parts * d, out_dim] f32, b
// [out_dim] f32, out [edges, out_dim] bf16. Refused (cudaErrorInvalidValue)
// for a shape the form does not take (bf16_warps).
extern "C" int ihgnn_interact_fwd_bf16(const void* u, const void* q,
                                       const void* i, const void* w,
                                       const void* b, void* out, int edges,
                                       int d, int out_dim, int order,
                                       void* stream) {
  return launch_bf16_out<false>(Args{u, q, i, w, b, out, nullptr, nullptr,
                                     edges, d, 1},
                                out_dim, order, stream);
}

// K5 forward's bf16 form: u/q/i_t1 [edges, d] bf16, pi as
// ihgnn_interact_fwd_absorb; out and out2 [edges, out_dim] bf16.
extern "C" int ihgnn_interact_fwd_absorb_bf16(
    const void* u, const void* q, const void* i_t1, const void* pi,
    const void* w, const void* b, void* out, void* out2, int edges, int d,
    int out_dim, int order, int cols, void* stream) {
  return launch_bf16_out<true>(Args{u, q, i_t1, w, b, out, pi, out2, edges,
                                    d, cols},
                               out_dim, order, stream);
}
