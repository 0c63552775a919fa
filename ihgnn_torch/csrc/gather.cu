// K2 gather_roles: the three endpoint rows of every hyperedge.
//
//   out_r[e, :] = x[i3[e, r], :]     for r in {u, q, i}
//
// Replaces ihgnn_tpu/ops/pallas/gather.py windowed_gather (gather.py:188)
// and windowed_gather_t (:374), together with the Clos permute stages of
// ops/pallas/permute.py that follow them on the TPU. The TPU cannot gather
// rows, so it expands banded windows with one-hot matmuls and routes the
// result through permutation stages; their composition is x[i3[:, r]],
// which this kernel computes directly.
//
// Bound on the H100: memory. The kernel does no arithmetic: it reads i3
// and 3E rows of x and writes 3E rows. Each thread copies one 16-byte
// vector; d / 4 neighbouring threads copy one row, so reads of a row and
// writes of the outputs are coalesced. The copy is exact.
//
// Layout: x [N, d] f32 row-major (d % 4 == 0, 16-byte aligned),
// i3 [E, 3] int32, out_u/out_q/out_i [E, d] f32.
//
// The routed path's single-index forms, same bound and design:
//
//   gather_rows:   out[k, :] = x[idx[k], :]                 (k < R * C)
//   gather_rows_t: out[c, r, :] = x[idx[r * C + c], :]      (out [C, R, d])
//
// They replace windowed_gather and windowed_gather_t themselves: the TPU's
// banded expand of the role-sorted ids (u composed with the sigma order,
// q and i with their first Clos stage). The index table holds the absolute
// source row, so the window offsets of the TPU pack are folded in. The
// transposed form writes in order and reads idx with a stride of C.
//
// The bf16 form (ModelConfig.bf16_stream; the Pallas kernels' bf16 streams,
// whose gather copies bf16 rows, gather.py:82): the roles are bf16 copies
// of bf16 rows of x. An f32 x is first rounded to nearest even into a bf16
// table [N, d] (round_bf16_kernel, ihgnn_round_bf16: the cast of
// ops/hyperagg.py:1003-1007, which the JAX package makes before its
// gather; the wrapper allocates the table), so the copy reads 2 d-byte
// rows from a table of 2 N d bytes (44.8 MB at N = 700k, d = 32), which
// the 50 MB L2 mostly holds, where the f32 x (89.6 MB) does not fit. The
// copy (gather_roles_bf16_kernel) moves 16-byte vectors, eight features a
// thread, for d % 8 == 0 on 16-byte aligned rows, else 8-byte vectors for
// d % 4 == 0 on 8-byte aligned rows (bf16_vec_bytes, the rule of K1's
// bf16 lanes). A block reads its edges' ids once into shared memory,
// each thread copies its vector of the three roles (three loads in
// flight), and the roles are stored with the streaming hint (st.global.cs)
// so the 6E output rows do not push the table out of L2. Rounding is
// elementwise, so the roles are bit for bit those of rounding in the copy.
// Bound: bytes (x read once, in f32 or bf16, i3 read once, the roles
// written once in bf16).
//
// gather_scalars, the d = 1 form of gather_rows: out[k] = x[idx[k]] over
// f32 scalars. It replaces windowed_gather (gather.py:188) on the [1, N]
// streams of the routed GAT (ihgnn_tpu/ops/gatconv.py:300-330: the
// destination score s_dst, the segment max m, the denominators den and the
// backward's tsum, each expanded to the entries by destination). A thread
// writes four consecutive entries from one int4 of ids into one float4
// where idx and out are 16-byte aligned and the count is a multiple of 4,
// else one entry a thread. Bound: bytes (idx read and out written once;
// x, a few MB at N = 700k, is read through L2 and counted once). The copy
// is exact.
//
// gather_rows and gather_rows_t have the same bf16 forms (the routed pack's
// bf16 streams: windowed_gather's and windowed_gather_t's bf16 bodies,
// gather.py:162, :263, and their int8 byte-plane bodies, :82, :308, which
// copy bf16 rows exactly): the index arithmetic of the f32 form, each
// output quad rounded from an f32 x (the cast of the node rows at the
// gather's entry, ops/hyperagg.py:969-971, or of the node cotangent in a
// scatter's backward, :468, :628) or copied from a bf16 x.

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;

// Four features of a row of x as bf16: rounded from f32, or copied.
__device__ __forceinline__ uint2 bf16_quad(const float* x, size_t k) {
  return round_bf16x4(__ldg(reinterpret_cast<const float4*>(x) + k));
}

__device__ __forceinline__ uint2 bf16_quad(const __nv_bfloat16* x, size_t k) {
  return __ldg(reinterpret_cast<const uint2*>(x) + k);
}

// Output quad k of the single-index forms: an f32 copy, or bf16 (above).
__device__ __forceinline__ void put_quad(float4* out, long long t,
                                         const float4* x, long long k) {
  out[t] = x[k];
}

template <typename T>
__device__ __forceinline__ void put_quad(uint2* out, long long t, const T* x,
                                         long long k) {
  out[t] = bf16_quad(x, static_cast<size_t>(k));
}

// Tin/Tout: float4/float4 (f32), or float/uint2 and __nv_bfloat16/uint2
// (bf16 out); vecs = d / 4.
template <bool TRANSPOSED, typename Tin, typename Tout>
__global__ void gather_rows_kernel(const Tin* __restrict__ x,
                                   const int* __restrict__ idx,
                                   Tout* __restrict__ out, int rows,
                                   int cols, int vecs) {
  const long long total = static_cast<long long>(rows) * cols * vecs;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= total) return;
  const int o = static_cast<int>(t / vecs);
  const int v = static_cast<int>(t - static_cast<long long>(o) * vecs);
  int k = o;                       // the entry of idx this output row reads
  if (TRANSPOSED) {                // o = c * R + r  ->  k = r * C + c
    const int c = o / rows;
    k = (o - c * rows) * cols + c;
  }
  put_quad(out, t, x, static_cast<long long>(idx[k]) * vecs + v);
}

template <bool TRANSPOSED, typename Tin = float4, typename Tout = float4>
int launch_gather_rows(const void* x, const void* idx, void* out, int rows,
                       int cols, int d, void* stream) {
  const int vecs = d / 4;
  const long long total = static_cast<long long>(rows) * cols * vecs;
  if (total == 0) return 0;
  if (total / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads);
  gather_rows_kernel<TRANSPOSED, Tin, Tout>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Tin*>(x), static_cast<const int*>(idx),
          static_cast<Tout*>(out), rows, cols, vecs);
  return static_cast<int>(cudaGetLastError());
}

__global__ void gather_roles_kernel(const float4* __restrict__ x,
                                    const int* __restrict__ i3,
                                    float4* __restrict__ out_u,
                                    float4* __restrict__ out_q,
                                    float4* __restrict__ out_i,
                                    int edges, int vecs) {
  const int role = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // < edges * vecs
  if (t >= edges * vecs) return;
  const int e = t / vecs;
  const int v = t - e * vecs;
  const int node = i3[3 * e + role];
  float4* out = role == 0 ? out_u : (role == 1 ? out_q : out_i);
  out[t] = x[static_cast<size_t>(node) * vecs + v];
}

// x [n] f32 rounded to bf16 (nearest even), four values a thread.
__global__ void round_bf16_kernel(const float4* __restrict__ x,
                                  uint2* __restrict__ out, long long quads) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t < quads) out[t] = round_bf16x4(__ldg(x + t));
}

// The bf16 form's copy: out_r [E, d] bf16 from bf16 x, V = uint4 (eight
// features) or uint2 (four); vecs = vectors a row. A block copies kThreads
// consecutive vectors of the [E, vecs] grid, the ids of their edges staged
// once in shared memory.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_roles_bf16_kernel(const V* __restrict__ x, const int* __restrict__ i3,
                         V* __restrict__ out_u, V* __restrict__ out_q,
                         V* __restrict__ out_i, int edges, int vecs) {
  __shared__ int ids[3 * kThreads];
  const long long total = static_cast<long long>(edges) * vecs;
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int e_first = static_cast<int>(t0 / vecs);
  const int e_last = static_cast<int>(
      (min(t0 + kThreads, total) - 1) / vecs);
  const int n_ids = 3 * (e_last - e_first + 1);
  for (int k = threadIdx.x; k < n_ids; k += kThreads)
    ids[k] = __ldg(i3 + 3LL * e_first + k);
  __syncthreads();
  const long long t = t0 + threadIdx.x;
  if (t >= total) return;
  const int* id = ids + 3 * (static_cast<int>(t / vecs) - e_first);
  const int v = static_cast<int>(t % vecs);
  const V a = __ldg(x + static_cast<size_t>(id[0]) * vecs + v);
  const V b = __ldg(x + static_cast<size_t>(id[1]) * vecs + v);
  const V c = __ldg(x + static_cast<size_t>(id[2]) * vecs + v);
  __stcs(out_u + t, a);
  __stcs(out_q + t, b);
  __stcs(out_i + t, c);
}

__global__ void gather_scalars_kernel(const float* __restrict__ x,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out, long long n) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t < n) out[t] = __ldg(x + idx[t]);
}

__global__ void gather_scalars4_kernel(const float* __restrict__ x,
                                       const int4* __restrict__ idx,
                                       float4* __restrict__ out,
                                       long long quads) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= quads) return;
  const int4 k = __ldg(idx + t);
  out[t] = make_float4(__ldg(x + k.x), __ldg(x + k.y), __ldg(x + k.z),
                       __ldg(x + k.w));
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The copy's vector width: 16 bytes for d % 8 == 0 with x and the three
// outputs 16-byte aligned, else 8 for d % 4 == 0 with all 8-byte aligned,
// else 0 (refused); the wrapper applies the same rule (ops/segsum.py
// bf16_form, K1's lane rule).
int bf16_vec_bytes(int d, const void* x, const void* ou, const void* oq,
                   const void* oi) {
  auto all = [&](int bytes) {
    return aligned(x, bytes) && aligned(ou, bytes) && aligned(oq, bytes) &&
           aligned(oi, bytes);
  };
  if (d % 8 == 0 && all(16)) return 16;
  if (d % 4 == 0 && all(8)) return 8;
  return 0;
}

template <typename V>
int launch_roles_bf16(const void* x, const void* i3, void* ou, void* oq,
                      void* oi, int edges, int vecs, cudaStream_t stream) {
  const long long total = static_cast<long long>(edges) * vecs;
  if (total == 0) return 0;
  if (total / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  gather_roles_bf16_kernel<V>
      <<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads,
         0, stream>>>(static_cast<const V*>(x), static_cast<const int*>(i3),
                      static_cast<V*>(ou), static_cast<V*>(oq),
                      static_cast<V*>(oi), edges, vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_gather_roles(const void* x, const void* i3, void* out_u,
                                  void* out_q, void* out_i, int edges, int d,
                                  void* stream) {
  const int vecs = d / 4;
  const int total = edges * vecs;
  const dim3 grid((total + kThreads - 1) / kThreads, 3);
  gather_roles_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(i3),
      static_cast<float4*>(out_u), static_cast<float4*>(out_q),
      static_cast<float4*>(out_i), edges, vecs);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: out_u/out_q/out_i [E, d] bf16 copied from bf16 rows x
// [N, d] (x_bf16 == 1), at the vector width of bf16_vec_bytes. An f32 x
// (x_bf16 == 0) is refused: it is rounded first, by ihgnn_round_bf16 into
// a bf16 table (the wrapper does), whose rows this copies. The argument
// list is the one of the form that rounded in the copy, so that builds of
// both run side by side.
extern "C" int ihgnn_gather_roles_bf16(const void* x, int x_bf16,
                                       const void* i3, void* out_u,
                                       void* out_q, void* out_i, int edges,
                                       int d, void* stream) {
  const int bytes = bf16_vec_bytes(d, x, out_u, out_q, out_i);
  if (!x_bf16 || bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bytes == 16
             ? launch_roles_bf16<uint4>(x, i3, out_u, out_q, out_i, edges,
                                        d / 8, s)
             : launch_roles_bf16<uint2>(x, i3, out_u, out_q, out_i, edges,
                                        d / 4, s);
}

// out [n] bf16 = x [n] f32 rounded to nearest even; n % 4 == 0, x 16-byte
// and out 8-byte aligned.
extern "C" int ihgnn_round_bf16(const void* x, void* out, long long n,
                                void* stream) {
  if (n % 4 != 0 || !aligned(x, 16) || !aligned(out, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = n / 4;
  if (quads == 0) return 0;
  if (quads / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  round_bf16_kernel<<<static_cast<unsigned>((quads + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<uint2*>(out), quads);
  return static_cast<int>(cudaGetLastError());
}

// out [R * C, d]: out[k] = x[idx[k]]
extern "C" int ihgnn_gather_rows(const void* x, const void* idx, void* out,
                                 int rows, int cols, int d, void* stream) {
  return launch_gather_rows<false>(x, idx, out, rows, cols, d, stream);
}

// out [C, R, d]: out[c, r] = x[idx[r * C + c]]
extern "C" int ihgnn_gather_rows_t(const void* x, const void* idx, void* out,
                                   int rows, int cols, int d, void* stream) {
  return launch_gather_rows<true>(x, idx, out, rows, cols, d, stream);
}

// The bf16 forms of the two: x f32 (x_bf16 == 0, rounded in the copy) or
// bf16 (x_bf16 == 1); out bf16, as above; d % 4 == 0.
extern "C" int ihgnn_gather_rows_bf16(const void* x, int x_bf16,
                                      const void* idx, void* out, int rows,
                                      int cols, int d, void* stream) {
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return x_bf16 ? launch_gather_rows<false, __nv_bfloat16, uint2>(
                      x, idx, out, rows, cols, d, stream)
                : launch_gather_rows<false, float, uint2>(x, idx, out, rows,
                                                          cols, d, stream);
}

extern "C" int ihgnn_gather_rows_t_bf16(const void* x, int x_bf16,
                                        const void* idx, void* out, int rows,
                                        int cols, int d, void* stream) {
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return x_bf16 ? launch_gather_rows<true, __nv_bfloat16, uint2>(
                      x, idx, out, rows, cols, d, stream)
                : launch_gather_rows<true, float, uint2>(x, idx, out, rows,
                                                         cols, d, stream);
}

// out [n] f32: out[k] = x[idx[k]] (the d = 1 form; see gather_scalars).
extern "C" int ihgnn_gather_scalars(const void* x, const void* idx,
                                    void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quad = n % 4 == 0 && aligned(idx, 16) && aligned(out, 16);
  const long long items = quad ? n / 4 : n;
  if (items / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) /
                                                kThreads);
  if (quad)
    gather_scalars4_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int4*>(idx),
        static_cast<float4*>(out), items);
  else
    gather_scalars_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx),
        static_cast<float*>(out), items);
  return static_cast<int>(cudaGetLastError());
}
