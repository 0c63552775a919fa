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
// whose gather copies bf16 rows, gather.py:82): the roles are written as
// bf16, from x in f32 (each value rounded to nearest even in the copy, the
// cast of ops/hyperagg.py:1003-1007 fused into the gather) or in bf16 (an
// exact copy). Each thread moves four features: it reads a float4 (or 8
// bytes of bf16) and writes 8 bytes, d / 4 neighbouring threads a row, so
// the form takes d % 4 == 0. Bound: bytes, as above, with the writes (and a
// bf16 x's reads) at half width.
//
// gather_rows and gather_rows_t have the same bf16 forms (the routed pack's
// bf16 streams: windowed_gather's and windowed_gather_t's bf16 bodies,
// gather.py:162, :263, and their int8 byte-plane bodies, :82, :308, which
// copy bf16 rows exactly): the index arithmetic of the f32 form, each
// output quad rounded from an f32 x (the cast of the node rows at the
// gather's entry, ops/hyperagg.py:969-971, or of the node cotangent in a
// scatter's backward, :468, :628) or copied from a bf16 x.

#include <cuda_runtime.h>

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

// The bf16 form: out_r [E, d] bf16; quads = d / 4.
template <typename T>
__global__ void gather_roles_bf16_kernel(const T* __restrict__ x,
                                         const int* __restrict__ i3,
                                         uint2* __restrict__ out_u,
                                         uint2* __restrict__ out_q,
                                         uint2* __restrict__ out_i,
                                         int edges, int quads) {
  const int role = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // < edges * quads
  if (t >= edges * quads) return;
  const int e = t / quads;
  const int v = t - e * quads;
  const int node = i3[3 * e + role];
  uint2* out = role == 0 ? out_u : (role == 1 ? out_q : out_i);
  out[t] = bf16_quad(x, static_cast<size_t>(node) * quads + v);
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

// The bf16 form: x f32 (x_bf16 == 0, rounded in the copy) or bf16
// (x_bf16 == 1); out_u/out_q/out_i [E, d] bf16; d % 4 == 0.
extern "C" int ihgnn_gather_roles_bf16(const void* x, int x_bf16,
                                       const void* i3, void* out_u,
                                       void* out_q, void* out_i, int edges,
                                       int d, void* stream) {
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int quads = d / 4;
  const dim3 grid((edges * quads + kThreads - 1) / kThreads, 3);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint2* ou = static_cast<uint2*>(out_u);
  uint2* oq = static_cast<uint2*>(out_q);
  uint2* oi = static_cast<uint2*>(out_i);
  const int* idx = static_cast<const int*>(i3);
  if (x_bf16)
    gather_roles_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), idx, ou, oq, oi, edges, quads);
  else
    gather_roles_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), idx, ou, oq, oi, edges, quads);
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
