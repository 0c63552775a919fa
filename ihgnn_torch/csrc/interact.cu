// K3 interact_fwd: fused hyperedge feature interaction, forward.
//
//   out[e, :] = b + sum_j part_j[e, :] . W[j*d:(j+1)*d, :]
//   parts: [u, q, i] (order 1), + [u*q, q*i, i*u] (order 2), + [u*q*i] (3)
//
// Replaces ihgnn_tpu/ops/pallas/interact.py interact_fwd (interact.py:319),
// and the o1 output of interact_fwd_absorb (:397). The TPU kernel stacks
// the parts of a 2048-edge block in VMEM and runs one bf16 MXU matmul;
// this kernel keeps them in registers and accumulates in f32.
//
// Bound on the H100: arithmetic at order 3, memory at order 1. Per edge it
// reads 3d floats and writes `out` floats, and does 2 * parts * d * out
// FLOPs (14,336 at order 3, d = out = 32), on the f32 CUDA cores: no
// tensor-core type keeps f32 accuracy. W (parts * d * out floats, 28 KB at
// order 3) is staged once per block in shared memory; every thread of a
// warp reads the same W vector, so the reads are broadcasts. Each thread
// owns one edge: it loads its u/q/i rows four features at a time, forms
// the parts for those features in registers and FMAs them into `out`
// accumulators. Blocks are persistent (as many as fit on the SMs) so W is
// loaded once per resident block. The ragged tail of E is masked.
//
// Layout: u/q/i [E, d] f32 row-major (d % 4 == 0), W [parts * d, out] f32,
// b [out] f32, out [E, out] f32; out is one of 8, 16, 32, 64.
//
// ABSORB (K5, interact_fwd_absorb, interact.py:397): the routed path's
// absorbed interaction. The edges are an [R, C] grid in sigma order and i
// arrives one row-local stage early (t1 order); pi [R, C] int32 is that
// stage (i's stage 2 composed with sigma) and rho = pi^-1 row-locally. The
// kernel reads i through pi, i_sigma[r C + c] = i_t1[r C + pi[r, c]], and
// writes o1 = out as above and a second output o2 = rho(o1), the first
// stage of the scatter's i chain, as a scatter store
// o2[r C + pi[r, c]] = o1[r C + c]: each position is written once. On the
// TPU pi and rho had to nest inside the kernel's VMEM block; here each is
// one index load an edge. The load of i and the store of o2 are whole
// rows, so the bound is K3's plus one more [E, out] write.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int ORDER>
__host__ __device__ constexpr int parts_of() {
  return ORDER == 1 ? 3 : (ORDER == 2 ? 6 : 7);
}

template <int OUT, int ORDER, bool ABSORB>
__global__ void __launch_bounds__(kThreads)
interact_fwd_kernel(const float* __restrict__ u, const float* __restrict__ q,
                    const float* __restrict__ it, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    const int* __restrict__ pi, float* __restrict__ out2,
                    int edges, int d, int cols) {
  constexpr int P = parts_of<ORDER>();
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);
  const int wn = P * d * OUT;
  for (int t = threadIdx.x; t < wn; t += kThreads) ws[t] = w[t];
  __syncthreads();

  const int vecs = d / 4;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < edges;
       e += gridDim.x * kThreads) {
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

template <int OUT, int ORDER, bool ABSORB>
cudaError_t launch(const void* u, const void* q, const void* i, const void* w,
                   const void* b, void* out, const void* pi, void* out2,
                   int edges, int d, int cols, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(parts_of<ORDER>()) * d * OUT * sizeof(float);
  auto kernel = interact_fwd_kernel<OUT, ORDER, ABSORB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller gets it as the return value
    return err;
  }
  const long long needed = (static_cast<long long>(edges) + kThreads - 1) /
                           kThreads;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(q),
      static_cast<const float*>(i), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out),
      static_cast<const int*>(pi), static_cast<float*>(out2), edges, d, cols);
  return cudaGetLastError();
}

template <int OUT, bool ABSORB>
cudaError_t launch_order(int order, const void* u, const void* q,
                         const void* i, const void* w, const void* b,
                         void* out, const void* pi, void* out2, int edges,
                         int d, int cols, cudaStream_t stream) {
  switch (order) {
    case 1: return launch<OUT, 1, ABSORB>(u, q, i, w, b, out, pi, out2, edges,
                                          d, cols, stream);
    case 2: return launch<OUT, 2, ABSORB>(u, q, i, w, b, out, pi, out2, edges,
                                          d, cols, stream);
    case 3: return launch<OUT, 3, ABSORB>(u, q, i, w, b, out, pi, out2, edges,
                                          d, cols, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ABSORB>
int launch_out(const void* u, const void* q, const void* i, const void* w,
               const void* b, void* out, const void* pi, void* out2,
               int edges, int d, int out_dim, int order, int cols,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (out_dim) {
    case 8: err = launch_order<8, ABSORB>(order, u, q, i, w, b, out, pi, out2,
                                          edges, d, cols, s); break;
    case 16: err = launch_order<16, ABSORB>(order, u, q, i, w, b, out, pi,
                                            out2, edges, d, cols, s); break;
    case 32: err = launch_order<32, ABSORB>(order, u, q, i, w, b, out, pi,
                                            out2, edges, d, cols, s); break;
    case 64: err = launch_order<64, ABSORB>(order, u, q, i, w, b, out, pi,
                                            out2, edges, d, cols, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_interact_fwd(const void* u, const void* q, const void* i,
                                  const void* w, const void* b, void* out,
                                  int edges, int d, int out_dim, int order,
                                  void* stream) {
  return launch_out<false>(u, q, i, w, b, out, nullptr, nullptr, edges, d,
                           out_dim, order, 1, stream);
}

// K5 forward: i_t1 read through pi [edges / cols, cols]; out2 = rho(out).
extern "C" int ihgnn_interact_fwd_absorb(const void* u, const void* q,
                                         const void* i_t1, const void* pi,
                                         const void* w, const void* b,
                                         void* out, void* out2, int edges,
                                         int d, int out_dim, int order,
                                         int cols, void* stream) {
  if (cols <= 0 || edges % cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_out<true>(u, q, i_t1, w, b, out, pi, out2, edges, d, out_dim,
                          order, cols, stream);
}
