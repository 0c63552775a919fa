// K6/K7 permute_rows: row-local permutes and block transposes of an [R, C]
// grid of rows, one row-copy kernel for all four forms.
//
//   mode 0 (row-local):      out [R, C], out[r, c] = x[r, p[r, c]]
//   mode 1 (transpose):      out [C, R], out[c, r] = x[r, c]
//   mode 2 (transposed):     out [C, R], out[c, r] = x[r, p[r, c]]
//   mode 3 (pre-transposed): out [R, C], out[r, c] = x[p[c, r], c]
//                            (p is [C, R]: transpose, permute, transpose)
//
// Replaces ihgnn_tpu/ops/pallas/permute.py row_local_permute
// (permute.py:114) and its int8/hier/dg/bfly variants (K6), and
// block_transpose (:187), transposed_local_permute (:289) and
// transposed_local_permute_dg_pre (:980) with their variants (K7). On the
// TPU a permute is a one-hot matmul (or a dynamic gather) inside VMEM
// blocks and a transpose a tiled swap, because the TPU cannot address rows
// one by one. Here each output row names its source row from (mode, p) and
// copies it.
//
// Bound on the H100: memory. The kernel does no arithmetic; it reads each
// source row once, p once, and writes each output row once. A row is
// `vecs` 16-byte vectors (d = 32 f32: 8, a 128-byte line); each thread
// copies one vector and `vecs` neighbouring threads one row, so every row
// read and write is whole lines and the output is written in order. The
// transposed forms read rows C (or R) rows apart, a full line each, and
// read p with a stride: 4 bytes used of each 32-byte sector. A copy is
// exact in every dtype.
//
// Layout: x [R, C, row] row-major with rows of `vecs` 16-byte vectors,
// p int32 ([R, C] for modes 0 and 2, [C, R] for mode 3, null for mode 1),
// out as given above.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int MODE>
__global__ void __launch_bounds__(kThreads)
permute_rows_kernel(const uint4* __restrict__ x, const int* __restrict__ p,
                    uint4* __restrict__ out, int rows, int cols, int vecs) {
  const long long total = static_cast<long long>(rows) * cols * vecs;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= total) return;
  const int o = static_cast<int>(t / vecs);
  const int v = static_cast<int>(t - static_cast<long long>(o) * vecs);
  long long src;
  if (MODE == 0) {                 // o = r * C + c
    const int r = o / cols;
    src = static_cast<long long>(r) * cols + p[o];
  } else if (MODE == 1) {          // o = c * R + r
    const int c = o / rows;
    const int r = o - c * rows;
    src = static_cast<long long>(r) * cols + c;
  } else if (MODE == 2) {          // o = c * R + r
    const int c = o / rows;
    const int r = o - c * rows;
    src = static_cast<long long>(r) * cols +
          p[static_cast<long long>(r) * cols + c];
  } else {                         // o = r * C + c
    const int r = o / cols;
    const int c = o - r * cols;
    src = static_cast<long long>(p[static_cast<long long>(c) * rows + r]) *
              cols + c;
  }
  out[t] = x[src * vecs + v];
}

}  // namespace

extern "C" const char* ihgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ihgnn_permute_rows(const void* x, const void* p, void* out,
                                  int rows, int cols, int vecs, int mode,
                                  void* stream) {
  const long long total = static_cast<long long>(rows) * cols * vecs;
  if (rows <= 0 || cols <= 0 || vecs <= 0) return 0;
  if ((mode != 1 && p == nullptr) || total / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  const int* pi = static_cast<const int*>(p);
  uint4* ov = static_cast<uint4*>(out);
  switch (mode) {
    case 0: permute_rows_kernel<0><<<blocks, kThreads, 0, s>>>(
                xv, pi, ov, rows, cols, vecs); break;
    case 1: permute_rows_kernel<1><<<blocks, kThreads, 0, s>>>(
                xv, pi, ov, rows, cols, vecs); break;
    case 2: permute_rows_kernel<2><<<blocks, kThreads, 0, s>>>(
                xv, pi, ov, rows, cols, vecs); break;
    case 3: permute_rows_kernel<3><<<blocks, kThreads, 0, s>>>(
                xv, pi, ov, rows, cols, vecs); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
