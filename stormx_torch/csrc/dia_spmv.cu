// K2a: banded (DIA) sparse matrix-vector product z = A·x for Hopper
// (sm_90a), optionally with the dot product <x, z> in the same pass.
//
// Replaces the TPU kernel stormx/ops/pallas_dia.py:_spmv_kernel (driven by
// _spmv_call from dia_spmv and dia_spmv_dots).  Same function:
//     z[i] = Σ_d data[d, i] · x[i + off_d]
// with x read as zero outside [0, n_cols): the index is masked, so a
// diagonal entry whose column falls outside the band contributes nothing,
// whatever its stored value, and no read leaves x.  The diagonals are added
// in offset order with one FMA each, in the type of the data (float or
// double), as acc_dtype in the TPU kernel.
//
// Bound on this card: memory.  One apply must read the D diagonals, read x
// once and write z once: 4·(D+2)·n bytes in float32.  For the 5-point
// Poisson operator on a 2048² grid that is 117.4 MB, 35.0 µs at 3.35 TB/s
// (data sheet), for 2·D·n flops — 0.4 flop/byte, far under the float32
// ridge.
//
// Design: one thread per row over a grid-stride loop.  For each diagonal
// the 32 threads of a warp read 32 neighbouring data[d, i] (one 128-byte
// line) and 32 neighbouring x[i + off_d] through the read-only path.  The D
// shifted reads of x mostly hit L1/L2: neighbouring offsets share lines,
// and the whole x (16.8 MB at 2048²) fits the 50 MB L2, so device memory
// sees close to one read of x.  The TPU kernel's halo-padded copy of x, its
// (rows, 128) lane tiling and its shift-matrix matmuls are not carried over.
// Staging x plus its halo in shared memory is later work.
//
// The dot product: each block reduces its threads' partial sums and writes
// one partial; a second launch sums the partials in a fixed order
// (reduce.cuh).  No atomics, so CG's iteration count does not change from
// run to run.

#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

using stormx::kFinalThreads;
using stormx::kThreads;

constexpr int kMaxDiags = 64;

struct Offsets {
  int64_t v[kMaxDiags];  // 512 bytes of kernel parameters
};

template <typename T, bool kDot>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ z, T* __restrict__ partials, int64_t n_rows,
                    int64_t n_cols, int n_diags, Offsets offs) {
  T dot = T(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    T acc = T(0);
    for (int d = 0; d < n_diags; ++d) {
      const int64_t j = i + offs.v[d];
      if (j >= 0 && j < n_cols) acc = fma(__ldg(data + d * n_rows + i), __ldg(x + j), acc);
    }
    z[i] = acc;
    if (kDot) dot = fma(__ldg(x + i), acc, dot);
  }
  if (kDot) {
    dot = stormx::block_sum(dot);
    if (threadIdx.x == 0) partials[blockIdx.x] = dot;
  }
}

template <typename T>
int launch(const void* data, const void* x, void* z, void* partials, void* dot,
           int64_t n_rows, int64_t n_cols, int n_diags, const int64_t* offsets,
           int blocks, cudaStream_t stream) {
  if (n_diags < 1 || n_diags > kMaxDiags || blocks < 1) return cudaErrorInvalidValue;
  Offsets offs;
  for (int d = 0; d < n_diags; ++d) offs.v[d] = offsets[d];
  const T* d_ = static_cast<const T*>(data);
  const T* x_ = static_cast<const T*>(x);
  T* z_ = static_cast<T*>(z);
  if (partials == nullptr) {
    dia_spmv_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        d_, x_, z_, nullptr, n_rows, n_cols, n_diags, offs);
    return static_cast<int>(cudaGetLastError());
  }
  T* p_ = static_cast<T*>(partials);
  dia_spmv_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
      d_, x_, z_, p_, n_rows, n_cols, n_diags, offs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stormx::sum_partials_kernel<T><<<1, kFinalThreads, 0, stream>>>(p_, blocks,
                                                                  static_cast<T*>(dot));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// data (n_diags, n_rows), x (n_cols,), z (n_rows,): contiguous, all float32
// (is_double = 0) or all float64, on the current device.  offsets: n_diags
// host int64 values.  With partials (blocks,) and dot (0-d) given, also
// writes dot = <x, z> (square operators only); pass null for both otherwise.
int stormx_dia_spmv(const void* data, const void* x, void* z, void* partials,
                    void* dot, int64_t n_rows, int64_t n_cols, int n_diags,
                    const void* offsets, int blocks, int is_double, void* stream) {
  const int64_t* offs = static_cast<const int64_t*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(data, x, z, partials, dot, n_rows, n_cols,
                                    n_diags, offs, blocks, s)
                   : launch<float>(data, x, z, partials, dot, n_rows, n_cols,
                                   n_diags, offs, blocks, s);
}

}  // extern "C"
