// K2b: the fused CG update for Hopper (sm_90a):
//     x' = x + α·p,   r' = r − α·z,   γ' = <r', r'>
//
// Replaces the TPU kernel stormx/ops/pallas_dia.py:_update_kernel (driven
// by cg_fused_update; cg_step composes it with K2a).  Same function, with
// the sum in the type of the data (float or double), as acc_dtype there.
// α is read on the device through a pointer to a 0-d tensor, so a loop of
// CG steps never waits for the host.
//
// Bound on this card: memory.  One pass must read x, r, p and z and write
// x' and r': 24·n bytes in float32, 100.7 MB and 30.0 µs at 3.35 TB/s (data
// sheet) for a 2048² grid, for 6·n flops.
//
// Design: one thread per element over a grid-stride loop; every read and
// write is coalesced, and nothing is read twice.  x' and r' go to new
// buffers, so no input is overwritten.  γ' uses the deterministic two-pass
// sum of reduce.cuh.

#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

using stormx::kFinalThreads;
using stormx::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_update_kernel(const T* __restrict__ alpha, const T* __restrict__ x,
                     const T* __restrict__ r, const T* __restrict__ p,
                     const T* __restrict__ z, T* __restrict__ x_out,
                     T* __restrict__ r_out, T* __restrict__ partials, int64_t n) {
  const T a = *alpha;
  T rr = T(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    x_out[i] = fma(a, __ldg(p + i), __ldg(x + i));
    const T rn = fma(-a, __ldg(z + i), __ldg(r + i));
    r_out[i] = rn;
    rr = fma(rn, rn, rr);
  }
  rr = stormx::block_sum(rr);
  if (threadIdx.x == 0) partials[blockIdx.x] = rr;
}

template <typename T>
int launch(const void* alpha, const void* x, const void* r, const void* p,
           const void* z, void* x_out, void* r_out, void* partials, void* rr,
           int64_t n, int blocks, cudaStream_t stream) {
  if (blocks < 1) return cudaErrorInvalidValue;
  T* p_ = static_cast<T*>(partials);
  cg_update_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(z), static_cast<T*>(x_out),
      static_cast<T*>(r_out), p_, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stormx::sum_partials_kernel<T><<<1, kFinalThreads, 0, stream>>>(p_, blocks,
                                                                  static_cast<T*>(rr));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// alpha (0-d), x, r, p, z (n,) in; x_out, r_out (n,), partials (blocks,)
// and rr (0-d) out.  All contiguous, all float32 (is_double = 0) or all
// float64, on the current device; the outputs must not alias the inputs.
int stormx_cg_update(const void* alpha, const void* x, const void* r, const void* p,
                     const void* z, void* x_out, void* r_out, void* partials,
                     void* rr, int64_t n, int blocks, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(alpha, x, r, p, z, x_out, r_out, partials, rr, n,
                                    blocks, s)
                   : launch<float>(alpha, x, r, p, z, x_out, r_out, partials, rr, n,
                                   blocks, s);
}

}  // extern "C"
