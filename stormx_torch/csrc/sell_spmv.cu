// K1: SlicedELL sparse matrix-vector product y = A·x for Hopper (sm_90a).
//
// Replaces the TPU kernel stormx/ops/pallas_sell.py:_kernel (driven by
// _apply and sell_matvec_pallas).  Same function: row r of block b has K
// slots (value, window-local column) and
//     y[R·b + r] = Σ_k val[b,k,r] · x[R·b − pad_lo + col[b,k,r]]
// with x read as zero outside [0, n_cols).
//
// Bound on this card: memory.  One apply must read the padded values and
// columns (8·nb·K·R bytes), x (4·n_cols) and write y (4·n_rows) for 2·nnz
// flops — about 0.1 flop/byte, far under the H100's float32 ridge
// (67 TFLOP/s over 3.35 TB/s, data sheet).
//
// Design: one thread per row.  The host lays values and columns out as
// (nb, K, R), so for each k the 32 threads of a warp read 32 neighbouring
// words (one 128-byte line).  x is read straight from global memory through
// the read-only path: after the bandwidth-reducing reorder the columns of a
// block of rows fall inside a window of a few thousand floats, so those
// reads hit L1/L2.  The TPU kernel's per-chunk masked loop (its way of
// emulating a gather) and the (nb, C) window matrix in device memory are not
// carried over.  Staging the window in shared memory is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void sell_spmv_kernel(const float* __restrict__ vals,
                                 const int32_t* __restrict__ cols,
                                 const float* __restrict__ x,
                                 float* __restrict__ y, int64_t n_rows,
                                 int64_t n_cols, int R, int K, int pad_lo) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int64_t b = row / R;
  const int64_t r = row - b * R;
  const int64_t slab = b * K * R + r;
  const int64_t base = b * R - pad_lo;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int64_t g = base + __ldg(cols + slab + static_cast<int64_t>(k) * R);
    const float xv = (g >= 0 && g < n_cols) ? __ldg(x + g) : 0.0f;
    acc = fmaf(__ldg(vals + slab + static_cast<int64_t>(k) * R), xv, acc);
  }
  y[row] = acc;
}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vals float32 (nb, K, R), cols int32 (nb, K, R), x float32 (n_cols,),
// y float32 (n_rows,), all contiguous on the current device.
int stormx_sell_spmv(const void* vals, const void* cols, const void* x, void* y,
                     int64_t n_rows, int64_t n_cols, int R, int K, int pad_lo,
                     void* stream) {
  if (n_rows == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_rows + threads - 1) / threads;
  sell_spmv_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const float*>(x), static_cast<float*>(y), n_rows, n_cols, R,
      K, pad_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
