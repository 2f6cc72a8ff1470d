// K4: the chunk-packed SlicedELL sparse matrix-vector product y = A·x for
// Hopper (sm_90a), in its two variants.
//
// Replaces the TPU kernels of stormx/ops/pallas_sell2.py:
//   K4a "matmul": PackedSELL.matvec → _apply → _kernel;
//   K4b "gather": PackedSELL.matvec → _apply3 → _kernel3.
// Both read the host-packed layout of that module (pallas_sell2.py:_pack):
// block b of R = sub·128 rows holds M tile rows of 128 lanes, each slot an
// int32 word owner<<12 | chunk<<7 | lane and a float value.  The slot (m, l)
// of block b multiplies
//     x[b·R − pad_lo + chunk·128 + lane]
// (zero outside [0, n_cols)) and belongs to row b·R + owner·128 + l.
// Padding slots hold the value 0 and a word in range.  K4b adds a source map:
// src[b, s·K + k, l] is the tile row of the k-th entry of row b·R + s·128 + l
// (a zero slot where that row has fewer than K entries).
//
// Bound on this card: memory.  K4a must read the index words and values
// (8·nb·M·128 bytes), x and write y; K4b also reads the source map
// (4·nb·M·128 more).  Two thirds of the slots or more are padding on mesh
// operators, so both are slower than K1 on the same operator; that is the
// format's cost.
//
// Design.  The TPU kernels built each block's (C/128, 128) window of x in
// VMEM, replicated the needed chunk onto each tile row with a one-hot MXU
// matmul (K4a) or sublane gathers (K4b), and reduced by owner with masked
// sums.  None of that carries over: here each slot reads its x value
// directly with the window's index arithmetic, through the read-only path
// (the 128 lanes of a tile row read one 512-byte chunk of x, so a warp's
// reads fall in at most four lines of L1/L2), and no window is built.
//   K4a: one block per row block, 128 lanes × kSplit thread rows; thread row
//        t takes tile rows t, t + kSplit, ... and keeps `sub` register
//        accumulators, picking one by the slot's owner (sub is a template
//        parameter, so the accumulators stay in registers).  The kSplit
//        partial sums of each row are added in a fixed order through shared
//        memory: no atomics, so the result does not change from run to run.
//   K4b: one thread per row, summing k = 0..K−1 in order (the ELL order),
//        reading each entry's slot through the source map.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kSplit = 4;  // thread rows of a K4a block, splitting the M tile rows
constexpr int kGatherThreads = 256;

__device__ __forceinline__ float window_x(const float* __restrict__ x, int64_t base,
                                          int32_t word, int64_t n_cols) {
  const int64_t g = base + (((word >> 7) & 31) << 7) + (word & 127);
  return (g >= 0 && g < n_cols) ? __ldg(x + g) : 0.0f;
}

template <int SUB>
__global__ void __launch_bounds__(kLanes* kSplit)
    packed_matmul_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                         const float* __restrict__ x, float* __restrict__ y,
                         int64_t n_rows, int64_t n_cols, int M, int R, int pad_lo) {
  __shared__ float part[kSplit][SUB][kLanes];
  const int l = threadIdx.x;
  const int t = threadIdx.y;
  const int64_t b = blockIdx.x;
  const int64_t base = b * R - pad_lo;
  const int64_t tile = b * M * kLanes + l;
  float acc[SUB];
#pragma unroll
  for (int s = 0; s < SUB; ++s) acc[s] = 0.0f;
#pragma unroll 4
  for (int m = t; m < M; m += kSplit) {
    const int64_t slot = tile + static_cast<int64_t>(m) * kLanes;
    const int32_t word = __ldg(idx + slot);
    const float p = __ldg(vals + slot) * window_x(x, base, word, n_cols);
    if (SUB == 1) {
      acc[0] += p;
    } else {
      const int owner = word >> 12;
#pragma unroll
      for (int s = 0; s < SUB; ++s) acc[s] += (owner == s) ? p : 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < SUB; ++s) part[t][s][l] = acc[s];
  __syncthreads();
  for (int s = t; s < SUB; s += kSplit) {
    float v = part[0][s][l];
#pragma unroll
    for (int u = 1; u < kSplit; ++u) v += part[u][s][l];
    const int64_t row = b * R + s * kLanes + l;
    if (row < n_rows) y[row] = v;
  }
}

__global__ void __launch_bounds__(kGatherThreads)
    packed_gather_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                         const int32_t* __restrict__ src, const float* __restrict__ x,
                         float* __restrict__ y, int64_t n_rows, int64_t n_cols, int M,
                         int R, int K, int pad_lo) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int64_t b = row / R;
  const int r = static_cast<int>(row - b * R);
  const int s = r / kLanes;
  const int l = r - s * kLanes;
  const int64_t tile = b * M * kLanes + l;
  const int64_t base = b * R - pad_lo;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int m = __ldg(src + tile + static_cast<int64_t>(s * K + k) * kLanes);
    const int64_t slot = tile + static_cast<int64_t>(m) * kLanes;
    acc = fmaf(__ldg(vals + slot), window_x(x, base, __ldg(idx + slot), n_cols), acc);
  }
  y[row] = acc;
}

#define STORMX_SUB_CASE(S)                                                  \
  case S:                                                                   \
    packed_matmul_kernel<S><<<static_cast<unsigned>(nb), block, 0, stream>>>( \
        idx, vals, x, y, n_rows, n_cols, M, R, pad_lo);                     \
    break;

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4a.  idx int32 and vals float32 (nb, M, 128), x float32 (n_cols,),
// y float32 (n_rows,), all contiguous on the current device; R = sub·128
// with 1 ≤ sub ≤ 16 and n_rows ≤ nb·R.
int stormx_packed_spmv_matmul(const void* idx_, const void* vals_, const void* x_, void* y_,
                              int64_t n_rows, int64_t n_cols, int64_t nb, int M, int R,
                              int pad_lo, void* stream_) {
  if (nb == 0 || n_rows == 0) return 0;
  if (R % kLanes != 0 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* idx = static_cast<const int32_t*>(idx_);
  const float* vals = static_cast<const float*>(vals_);
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const dim3 block(kLanes, kSplit);
  switch (R / kLanes) {
    STORMX_SUB_CASE(1)
    STORMX_SUB_CASE(2)
    STORMX_SUB_CASE(3)
    STORMX_SUB_CASE(4)
    STORMX_SUB_CASE(5)
    STORMX_SUB_CASE(6)
    STORMX_SUB_CASE(7)
    STORMX_SUB_CASE(8)
    STORMX_SUB_CASE(9)
    STORMX_SUB_CASE(10)
    STORMX_SUB_CASE(11)
    STORMX_SUB_CASE(12)
    STORMX_SUB_CASE(13)
    STORMX_SUB_CASE(14)
    STORMX_SUB_CASE(15)
    STORMX_SUB_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4b.  As K4a, plus src int32 (nb, M, 128) with M ≥ sub·K.
int stormx_packed_spmv_gather(const void* idx, const void* vals, const void* src,
                              const void* x, void* y, int64_t n_rows, int64_t n_cols, int M,
                              int R, int K, int pad_lo, void* stream) {
  if (n_rows == 0) return 0;
  if (R % kLanes != 0 || K < 1 || M < (R / kLanes) * K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_rows + kGatherThreads - 1) / kGatherThreads;
  packed_gather_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const int32_t*>(src), static_cast<const float*>(x), static_cast<float*>(y),
      n_rows, n_cols, M, R, K, pad_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
