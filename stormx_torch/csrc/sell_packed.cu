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
// Padding slots hold the value 0 and a word in range.  The packer keeps
// only non-zero values, so a slot is live exactly when its value is not 0.
// K4a also takes rows_used[b], 1 + the last tile row of block b that holds
// a live slot.  K4b adds a source map: src[b, s·K + k, l] is the tile row of
// the k-th entry of row b·R + s·128 + l (a zero slot where that row has
// fewer than K entries).
//
// Bound on this card: memory.  What y = A·x needs is the live values and
// their index words, x and y (8.3 µs on the 318k-cell Cahn–Hilliard
// operator, 3.8 µs on its Laplacian, at 3.35 TB/s).  The tiles hold two
// padding slots per live one on mesh operators, so what a kernel reads is
// more.  K4b reads every slot its source map names plus the map
// (12 bytes per slot).  K4a reads, per 32-byte sector, only what can hold a
// live slot:
//   * no tile row at or past rows_used[b] (30% of the Laplacian's slots, 11%
//     of the CH operator's, are such whole dead rows at the end of a block);
//   * the values of the rows below it, 16 bytes a thread, and the index
//     words and x values only of a group of four lanes that holds a
//     non-zero value (52% and 39% of those 32-byte sectors hold zeros only).
// On the CH operator that is ≈ 34 MB of values, 23 MB of index words and
// 2.5 MB of x and y, against 79 MB for every slot.
//
// Skipping a zero-valued slot changes y only where x holds Inf or NaN at
// that slot's address: the TPU kernel multiplies every slot, and 0·Inf is
// NaN there.  With finite x both give the same sums.
//
// Design.  The TPU kernels built each block's (C/128, 128) window of x in
// VMEM, replicated the needed chunk onto each tile row with a one-hot MXU
// matmul (K4a) or sublane gathers (K4b), and reduced by owner with masked
// sums.  None of that carries over: here each slot reads its x value
// directly with the window's index arithmetic, through the read-only path
// (the 128 lanes of a tile row read one 512-byte chunk of x, so a warp's
// reads fall in at most four lines of L1/L2), and no window is built.
//   K4a: one block per row block, kMatmulWarps warps; a thread takes
//        four adjacent lanes (a float4 of values, an int4 of words), so a
//        warp reads one 128-lane tile row in one request.  Warp w takes tile
//        rows w, w + warps, ... below rows_used[b], kUnroll of them at a
//        time: their value loads are in flight together before the index
//        loads that depend on them, and those before the x loads.  Each
//        thread keeps 4·SUB register accumulators, picking one by the
//        slot's owner (SUB is a template parameter, 1–16).  The warps'
//        partial sums of each row are added in a fixed order through shared
//        memory: no atomics, so the result does not change from run to run.
//   K4b: one thread per row, summing k = 0..K−1 in order (the ELL order),
//        reading each entry's slot through the source map.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kUnroll = 4;  // tile rows of one K4a warp in flight together
constexpr int kGatherThreads = 256;

// Warps of a K4a block; the partial sums take 4 · SUB · 512 bytes of shared
// memory, at most 32 KB.
constexpr int kMatmulWarps = 4;
// K4a blocks an SM must hold: caps the registers at 128 a thread.  Without
// this bound the compiler gave the SUB = 4 kernel 45 registers and issued
// its loads one tile row at a time (40.0 µs on the Cahn–Hilliard operator
// in chip_smoke.py on an H100 80GB HBM3 at 700 W, against 29.7 µs with it).
constexpr int kMatmulMinBlocks = 4;

__device__ __forceinline__ float window_x(const float* __restrict__ x, int64_t base,
                                          int32_t word, int64_t n_cols) {
  const int64_t g = base + (((word >> 7) & 31) << 7) + (word & 127);
  return (g >= 0 && g < n_cols) ? __ldg(x + g) : 0.0f;
}

// K4a's x value of one slot: read only for a non-zero value, and 0 outside
// [0, n_cols) as window_x gives it.
__device__ __forceinline__ float live_x(const float* __restrict__ xw, int off_lo,
                                        unsigned span, float val, int32_t word) {
  const unsigned k = static_cast<unsigned>((((word >> 7) & 31) << 7 | (word & 127)) - off_lo);
  return (val != 0.0f && k < span) ? __ldg(xw + k) : 0.0f;
}

__device__ __forceinline__ bool any_nonzero(const float4& v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

template <int SUB>
__device__ __forceinline__ void add_slot(float (&acc)[SUB][4], int lane, float val, float xv,
                                         int32_t word) {
  const float p = val * xv;
  if constexpr (SUB == 1) {
    acc[0][lane] += p;
  } else {
    const int owner = word >> 12;
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      if (owner == s) acc[s][lane] += p;
    }
  }
}

template <int SUB>
__global__ void __launch_bounds__(kMatmulWarps * 32, kMatmulMinBlocks)
    packed_matmul_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                         const int32_t* __restrict__ rows_used, const float* __restrict__ x,
                         float* __restrict__ y, int64_t n_rows, int64_t n_cols, int M, int R,
                         int pad_lo) {
  constexpr int kRow4 = kLanes / 4;  // float4s per tile row
  __shared__ __align__(16) float part[kMatmulWarps][SUB][kLanes];
  const int w = threadIdx.x / 32;
  const int l0 = (threadIdx.x % 32) * 4;  // the thread's lanes l0 .. l0 + 3
  const int64_t b = blockIdx.x;
  const int64_t base = b * R - pad_lo;
  // A word's window offset off = chunk·128 + lane (< 4096) names x[base +
  // off], which exists for off_lo ≤ off < off_lo + span; xw = x + base + off_lo.
  const int64_t lo = base < 0 ? -base : 0;
  const int64_t hi = n_cols - base;
  const int off_lo = static_cast<int>(lo < 4096 ? lo : 4096);
  const int off_hi = static_cast<int>(hi < 0 ? 0 : hi < 4096 ? hi : 4096);
  const unsigned span = off_hi > off_lo ? off_hi - off_lo : 0;
  const float* xw = x + (base + off_lo);
  const int used = min(__ldg(rows_used + b), M);
  const int64_t tile = b * M * kLanes + l0;
  const float4* v4 = reinterpret_cast<const float4*>(vals + tile);
  const int4* w4 = reinterpret_cast<const int4*>(idx + tile);
  float acc[SUB][4];
#pragma unroll
  for (int s = 0; s < SUB; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.0f;
  for (int m0 = w; m0 < used; m0 += kMatmulWarps * kUnroll) {
    float4 v[kUnroll];
    int4 wd[kUnroll];
    float4 xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int m = m0 + u * kMatmulWarps;
      v[u] = m < used ? __ldg(v4 + m * kRow4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int m = m0 + u * kMatmulWarps;
      wd[u] = any_nonzero(v[u]) ? __ldg(w4 + m * kRow4) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u].x = live_x(xw, off_lo, span, v[u].x, wd[u].x);
      xv[u].y = live_x(xw, off_lo, span, v[u].y, wd[u].y);
      xv[u].z = live_x(xw, off_lo, span, v[u].z, wd[u].z);
      xv[u].w = live_x(xw, off_lo, span, v[u].w, wd[u].w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_slot<SUB>(acc, 0, v[u].x, xv[u].x, wd[u].x);
      add_slot<SUB>(acc, 1, v[u].y, xv[u].y, wd[u].y);
      add_slot<SUB>(acc, 2, v[u].z, xv[u].z, wd[u].z);
      add_slot<SUB>(acc, 3, v[u].w, xv[u].w, wd[u].w);
    }
  }
#pragma unroll
  for (int s = 0; s < SUB; ++s) {
    *reinterpret_cast<float4*>(&part[w][s][l0]) =
        make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < SUB * kLanes; o += kMatmulWarps * 32) {
    const int s = o / kLanes;
    const int l = o % kLanes;
    float sum = part[0][s][l];
#pragma unroll
    for (int u = 1; u < kMatmulWarps; ++u) sum += part[u][s][l];
    const int64_t row = b * R + o;  // o = s·128 + l
    if (row < n_rows) y[row] = sum;
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

#define STORMX_SUB_CASE(S)                                                           \
  case S:                                                                            \
    packed_matmul_kernel<S><<<static_cast<unsigned>(nb), kMatmulWarps * 32, 0, stream>>>( \
        idx, vals, rows_used, x, y, n_rows, n_cols, M, R, pad_lo);                   \
    break;

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4a.  idx int32 and vals float32 (nb, M, 128), both 16-byte aligned,
// rows_used int32 (nb,), x float32 (n_cols,), y float32 (n_rows,), all
// contiguous on the current device; R = sub·128 with 1 ≤ sub ≤ 16 and
// n_rows ≤ nb·R.
int stormx_packed_spmv_matmul(const void* idx_, const void* vals_, const void* rows_used_,
                              const void* x_, void* y_, int64_t n_rows, int64_t n_cols,
                              int64_t nb, int M, int R, int pad_lo, void* stream_) {
  if (nb == 0 || n_rows == 0) return 0;
  if (R % kLanes != 0 || M < 1 ||
      ((reinterpret_cast<uintptr_t>(idx_) | reinterpret_cast<uintptr_t>(vals_)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* idx = static_cast<const int32_t*>(idx_);
  const float* vals = static_cast<const float*>(vals_);
  const int32_t* rows_used = static_cast<const int32_t*>(rows_used_);
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
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

// K4b.  idx, vals, x and y as K4a (no alignment asked, no rows_used), plus
// src int32 (nb, M, 128) with M ≥ sub·K.
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
