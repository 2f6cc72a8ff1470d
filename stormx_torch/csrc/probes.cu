// Two measurement probes for Hopper (sm_90a).
//
// P1, the in-chunk lane gather y[m, l] = x[m, idx[m, l]] on (rows, width)
// float32 with int32 indices.  Replaces the TPU probe
// scripts/pallas_gather_probe.py (its `kernel`, a take_along_axis inside a
// Pallas kernel), which asked whether a lane gather lowers on the TPU.  It
// is the access pattern K4 rests on: each tile row of the packed SlicedELL
// reads 128 lanes from one 128-float chunk.  Bound on this card: memory
// (x and idx read once, y written once).  Design: one thread per output,
// x read through the read-only path; a row of x is 512 bytes, so a warp's
// 32 reads fall in at most four L1 lines.  An index outside [0, width)
// reads nothing and gives 0.
//
// P2, the stream probe of K2a: the four modes of scripts/perf_pallas_bisect.py
// (`kernel`), which split the DIA SpMV's bandwidth by stream.  With n rows,
// diag (5, n) and x of n + 2048 floats:
//   full  z[i] = c + Σ_{d<5} diag[d, i]·x[i + 128·d]   (the whole SpMV)
//   diag  z[i] = c + Σ_{d<5} diag[d, i]                (diagonals only)
//   win   z[i] = 2·x[i + 1024] + c                     (x only)
//   zonly z[i] = 1.5 + c                               (the write only)
// Bound on this card: memory, 4·(5 + 2)·n bytes in full mode.  Design: the
// grid-stride loop of K2a (csrc/dia_spmv.cu) with the same grid, one
// template instance per mode, so that the four times split K2a's own
// streams.  Products and sums are rounded one at a time (no FMA) in the
// order of the plain PyTorch version, which they therefore match bit for
// bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kDiags = 5;
constexpr int kLanes = 128;

__global__ void __launch_bounds__(kThreads)
    lane_gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                       float* __restrict__ y, int64_t total, int width) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t m = t / width;
  const int32_t j = __ldg(idx + t);
  y[t] = (j >= 0 && j < width) ? __ldg(x + m * width + j) : 0.0f;
}

enum Mode { kFull = 0, kDiag = 1, kWin = 2, kZonly = 3 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    dia_stream_kernel(const float* __restrict__ diag, const float* __restrict__ x,
                      float* __restrict__ z, int64_t n, float c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = c;
    if (MODE == kFull) {
#pragma unroll
      for (int d = 0; d < kDiags; ++d)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(diag + d * n + i), __ldg(x + i + kLanes * d)));
    } else if (MODE == kDiag) {
#pragma unroll
      for (int d = 0; d < kDiags; ++d) acc = __fadd_rn(acc, __ldg(diag + d * n + i));
    } else if (MODE == kWin) {
      acc = __fadd_rn(__fmul_rn(__ldg(x + i + 8 * kLanes), 2.0f), c);
    } else {
      acc = __fadd_rn(1.5f, c);
    }
    z[i] = acc;
  }
}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// P1.  x float32 and idx int32 (rows, width), y float32 (rows, width), all
// contiguous on the current device; total = rows·width.
int stormx_lane_gather(const void* x, const void* idx, void* y, int64_t total, int width,
                       void* stream) {
  if (total == 0) return 0;
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  lane_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx), static_cast<float*>(y),
      total, width);
  return static_cast<int>(cudaGetLastError());
}

// P2.  diag float32 (5, n), x float32 (n + 2048,), z float32 (n,), all
// contiguous on the current device; mode 0 full, 1 diag, 2 win, 3 zonly.
int stormx_dia_stream_probe(const void* diag_, const void* x_, void* z_, int64_t n, float c,
                            int mode, int blocks, void* stream_) {
  if (n == 0) return 0;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* diag = static_cast<const float*>(diag_);
  const float* x = static_cast<const float*>(x_);
  float* z = static_cast<float*>(z_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (mode) {
    case kFull:
      dia_stream_kernel<kFull><<<blocks, kThreads, 0, stream>>>(diag, x, z, n, c);
      break;
    case kDiag:
      dia_stream_kernel<kDiag><<<blocks, kThreads, 0, stream>>>(diag, x, z, n, c);
      break;
    case kWin:
      dia_stream_kernel<kWin><<<blocks, kThreads, 0, stream>>>(diag, x, z, n, c);
      break;
    case kZonly:
      dia_stream_kernel<kZonly><<<blocks, kThreads, 0, stream>>>(diag, x, z, n, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
