// K3: banded gather y = x[idx] for Hopper (sm_90a).
//
// Replaces the TPU kernel stormx/ops/pallas_gather.py:_kernel (driven by
// _apply and BandedGatherPlan.__call__).  Same function, and the same host
// plan, folded into one int32 word per output row j (block b = j / R):
//     word[j] = l ≥ 0       in window:  y[j] = x[128·starts[b] + l]
//     word[j] = −1 − idx[j] fixup row:  y[j] = x[idx[j]]
// so one pass writes every row once, the fixup rows (the plan's rows whose
// index left the block's window) included.  A row of x has nv components.
//
// Bound on this card: bytes, 4·m word bytes plus m·nv·itemsize y bytes and
// the x window, which is a few µs or less at the mesh plans' sizes, and the
// card's fixed cost per launch, which is larger.  So the design spends one
// launch per call and keeps the work per thread short:
//   * one thread block per R-row block: it reads starts[b] once, so there is
//     no division per row, and the x reads of a block stay inside its C-wide
//     window, which L1/L2 hold;
//   * 4-byte components with nv == 1 (the float32 scalar fields of the
//     Cahn–Hilliard path): each thread takes four consecutive rows with one
//     16-byte load of the word and one 16-byte store of y; the ragged end of
//     m and a base that is not 16-byte aligned take the scalar branch;
//   * every other case (itemsize 1, 2 and 8, nv > 1): a scalar branch of the
//     same launch, one thread per component, copying raw bits.
// Raw bits make the result bit-exact for every dtype.  The TPU kernel's
// one-BlockSpec-per-128-row window, its masked per-chunk select (its way of
// emulating a gather) and its separate fixup scatter are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int64_t source_row(int32_t word, int64_t base) {
  return word >= 0 ? base + word : -1 - static_cast<int64_t>(word);
}

template <typename W, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    banded_gather_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ word,
                         const W* __restrict__ x, W* __restrict__ y, int64_t m, int R, int nv) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int64_t base = 128 * static_cast<int64_t>(starts[blockIdx.x]);
  if constexpr (kVec4) {
    // word and y are 16-byte aligned and R % 4 == 0, so row0 + r is too.
    for (int r = threadIdx.x * 4; r < R; r += kThreads * 4) {
      const int64_t j = row0 + r;
      if (j >= m) return;
      const int4 w = *reinterpret_cast<const int4*>(word + j);
      uint4 v;
      v.x = x[source_row(w.x, base)];
      if (j + 4 <= m) {
        v.y = x[source_row(w.y, base)];
        v.z = x[source_row(w.z, base)];
        v.w = x[source_row(w.w, base)];
        *reinterpret_cast<uint4*>(y + j) = v;
      } else {  // the ragged end of m
        y[j] = v.x;
        if (j + 1 < m) y[j + 1] = x[source_row(w.y, base)];
        if (j + 2 < m) y[j + 2] = x[source_row(w.z, base)];
      }
    }
  } else {
    const int total = R * nv;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int r = e / nv;
      const int v = e - r * nv;
      const int64_t j = row0 + r;
      if (j >= m) return;
      y[j * nv + v] = x[source_row(word[j], base) * nv + v];
    }
  }
}

template <typename W>
void launch(const int32_t* starts, const int32_t* word, const void* x, void* y, int64_t m,
            int R, int nv, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((m + R - 1) / R);
  const W* xw = static_cast<const W*>(x);
  W* yw = static_cast<W*>(y);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(word) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if constexpr (sizeof(W) == 4) {
    if (nv == 1 && aligned && R % 4 == 0) {
      banded_gather_kernel<W, true><<<blocks, kThreads, 0, s>>>(starts, word, xw, yw, m, R, 1);
      return;
    }
  }
  banded_gather_kernel<W, false><<<blocks, kThreads, 0, s>>>(starts, word, xw, yw, m, R, nv);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// starts int32 (nb,), word int32 (nb·R,) as above, x (n_src, nv) and y
// (m, nv) of `itemsize` bytes per element, all contiguous on the current
// device, m ≤ nb·R.  One launch.  Returns cudaErrorInvalidValue for an
// itemsize other than 1, 2, 4 or 8, or a shape the kernel does not take.
int stormx_banded_gather(const void* starts, const void* word, const void* x, void* y,
                         int64_t m, int R, int nv, int itemsize, void* stream) {
  if (m == 0) return 0;
  if (R < 1 || nv < 1 || static_cast<int64_t>(R) * nv > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* wd = static_cast<const int32_t*>(word);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: launch<uint8_t>(st, wd, x, y, m, R, nv, s); break;
    case 2: launch<uint16_t>(st, wd, x, y, m, R, nv, s); break;
    case 4: launch<uint32_t>(st, wd, x, y, m, R, nv, s); break;
    case 8: launch<uint64_t>(st, wd, x, y, m, R, nv, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `blocks` blocks of 128 threads: the card's fixed cost
// per launch, the floor under K3's time (measured beside it, never on a
// path).
int stormx_empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
