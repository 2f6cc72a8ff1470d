// K3: banded gather y = x[idx] for Hopper (sm_90a).
//
// Replaces the TPU kernel stormx/ops/pallas_gather.py:_kernel (driven by
// _apply and BandedGatherPlan.__call__).  Same function and the same host
// plan: output row j of block b = j / R reads
//     y[j] = x[128·starts[b] + lidx[j]]      (lidx[j] < C)
//     y[j] = 0                               (lidx[j] == C: out of window)
// then a second kernel applies the plan's fixup list (rows whose index left
// the block's window): y[fix_pos[i]] = x[fix_idx[i]].  A row of x has nv
// components.
//
// Bound on this card: memory.  A gather moves 4·m index bytes plus
// 2·m·nv·itemsize data bytes and computes nothing.
//
// Design: one thread per output row, copying nv words of itemsize bytes
// as raw bits (so the result is bit-exact for every dtype).  Neighbouring
// threads read neighbouring lidx words and write neighbouring y words; the
// x reads of a block stay inside its C-wide window, so they hit L1/L2.  The
// fixup rows (under 1% of m) get one thread each in a second launch on the
// same stream, which orders it after the first.  The TPU kernel's
// one-BlockSpec-per-128-row window and its masked per-chunk select (its way
// of emulating a gather) are not carried over: the card gathers natively.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename W>
__global__ void banded_gather_kernel(const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ lidx,
                                     const W* __restrict__ x, W* __restrict__ y,
                                     int64_t m, int64_t n_src, int R, int C,
                                     int nv) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int l = __ldg(lidx + j);
  const int64_t g = 128 * static_cast<int64_t>(__ldg(starts + j / R)) + l;
  const bool hit = l < C && g < n_src;
  for (int v = 0; v < nv; ++v) {
    y[j * nv + v] = hit ? x[g * nv + v] : W(0);
  }
}

template <typename W>
__global__ void fixup_kernel(const int32_t* __restrict__ fix_pos,
                             const int32_t* __restrict__ fix_idx,
                             const W* __restrict__ x, W* __restrict__ y,
                             int64_t n_fix, int nv) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_fix) return;
  const int64_t p = __ldg(fix_pos + i);
  const int64_t g = __ldg(fix_idx + i);
  for (int v = 0; v < nv; ++v) {
    y[p * nv + v] = x[g * nv + v];
  }
}

template <typename W>
void launch(const void* starts, const void* lidx, const void* fix_pos,
            const void* fix_idx, const void* x, void* y, int64_t m,
            int64_t n_src, int64_t n_fix, int R, int C, int nv, cudaStream_t s) {
  const int threads = 256;
  const int64_t blocks = (m + threads - 1) / threads;
  banded_gather_kernel<W><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(lidx),
      static_cast<const W*>(x), static_cast<W*>(y), m, n_src, R, C, nv);
  if (n_fix > 0) {
    const int64_t fblocks = (n_fix + threads - 1) / threads;
    fixup_kernel<W><<<static_cast<unsigned>(fblocks), threads, 0, s>>>(
        static_cast<const int32_t*>(fix_pos), static_cast<const int32_t*>(fix_idx),
        static_cast<const W*>(x), static_cast<W*>(y), n_fix, nv);
  }
}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// starts int32 (nb,), lidx int32 (nb·R,), fix_pos and fix_idx int32
// (n_fix,), x (n_src, nv) and y (m, nv) of `itemsize` bytes per element, all
// contiguous on the current device.  Returns cudaErrorInvalidValue for an
// itemsize other than 1, 2, 4 or 8.
int stormx_banded_gather(const void* starts, const void* lidx,
                         const void* fix_pos, const void* fix_idx,
                         const void* x, void* y, int64_t m, int64_t n_src,
                         int64_t n_fix, int R, int C, int nv, int itemsize,
                         void* stream) {
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: launch<uint8_t>(starts, lidx, fix_pos, fix_idx, x, y, m, n_src, n_fix, R, C, nv, s); break;
    case 2: launch<uint16_t>(starts, lidx, fix_pos, fix_idx, x, y, m, n_src, n_fix, R, C, nv, s); break;
    case 4: launch<uint32_t>(starts, lidx, fix_pos, fix_idx, x, y, m, n_src, n_fix, R, C, nv, s); break;
    case 8: launch<uint64_t>(starts, lidx, fix_pos, fix_idx, x, y, m, n_src, n_fix, R, C, nv, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
