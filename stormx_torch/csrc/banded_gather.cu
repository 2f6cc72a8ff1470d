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
// launch per call, one thread block per R-row block (it reads starts[b]
// once, so there is no division per row, and the x reads of a block stay
// inside its C-wide window, which L1/L2 hold), and three branches that the
// host picks from the shape (ops/banded_gather.py, k3_branch):
//   * "vec4", 4-byte components with nv == 1 (the float32 scalar fields of
//     the Cahn–Hilliard path): each thread takes four consecutive rows with
//     one 16-byte load of the word and one 16-byte store of y; the ragged
//     end of m is done row by row;
//   * "vector", rows of several components (the FVM fields, complex128): a
//     row is L vectors of V = 16, 8 or 4 bytes, the widest that divides the
//     row's bytes and the alignment of x and y, so every row starts on a
//     vector and no row has a tail.  The block decodes each row's word once
//     into a table of source rows in shared memory; then its threads walk
//     the block's R·L vectors of y in order (neighbouring threads on
//     neighbouring vectors, so each warp's loads and stores cover whole
//     stretches of rows), each thread issuing kBytesInFlight bytes of loads
//     before its stores, since the copy is bound by the loads in flight.
//     128 threads and 64 bytes were the fastest of 128–512 threads and
//     32–128 bytes over the FVM widths (scripts/torch_k3_variants.py
//     --variants on an H100; PERF.md).
//     L is a template constant for L ≤ 16 (every FVM width: the row of a
//     vector e is e / L, a multiply and a shift) with one runtime-L
//     instantiation for wider rows;
//   * "scalar", everything else (itemsize 1 and 2, bases not 4-byte
//     aligned): one thread per component, copying raw bits.  Also kept as
//     the measured baseline of the vector branch (it was the only branch
//     for nv > 1 before it).
// A 16-byte component (complex128) is two 8-byte ones here.  Raw bits make
// the result bit-exact for every dtype.  The TPU kernel's
// one-BlockSpec-per-128-row window, its masked per-chunk select (its way of
// emulating a gather) and its separate fixup scatter are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;          // the vec4 and scalar branches
constexpr int kVectorThreads = 128;    // the vector branch
constexpr int kBytesInFlight = 64;     // a vector-branch thread's loads before its stores
constexpr int kMaxUnrolledL = 16;      // vectors a row with a compile-time L
constexpr int kMaxTableBytes = 48 * 1024;  // the vector branch's source table, R int32

enum Branch { kBranchVec4 = 0, kBranchVector = 1, kBranchScalar = 2 };

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

// The vector branch: rows of L vectors of type V (kL > 0 fixes L at
// compile time; kL == 0 reads it from L).  Dynamic shared memory: R int32.
template <typename V, int kL>
__global__ void __launch_bounds__(kVectorThreads)
    banded_gather_vector_kernel(const int32_t* __restrict__ starts,
                                const int32_t* __restrict__ word, const V* __restrict__ x,
                                V* __restrict__ y, int64_t m, int R, int L_runtime) {
  constexpr int kUnroll = kBytesInFlight / static_cast<int>(sizeof(V));
  extern __shared__ int32_t src[];  // the source row of each row of the block
  const int L = kL > 0 ? kL : L_runtime;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int rows = static_cast<int>(m - row0 < R ? m - row0 : R);
  const int64_t base = 128 * static_cast<int64_t>(starts[blockIdx.x]);
  for (int r = threadIdx.x; r < rows; r += kVectorThreads)
    src[r] = static_cast<int32_t>(source_row(word[row0 + r], base));  // < n_src < 2^31
  __syncthreads();
  const int n = rows * L;  // ≤ R·L ≤ 2^30 (the entry checks it)
  V* yb = y + row0 * L;
  for (int e0 = threadIdx.x; e0 < n; e0 += kVectorThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kVectorThreads;
      if (e < n) {
        const int r = e / L;
        v[u] = x[static_cast<int64_t>(src[r]) * L + (e - r * L)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kVectorThreads;
      if (e < n) yb[e] = v[u];
    }
  }
}

template <typename W>
void launch_word(int branch, const int32_t* starts, const int32_t* word, const void* x,
                 void* y, int64_t m, int R, int nv, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((m + R - 1) / R);
  const W* xw = static_cast<const W*>(x);
  W* yw = static_cast<W*>(y);
  if constexpr (sizeof(W) == 4) {
    if (branch == kBranchVec4) {
      banded_gather_kernel<W, true><<<blocks, kThreads, 0, s>>>(starts, word, xw, yw, m, R, 1);
      return;
    }
  }
  banded_gather_kernel<W, false><<<blocks, kThreads, 0, s>>>(starts, word, xw, yw, m, R, nv);
}

template <typename V, int kL>
void launch_vector_at(const int32_t* starts, const int32_t* word, const void* x, void* y,
                      int64_t m, int R, int L, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((m + R - 1) / R);
  const size_t smem = static_cast<size_t>(R) * sizeof(int32_t);
  banded_gather_vector_kernel<V, kL><<<blocks, kVectorThreads, smem, s>>>(
      starts, word, static_cast<const V*>(x), static_cast<V*>(y), m, R, L);
}

// L = 1..kMaxUnrolledL at compile time, any other L at run time.
template <typename V, int kL = 1>
void launch_vector(const int32_t* starts, const int32_t* word, const void* x, void* y,
                   int64_t m, int R, int L, cudaStream_t s) {
  if constexpr (kL > kMaxUnrolledL) {
    launch_vector_at<V, 0>(starts, word, x, y, m, R, L, s);
  } else {
    if (L == kL)
      launch_vector_at<V, kL>(starts, word, x, y, m, R, L, s);
    else
      launch_vector<V, kL + 1>(starts, word, x, y, m, R, L, s);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// starts int32 (nb,), word int32 (nb·R,) as above, x (n_src, nv) and y
// (m, nv) of `itemsize` bytes per element, all contiguous on the current
// device, m ≤ nb·R.  `branch` 0 ("vec4"), 1 ("vector", rows moved as
// `vec_bytes`-byte vectors) or 2 ("scalar"); ops/banded_gather.py picks it.
// One launch.  Returns cudaErrorInvalidValue for an itemsize other than 1,
// 2, 4, 8 or 16, or a shape, alignment or branch the kernel does not take.
int stormx_banded_gather(const void* starts, const void* word, const void* x, void* y,
                         int64_t m, int R, int nv, int itemsize, int branch, int vec_bytes,
                         void* stream) {
  if (m == 0) return 0;
  if (itemsize == 16) {  // a row of nv 16-byte items is one of 2·nv 8-byte words
    itemsize = 8;
    nv *= 2;
  }
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (R < 1 || nv < 1 || static_cast<int64_t>(R) * nv > (1 << 30)) return invalid;
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* wd = static_cast<const int32_t*>(word);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (branch == kBranchVec4) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(word) | reinterpret_cast<uintptr_t>(y)) &
                          15) == 0;
    if (itemsize != 4 || nv != 1 || !aligned || R % 4) return invalid;
    launch_word<uint32_t>(branch, st, wd, x, y, m, R, nv, s);
  } else if (branch == kBranchVector) {
    const int64_t row_bytes = static_cast<int64_t>(nv) * itemsize;
    if ((vec_bytes != 4 && vec_bytes != 8 && vec_bytes != 16) || row_bytes % vec_bytes ||
        (bases & (vec_bytes - 1)) || static_cast<int64_t>(R) * 4 > kMaxTableBytes)
      return invalid;
    const int L = static_cast<int>(row_bytes / vec_bytes);
    if (static_cast<int64_t>(R) * L > (1 << 30)) return invalid;
    switch (vec_bytes) {
      case 4: launch_vector<uint32_t>(st, wd, x, y, m, R, L, s); break;
      case 8: launch_vector<uint2>(st, wd, x, y, m, R, L, s); break;
      default: launch_vector<uint4>(st, wd, x, y, m, R, L, s); break;
    }
  } else if (branch == kBranchScalar) {
    switch (itemsize) {
      case 1: launch_word<uint8_t>(branch, st, wd, x, y, m, R, nv, s); break;
      case 2: launch_word<uint16_t>(branch, st, wd, x, y, m, R, nv, s); break;
      case 4: launch_word<uint32_t>(branch, st, wd, x, y, m, R, nv, s); break;
      case 8: launch_word<uint64_t>(branch, st, wd, x, y, m, R, nv, s); break;
      default: return invalid;
    }
  } else {
    return invalid;
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
