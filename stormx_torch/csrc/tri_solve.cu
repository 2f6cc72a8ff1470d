// T1 and T2: the sparse triangular solve (D + N)·y = r of
// stormx_torch/precond/triangular.py for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It stands for the JAX package's level loop,
// an XLA program (stormx/precond/triangular.py:146-175, tri_solve): the
// exact solve walks the dependency levels in one lax.fori_loop, and the
// sweeps mode runs a fixed number of Jacobi sweeps.  The factor is the
// host-built ELL form of N (vals and int32 cols, (n + 1, K), the real
// entries of row i in its first row_len[i] slots, zeros after), inv_diag
// (n + 1,), and for T1 the rows ordered level by level (order, (n,)).
//
// Both kernels add each row's slots in slot order, k = 0..K−1, one
// rounded multiply and one rounded add per slot (no FMA contraction: the
// _rn intrinsics), then form (r − acc)·inv_diag: the rounding of the plain
// version (ops/tri_solve.py, slot_sum), which they equal bit for bit in
// float32 and float64.  Complex products are written out in one fixed
// order, (a.x·b.x − a.y·b.y, a.x·b.y + a.y·b.x).
//
// T1, the exact solve in one launch.  Bound on this card: latency, not
// bytes.  A row can start only once the rows it reads are written, so the
// solve takes at least num_levels dependent round trips through L2 (a
// flag and a value written by one SM and read by another), against a few
// MB of bytes.  The design has no barrier per level: one warp a row, each
// lane a slot, every row waiting only on its own dependencies.
//   * Rows.  Warp w takes positions w, w + W, w + 2W, ... of order (W
//     warps in the grid), in turn.  The launch is cooperative, so all W
//     warps are resident; order lists rows by level, so every dependency
//     of the position p lies at a smaller position.  The smallest
//     unfinished position then always has its dependencies done and its
//     warp free to take it: the solve cannot deadlock.  (No ticket: a
//     global atomic counter per row would put n atomics on one word.)
//   * Waiting.  A row first loads its own operands (its slots' columns
//     and values, r and inv_diag), so that their latency overlaps the
//     wait.  Lane k spins on the flag words of its slot's column c until
//     they hold the stamp, the warp leaving the loop together
//     (__all_sync), and forms its product with y[c].  Lane 0 adds the
//     products in slot order (shuffles), stores y[row] and then row's flag
//     words.  Slots past row_len are padding and are not read.
//   * Flags carry the value.  A row's flag is sizeof(T)/4 64-bit words,
//     each the stamp (1) in its high half and 32 bits of y[row] in its low
//     half, stored and polled relaxed: y arrives with its flag, so a
//     level's chain holds no fence and no second load.  (32-bit flags
//     released after y and polled with acquire, then a load of y, took
//     twice as long a level in float32 on an H100: PERF.md.)
//   * Scratch.  scratch holds the header (4 words: the abort word and the
//     error words) and the flag words, 2n·sizeof(T)/4 32-bit words.  The C
//     entry zeroes it on the stream before each launch, so a solve owns its
//     scratch: two solves of one factor, on one stream or two, share
//     nothing but the factor.
//   * Watchdog.  A warp that waits longer than watchdog_ns on one row's
//     flags, or meets a column outside [0, n), stores an error code and
//     the row in the header and raises the abort word; every waiting warp
//     sees it and stops waiting, so the launch ends.  Such a row, and every
//     row that stops waiting, writes NaN, so the solve's y is never a wrong
//     number.  The C entry does not wait: the wrapper copies the error
//     words to the host behind the launch and reads them later
//     (ops/tri_solve.py), which raises StormError.

// T2, one Jacobi sweep y' = inv_diag·(r − N·y) in one launch, one thread a
// row over all K slots (padding included, as the plain version reads
// them).  The first sweep of a solve forms y0 = inv_diag·r inline where it
// reads y, so a k-sweep solve is k launches.  Bound on this card: bytes
// (the factor, r, inv_diag and y once each).
//
// stormx_l2_chase: a measurement probe, on no path.  One thread follows a
// random cycle of int32 links through L2 (ld.cg), the dependent L2 round
// trip that T1's latency bound counts once per level.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kExactThreads = 256;
constexpr int kWarpsPerBlock = kExactThreads / 32;
constexpr int kSweepThreads = 256;
constexpr unsigned kPollsPerCheck = 64;  // flag polls between watchdog checks

// Words of T1's scratch: the header, then one ready flag a row.
enum Header { kAbort = 0, kErrCode = 1, kErrRow = 2, kFlags = 4 };
enum ErrorCode { kTimeout = 1, kBadColumn = 2 };
constexpr unsigned kStamp = 1u;  // a ready flag's high half; the memset leaves 0
enum DType { kF32 = 0, kF64 = 1, kC64 = 2, kC128 = 3 };

struct cfloat {
  float x, y;
};
struct __align__(16) cdouble {
  double x, y;
};

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fc00000); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float shfl(float v, int src) {
    return __shfl_sync(kFull, v, src);
  }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double zero() { return 0.0; }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double shfl(double v, int src) {
    return __shfl_sync(kFull, v, src);
  }
};

template <>
struct Arith<cfloat> {
  using R = Arith<float>;
  static __device__ __forceinline__ cfloat zero() { return {0.0f, 0.0f}; }
  static __device__ __forceinline__ cfloat nan() { return {R::nan(), R::nan()}; }
  static __device__ __forceinline__ cfloat mul(cfloat a, cfloat b) {
    return {R::sub(R::mul(a.x, b.x), R::mul(a.y, b.y)),
            R::add(R::mul(a.x, b.y), R::mul(a.y, b.x))};
  }
  static __device__ __forceinline__ cfloat add(cfloat a, cfloat b) {
    return {R::add(a.x, b.x), R::add(a.y, b.y)};
  }
  static __device__ __forceinline__ cfloat sub(cfloat a, cfloat b) {
    return {R::sub(a.x, b.x), R::sub(a.y, b.y)};
  }
  static __device__ __forceinline__ cfloat shfl(cfloat v, int src) {
    return {R::shfl(v.x, src), R::shfl(v.y, src)};
  }
};

template <>
struct Arith<cdouble> {
  using R = Arith<double>;
  static __device__ __forceinline__ cdouble zero() { return {0.0, 0.0}; }
  static __device__ __forceinline__ cdouble nan() { return {R::nan(), R::nan()}; }
  static __device__ __forceinline__ cdouble mul(cdouble a, cdouble b) {
    return {R::sub(R::mul(a.x, b.x), R::mul(a.y, b.y)),
            R::add(R::mul(a.x, b.y), R::mul(a.y, b.x))};
  }
  static __device__ __forceinline__ cdouble add(cdouble a, cdouble b) {
    return {R::add(a.x, b.x), R::add(a.y, b.y)};
  }
  static __device__ __forceinline__ cdouble sub(cdouble a, cdouble b) {
    return {R::sub(a.x, b.x), R::sub(a.y, b.y)};
  }
  static __device__ __forceinline__ cdouble shfl(cdouble v, int src) {
    return {R::shfl(v.x, src), R::shfl(v.y, src)};
  }
};

__device__ __forceinline__ unsigned long long load_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The first error of a launch wins; every later one only sees the abort.
__device__ void report(unsigned* hdr, unsigned code, int row) {
  if (atomicCAS(hdr + kAbort, 0u, code) == 0u) {
    atomicExch(hdr + kErrCode, code);
    atomicExch(hdr + kErrRow, static_cast<unsigned>(row));
  }
}

// A value of T as the 32-bit halves of its flag words.
template <typename T>
struct Chunks {
  static constexpr int kWords = sizeof(T) / 4;
  unsigned w[kWords];
};

template <typename T>
__device__ __forceinline__ Chunks<T> chunks_of(T v) {
  Chunks<T> c;
  memcpy(c.w, &v, sizeof(T));
  return c;
}

template <typename T>
__device__ __forceinline__ T value_of(const Chunks<T>& c) {
  T v;
  memcpy(&v, c.w, sizeof(T));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kExactThreads)
    tri_exact_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                     const T* __restrict__ inv_diag, const T* __restrict__ r,
                     const int32_t* __restrict__ order, const int32_t* __restrict__ row_len,
                     T* y, unsigned* hdr, int n, int K, unsigned long long watchdog_ns) {
  using A = Arith<T>;
  constexpr int W = Chunks<T>::kWords;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kExactThreads + threadIdx.x) >> 5;
  const int warps = gridDim.x * kWarpsPerBlock;
  unsigned long long* words = reinterpret_cast<unsigned long long*>(hdr + kFlags);
  const unsigned long long tag = static_cast<unsigned long long>(kStamp) << 32;

  for (int p = warp; p < n; p += warps) {
    const int row = order[p];
    const int len = row_len[row];
    const T* v_row = vals + static_cast<int64_t>(row) * K;
    const int32_t* c_row = cols + static_cast<int64_t>(row) * K;
    // The row's own operands are loaded before it waits, so that their
    // latency overlaps the wait instead of following it.
    const T r_row = r[row];
    const T d_row = inv_diag[row];
    T acc = A::zero();
    bool failed = false;  // a bad column or a wait cut short: y[row] is NaN
    for (int base = 0; base < len; base += 32) {
      const int k = base + lane;
      int c = 0;
      T v = A::zero();
      Chunks<T> yc = chunks_of(A::zero());
      bool ready = true;
      if (k < len) {
        c = c_row[k];
        v = v_row[k];
        if (c < 0 || c >= n) {
          report(hdr, kBadColumn, row);
          failed = true;
          c = 0;
        } else {
          ready = false;
        }
      }
      const unsigned long long* wc = words + static_cast<int64_t>(c) * W;
      unsigned polls = 0;
      unsigned long long t0 = 0;
      while (!__all_sync(kFull, ready)) {
        if (!ready) {
          unsigned long long got[W];
#pragma unroll
          for (int j = 0; j < W; ++j) got[j] = load_relaxed64(wc + j);
          ready = true;
#pragma unroll
          for (int j = 0; j < W; ++j) {
            ready = ready && (got[j] >> 32) == kStamp;
            yc.w[j] = static_cast<unsigned>(got[j]);
          }
        }
        if (++polls % kPollsPerCheck == 0) {
          int stop = 0;
          if (lane == 0) {
            stop = *reinterpret_cast<volatile unsigned*>(hdr + kAbort) != 0u;
            const unsigned long long t = now_ns();
            if (t0 == 0) {
              t0 = t;
            } else if (!stop && t - t0 > watchdog_ns) {
              report(hdr, kTimeout, row);
              stop = 1;
            }
          }
          if (__shfl_sync(kFull, stop, 0)) {
            failed = true;
            break;
          }
        }
      }
      const T prod = k < len ? A::mul(v, value_of(yc)) : A::zero();
      const int m = min(32, len - base);
      for (int j = 0; j < m; ++j) acc = A::add(acc, A::shfl(prod, j));
    }
    failed = __any_sync(kFull, failed);
    if (lane == 0) {
      const T yv = failed ? A::nan() : A::mul(A::sub(r_row, acc), d_row);
      y[row] = yv;
      const Chunks<T> out = chunks_of(yv);
      unsigned long long* wr = words + static_cast<int64_t>(row) * W;
#pragma unroll
      for (int j = 0; j < W; ++j) store_relaxed64(wr + j, tag | out.w[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
    tri_sweep_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                     const T* __restrict__ inv_diag, const T* __restrict__ r,
                     const T* __restrict__ y_old, T* __restrict__ y_new, int n, int K,
                     int first) {
  using A = Arith<T>;
  const int i = blockIdx.x * kSweepThreads + threadIdx.x;
  if (i >= n) return;
  const T* v_row = vals + static_cast<int64_t>(i) * K;
  const int32_t* c_row = cols + static_cast<int64_t>(i) * K;
  T acc = A::zero();
  for (int k = 0; k < K; ++k) {
    const int c = c_row[k];
    T yc = A::zero();  // the plain version's y_pad[n] = 0
    if (static_cast<unsigned>(c) < static_cast<unsigned>(n))
      yc = first ? A::mul(inv_diag[c], r[c]) : y_old[c];
    acc = A::add(acc, A::mul(v_row[k], yc));
  }
  y_new[i] = A::mul(inv_diag[i], A::sub(r[i], acc));
}

__global__ void l2_chase_kernel(const int32_t* __restrict__ next, int64_t steps,
                                int32_t* out) {
  int32_t i = 0;
  for (int64_t s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}

template <typename T>
int launch_exact(const void* vals, const void* cols, const void* inv_diag, const void* r,
                 const void* order, const void* row_len, void* y, void* scratch, int n, int K,
                 unsigned long long watchdog_ns, cudaStream_t stream) {
  // The grid: as many blocks as are resident at once (the cooperative
  // launch refuses more), but no warp without a first row.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_exact_kernel<T>,
                                                      kExactThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = max(1, min(sms * per_sm, (n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const T* v = static_cast<const T*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const T* d = static_cast<const T*>(inv_diag);
  const T* rr = static_cast<const T*>(r);
  const int32_t* o = static_cast<const int32_t*>(order);
  const int32_t* len = static_cast<const int32_t*>(row_len);
  T* yy = static_cast<T*>(y);
  unsigned* hdr = static_cast<unsigned*>(scratch);
  void* args[] = {&v, &c, &d, &rr, &o, &len, &yy, &hdr, &n, &K, &watchdog_ns};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(tri_exact_kernel<T>), blocks, kExactThreads, args,
      0, stream));
}

template <typename T>
void launch_sweep(const void* vals, const void* cols, const void* inv_diag, const void* r,
                  const void* y_old, void* y_new, int n, int K, int first,
                  cudaStream_t stream) {
  const int blocks = (n + kSweepThreads - 1) / kSweepThreads;
  tri_sweep_kernel<T><<<blocks, kSweepThreads, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const T*>(inv_diag), static_cast<const T*>(r), static_cast<const T*>(y_old),
      static_cast<T*>(y_new), n, K, first);
}

}  // namespace

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// T1.  vals (n + 1, K) and inv_diag (n + 1,) of dtype, cols int32 (n + 1,
// K), r and y (n,) of dtype, order and row_len int32 (n,), scratch (4 +
// 2n·itemsize/4,) 32-bit words, all contiguous on the current device.
// Zeroes scratch and launches the solve on the stream, without waiting.
// When it ends, scratch[1] is 0, or the watchdog's error (1: a wait passed
// watchdog_s, 2: a column outside [0, n)) with the row in scratch[2].
int stormx_tri_exact(const void* vals, const void* cols, const void* inv_diag, const void* r,
                     const void* order, const void* row_len, void* y, void* scratch, int n,
                     int K, int dtype, double watchdog_s, void* stream_) {
  if (n == 0) return 0;
  if (K < 1 || dtype < kF32 || dtype > kC128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t words = kFlags + static_cast<size_t>(2) * n *
                       (dtype == kF32 ? 1 : dtype == kC128 ? 4 : 2);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, words * 4, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long watchdog_ns = static_cast<unsigned long long>(watchdog_s * 1e9);
  switch (dtype) {
    case kF32:
      return launch_exact<float>(vals, cols, inv_diag, r, order, row_len, y, scratch, n, K,
                                 watchdog_ns, stream);
    case kF64:
      return launch_exact<double>(vals, cols, inv_diag, r, order, row_len, y, scratch, n, K,
                                  watchdog_ns, stream);
    case kC64:
      return launch_exact<cfloat>(vals, cols, inv_diag, r, order, row_len, y, scratch, n, K,
                                  watchdog_ns, stream);
    case kC128:
      return launch_exact<cdouble>(vals, cols, inv_diag, r, order, row_len, y, scratch, n, K,
                                   watchdog_ns, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// T2, one sweep.  vals, cols, inv_diag as for T1; r, y_old and y_new (n,) of
// dtype, contiguous on the current device (y_old is not read when first).
int stormx_tri_sweep(const void* vals, const void* cols, const void* inv_diag, const void* r,
                     const void* y_old, void* y_new, int n, int K, int dtype, int first,
                     void* stream_) {
  if (n == 0) return 0;
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (dtype) {
    case kF32: launch_sweep<float>(vals, cols, inv_diag, r, y_old, y_new, n, K, first, stream); break;
    case kF64: launch_sweep<double>(vals, cols, inv_diag, r, y_old, y_new, n, K, first, stream); break;
    case kC64: launch_sweep<cfloat>(vals, cols, inv_diag, r, y_old, y_new, n, K, first, stream); break;
    case kC128: launch_sweep<cdouble>(vals, cols, inv_diag, r, y_old, y_new, n, K, first, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The L2 probe: `steps` dependent loads along next (int32, a cycle), one
// thread; out receives the last index.
int stormx_l2_chase(const void* next, int64_t steps, void* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), steps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
