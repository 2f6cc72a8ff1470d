// T1 and T2: the sparse triangular solve (D + N)·y = r of
// stormx_torch/precond/triangular.py for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It stands for the JAX package's level loop,
// an XLA program (stormx/precond/triangular.py:146-175, tri_solve): the
// exact solve walks the dependency levels in one lax.fori_loop, and the
// sweeps mode runs a fixed number of Jacobi sweeps.  The factor is the
// host-built ELL form of N (vals and int32 cols, (n + 1, K), the real
// entries of row i in its first row_len[i] slots, zeros after), inv_diag
// (n + 1,), and for T1 the rows cut into strands.
//
// Both kernels add each row's slots in slot order, k = 0..K−1, one
// rounded multiply and one rounded add per slot (no FMA contraction: the
// _rn intrinsics), then form (r − acc)·inv_diag: the rounding of the plain
// version (ops/tri_solve.py, slot_sum), which they equal bit for bit in
// float32 and float64.  Complex products are written out in one fixed
// order, (a.x·b.x − a.y·b.y, a.x·b.y + a.y·b.x).
//
// T1, the exact solve in one launch (tri_exact_kernel).  Bound on this
// card: latency, not bytes.  A row can start only once the rows it reads
// are written, so the solve is a chain of num_levels dependent steps
// against a few MB of bytes.  A step between two rows that
// different warps solve is a hop through L2: a flag (and the value) stored
// by one SM and polled by another, ~250 ns on an H100 with nothing around
// it (stormx_flag_hop) and ~560 ns a level inside a kernel that polled a
// row a warp.  The design takes most steps off L2 and keeps the rest short.
//   * Strands.  The host cuts the rows into strands (precond/triangular.py,
//     strands): chains of rows, each reading the row before it one level
//     down (its link), packed one after another, so a strand's levels
//     increase and there are as many strands as the widest level has rows.
//     Each strand has a warp (one a block).
//   * Lanes hold rows ahead.  Lane j holds the strand's rows j, j + 32,
//     j + 64, ... in turn, with S of its slots at once (S the power of two
//     at or above K, at most 8; a row of more takes passes), and polls the
//     flags of its row's slots but the link from the moment it takes the
//     row, 32 rows before the row's turn.  It holds the next row's
//     operands, the row after that, and the strand's row before each,
//     loaded 32 and 64 rows ahead, so taking a row is register moves.
//   * The scan.  After each poll, the warp solves its strand's rows from
//     the head, in turn, while the lane that holds the head has seen every
//     flag it waits on: it adds the row's slots in slot order (the link's
//     y is the warp's carry, passed by one shuffle), forms
//     (r − acc)·inv_diag and stores the row's flag words.  A run of linked rows costs a
//     shuffle and a few flops a row, not a hop.  The lane that solved takes
//     its next row at once; its y store, its loads and the arming of the
//     row it took wait for the next poll, so the scan's steps hold the
//     chain's work only.
//   * Progress.  The launch is cooperative and every warp is resident (a
//     strand may wait on any other; the wrapper falls back to dealing the
//     level order out round robin to as many strands as the card holds,
//     tri_solve.round_robin_strands).  Every dependency of a row lies in an
//     earlier level.  Take an unsolved row of the lowest level: every row
//     before it in its strand is at a lower level, so solved, so it is its
//     strand's head, its flags are all stored, and its lane, which polls
//     whatever it waits on, sees them: it is solved.  The solve cannot
//     deadlock.
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
//   * Watchdog.  A lane that waits longer than watchdog_ns on its row's
//     flags, or meets a column outside [0, n), stores an error code and the
//     row in the header and raises the abort word; every warp sees it within
//     kPollsPerCheck polls and stops waiting, so the launch ends.  Such a
//     row, every row that stops waiting and every row armed after, writes
//     NaN (and the rows that read them, through the arithmetic), so the
//     solve's y is never a wrong number.  The C entry does not wait: it
//     copies the error words to the caller's pinned host words behind the
//     launch and records the caller's event; the wrapper reads them once
//     the event has passed (ops/tri_solve.py), which raises StormError.
//   * On an H100 (PERF.md §6): 103 ns a row on a chain of links, 0.46 ms
//     on the 318k IC(0) lower factor (1,445 levels: 318 ns a level) against
//     0.82 ms with a row a warp; the steps that remain hops bound it.  (Rows
//     grouped by K inside a warp, G lanes a row, with a grid sized to the
//     widest level, did not beat a row a warp there: a warp's groups share
//     one instruction stream, so each group that finishes a row stalls its
//     siblings' polls.)

// T2, one Jacobi sweep y' = inv_diag·(r − N·y) in one launch, one thread a
// row over all K slots (padding included, as the plain version reads
// them).  The first sweep of a solve forms y0 = inv_diag·r inline where it
// reads y, so a k-sweep solve is k launches.  Bound on this card: bytes
// (the factor, r, inv_diag and y once each).
//
// stormx_l2_chase: a measurement probe, on no path.  One thread follows a
// random cycle of int32 links through L2 (ld.cg), the dependent L2 round
// trip that T1's latency bound counts once per level.
//
// stormx_flag_hop: a measurement probe, on no path.  Two one-thread blocks
// pass a count back and forth through one 64-bit word, each polling it
// relaxed until it holds its turn and storing the next (relaxed): the hop
// T1 pays a level, with no work around it.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

// A factor's T1 launch, packed once by the wrapper (ops/tri_solve.py,
// _Launch): the arrays T1 reads and the shape.  New fields go at the end:
// scripts/torch_t1_variants.py runs builds of earlier versions of this
// source on today's records.
struct TriLaunch {
  const void* vals;
  const void* cols;
  const void* inv_diag;
  const void* row_len;
  int n, K, dtype;
  double watchdog_s;
  // Slots a lane at once, and the strands (precond/triangular.py, strands):
  // strand_rows (n,), strand_ptr (strands + 1,), int32.
  int slots, strands;
  const void* strand_rows;
  const void* strand_ptr;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kExactThreads = 32;  // T1: a warp a strand, one a block
constexpr int kSweepThreads = 256;
constexpr unsigned kPollsPerCheck = 64;  // flag polls between watchdog checks
constexpr int kMaxDevices = 64;

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

// A row's operands for the lane that holds it: the row (−1: none), row_len,
// r, inv_diag, and the columns and values of its first S slots (zero past
// K).
template <typename T, int S>
struct RowOps {
  int row, len;
  T r, d;
  int c[S];
  T v[S];
};

template <typename T, int S>
__device__ __forceinline__ RowOps<T, S> row_ops(const T* __restrict__ vals,
                                                const int32_t* __restrict__ cols,
                                                const T* __restrict__ inv_diag,
                                                const T* __restrict__ r,
                                                const int32_t* __restrict__ row_len, int row,
                                                int K) {
  RowOps<T, S> o;
  o.row = row;
  o.len = 0;
  o.r = o.d = Arith<T>::zero();
#pragma unroll
  for (int j = 0; j < S; ++j) {
    o.c[j] = 0;
    o.v[j] = Arith<T>::zero();
  }
  if (row >= 0) {
    o.len = row_len[row];
    o.r = r[row];
    o.d = inv_diag[row];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j < K) {
        o.c[j] = cols[static_cast<int64_t>(row) * K + j];
        o.v[j] = vals[static_cast<int64_t>(row) * K + j];
      }
    }
  }
  return o;
}

// One warp a strand; S, the slots a lane holds at once: a power of two
// (ops/tri_solve.py, grid_slots).
template <typename T, int S>
__global__ void __launch_bounds__(kExactThreads)
    tri_exact_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                     const T* __restrict__ inv_diag, const T* __restrict__ r,
                     const int32_t* __restrict__ strand_rows,
                     const int32_t* __restrict__ strand_ptr, const int32_t* __restrict__ row_len,
                     T* y, unsigned* hdr, int n, int K, unsigned long long watchdog_ns) {
  using A = Arith<T>;
  constexpr int W = Chunks<T>::kWords;
  const int lane = threadIdx.x;  // the lane's rows: first + lane + 32k of the strand
  unsigned long long* words = reinterpret_cast<unsigned long long*>(hdr + kFlags);
  const unsigned long long tag = static_cast<unsigned long long>(kStamp) << 32;

  const int first = strand_ptr[blockIdx.x], last = strand_ptr[blockIdx.x + 1];
  auto row_at = [&](int i) { return i < last ? strand_rows[i] : -1; };  // -1: no row
  // The lane's row in hand (index q of strand_rows), its next (q + 32, its
  // operands loaded ahead) and the one after (q + 64, its row loaded
  // ahead), each with the strand's row before it: a lane taking its next
  // row finds what it reads landed, 32 rows later.
  int q = first + lane;
  RowOps<T, S> cur = row_ops<T, S>(vals, cols, inv_diag, r, row_len, row_at(q), K);
  RowOps<T, S> next = row_ops<T, S>(vals, cols, inv_diag, r, row_len, row_at(q + 32), K);
  int row_after = row_at(q + 64);
  const int before_first = q > first ? row_at(q - 1) : -1;
  int before_next = row_at(q + 31), before_after = row_at(q + 63);

  int h = 0;              // the lane that holds the strand's first unsolved row
  T carry = A::zero();    // that row's link: y of the strand's row before it
  int base = 0;           // the first slot of the lane's pass in hand
  T acc = A::zero();      // the row's slots before base, added in slot order
  unsigned pending = 0;   // slots of the pass whose flag has not been seen yet
  int link = -1;          // the slot that reads the strand's row before: y is carry
  bool failed = false;    // a bad column or a wait cut short: y[row] is NaN
  bool stop = false;      // the launch is aborting: no more waiting
  bool moved = false;     // the lane has just taken its next row: y to store, next to load
  int solved_row = -1;    // the row it solved, and y
  T solved_y = A::zero();
  Chunks<T> yc[S];
  unsigned long long t0 = 0;  // when the watchdog first saw this wait
  // The lane's slots of the pass from base.  In a row of at most S slots, a
  // slot that reads the strand's row before (`before`) takes its y from the
  // warp when the row is solved; every other real slot waits on its flag.
  auto arm = [&](int before) {
    pending = 0;
    link = -1;
    t0 = 0;
    if (cur.row < 0) return;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (base + j >= cur.len) continue;
      if (cur.c[j] < 0 || cur.c[j] >= n) {
        report(hdr, kBadColumn, cur.row);
        failed = true;
      } else if (cur.len <= S && cur.c[j] == before) {
        link = j;
      } else if (stop) {
        failed = true;
      } else {
        pending |= 1u << j;
      }
    }
  };
  arm(before_first);

  for (unsigned polls = 1;; ++polls) {
    // A lane that took its next row in the last scan stores the y it
    // solved, loads the row 32 on and arms the row it took: work kept out
    // of the scan, whose steps are the chain's.
    if (moved) {
      moved = false;
      y[solved_row] = solved_y;
      const int before = before_next;
      next = row_ops<T, S>(vals, cols, inv_diag, r, row_len, row_after, K);
      before_next = before_after;
      row_after = row_at(q + 64);
      before_after = row_at(q + 63);
      arm(before);
    }
    if (pending) {  // every pending slot's flag words are loaded before any is tested
      unsigned long long got[S][W];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (pending & (1u << j)) {
          const unsigned long long* wc = words + static_cast<int64_t>(cur.c[j]) * W;
#pragma unroll
          for (int w = 0; w < W; ++w) got[j][w] = load_relaxed64(wc + w);
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (pending & (1u << j)) {
          bool seen = true;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            seen = seen && (got[j][w] >> 32) == kStamp;
            yc[j].w[w] = static_cast<unsigned>(got[j][w]);
          }
          if (seen) pending &= ~(1u << j);
        }
      }
    }
    // A row of more slots than S: each whole pass but the last is added as
    // it lands, then the next pass is loaded (no slot of it is a link).
    if (cur.row >= 0 && pending == 0u && base + S < cur.len) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (!failed) acc = A::add(acc, A::mul(cur.v[j], value_of(yc[j])));
      base += S;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (base + j < cur.len) {
          cur.c[j] = cols[static_cast<int64_t>(cur.row) * K + base + j];
          cur.v[j] = vals[static_cast<int64_t>(cur.row) * K + base + j];
        }
      }
      arm(-1);
    }
    // The scan: the warp solves its strand's rows from the head, in turn,
    // for as long as the lane that holds the head has seen every flag it
    // waits on; y passes to the next row through carry, so a run of linked
    // rows costs no trip through L2.
#pragma unroll 1
    for (int step = 0; step < 32; ++step) {
      const bool go = lane == h && cur.row >= 0 && pending == 0u && base + S >= cur.len;
      if (__ballot_sync(kFull, go) == 0u) break;
      T yv = A::zero();
      if (go) {
        T sum = acc;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (base + j < cur.len)
            sum = A::add(sum, A::mul(cur.v[j], j == link ? carry : value_of(yc[j])));
        }
        yv = failed ? A::nan() : A::mul(A::sub(cur.r, sum), cur.d);
        const Chunks<T> out = chunks_of(yv);
        unsigned long long* wr = words + static_cast<int64_t>(cur.row) * W;
#pragma unroll
        for (int w = 0; w < W; ++w) store_relaxed64(wr + w, tag | out.w[w]);
        // The lane takes its next row, 32 on, armed before it is the head.
        solved_row = cur.row;
        solved_y = yv;
        moved = true;
        q += 32;
        cur = next;
        base = 0;
        acc = A::zero();
        failed = false;
        pending = 0;
        link = -1;
      }
      carry = A::shfl(yv, h);
      h = (h + 1) & 31;
    }
    if (__ballot_sync(kFull, cur.row >= 0 || moved) == 0u) break;
    if (polls % kPollsPerCheck == 0) {
      int aborted = 0;
      if (lane == 0) aborted = *reinterpret_cast<volatile unsigned*>(hdr + kAbort) != 0u;
      bool late = false;
      if (pending) {
        const unsigned long long t = now_ns();
        if (t0 == 0) {
          t0 = t;
        } else if (t - t0 > watchdog_ns) {
          report(hdr, kTimeout, cur.row);
          late = true;
        }
      }
      const bool any_late = __any_sync(kFull, late);
      if (__shfl_sync(kFull, aborted, 0) || any_late) stop = true;
      if (stop && pending) {
        failed = true;
        pending = 0;
      }
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

// Two one-thread blocks pass a count through one word: block b waits until
// it holds h (h ≡ b mod 2) and stores h + 1.  smid receives each block's SM.
__global__ void flag_hop_kernel(unsigned long long* word, int64_t hops, int32_t* smid) {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  smid[blockIdx.x] = static_cast<int32_t>(sm);
  for (int64_t h = blockIdx.x; h < hops; h += 2) {
    while (load_relaxed64(word) != static_cast<unsigned long long>(h)) {
    }
    store_relaxed64(word, static_cast<unsigned long long>(h + 1));
  }
}

// The warps of tri_exact_kernel<T, S> resident at once on the current
// device (one a block), read once per device; negative: a CUDA error.
template <typename T, int S>
int resident_warps() {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int most = dev < kMaxDevices ? resident[dev] : 0;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_exact_kernel<T, S>,
                                                        kExactThreads, 0);
    if (e != cudaSuccess) return -static_cast<int>(e);
    most = sms * per_sm;
    if (dev < kMaxDevices) resident[dev] = most;
  }
  return most;
}

template <typename T, int S>
int launch_exact_s(const TriLaunch* L, const void* r, void* y, void* scratch,
                   unsigned long long watchdog_ns, cudaStream_t stream) {
  // The grid: a warp for every strand, one a block.  Every warp must be
  // resident at once (a strand may wait on any other): the cooperative
  // launch refuses a grid that is not, and the wrapper asks for the card's
  // room first (stormx_tri_grid_warps).
  const int most = resident_warps<T, S>();
  if (most < 0) return -most;
  if (L->strands > most) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const T* v = static_cast<const T*>(L->vals);
  const int32_t* c = static_cast<const int32_t*>(L->cols);
  const T* d = static_cast<const T*>(L->inv_diag);
  const T* rr = static_cast<const T*>(r);
  const int32_t* sr = static_cast<const int32_t*>(L->strand_rows);
  const int32_t* sp = static_cast<const int32_t*>(L->strand_ptr);
  const int32_t* len = static_cast<const int32_t*>(L->row_len);
  T* yy = static_cast<T*>(y);
  unsigned* hdr = static_cast<unsigned*>(scratch);
  int n = L->n, K = L->K;
  void* args[] = {&v, &c, &d, &rr, &sr, &sp, &len, &yy, &hdr, &n, &K, &watchdog_ns};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(tri_exact_kernel<T, S>), L->strands, kExactThreads, args,
      0, stream));
}

// S, slots a lane, of 1, 2, 4 or 8: the launch, or with launch false the
// resident warps.
template <typename T>
int exact_slots(int S, const TriLaunch* L, const void* r, void* y, void* scratch,
                unsigned long long watchdog_ns, cudaStream_t stream, bool launch) {
  switch (S) {
    case 1: return launch ? launch_exact_s<T, 1>(L, r, y, scratch, watchdog_ns, stream)
                          : resident_warps<T, 1>();
    case 2: return launch ? launch_exact_s<T, 2>(L, r, y, scratch, watchdog_ns, stream)
                          : resident_warps<T, 2>();
    case 4: return launch ? launch_exact_s<T, 4>(L, r, y, scratch, watchdog_ns, stream)
                          : resident_warps<T, 4>();
    case 8: return launch ? launch_exact_s<T, 8>(L, r, y, scratch, watchdog_ns, stream)
                          : resident_warps<T, 8>();
  }
  return launch ? static_cast<int>(cudaErrorInvalidValue)
                : -static_cast<int>(cudaErrorInvalidValue);
}

int exact_dtype(int dtype, int S, const TriLaunch* L, const void* r, void* y, void* scratch,
                unsigned long long watchdog_ns, cudaStream_t stream, bool launch) {
  switch (dtype) {
    case kF32: return exact_slots<float>(S, L, r, y, scratch, watchdog_ns, stream, launch);
    case kF64: return exact_slots<double>(S, L, r, y, scratch, watchdog_ns, stream, launch);
    case kC64: return exact_slots<cfloat>(S, L, r, y, scratch, watchdog_ns, stream, launch);
    case kC128: return exact_slots<cdouble>(S, L, r, y, scratch, watchdog_ns, stream, launch);
  }
  return launch ? static_cast<int>(cudaErrorInvalidValue)
                : -static_cast<int>(cudaErrorInvalidValue);
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

// T1.  L's vals (n + 1, K) and inv_diag (n + 1,) of dtype, cols int32
// (n + 1, K), row_len and strand_rows int32 (n,), strand_ptr int32
// (strands + 1,); r and y (n,) of dtype, scratch (4 + 2n·itemsize/4,)
// 32-bit words, all contiguous on the current device; L's slots (S a lane:
// 1, 2, 4 or 8) and strands (at least 1, a warp each, all resident at
// once: stormx_tri_grid_warps).  Zeroes scratch and launches the solve on
// the stream, without waiting, then copies the two error words to err_host (pinned) and
// records event.  They read 0, or the watchdog's error (1: a wait passed
// watchdog_s, 2: a column outside [0, n)) and its row.
int stormx_tri_exact(const TriLaunch* L, const void* r, void* y, void* scratch, void* err_host,
                     void* event, void* stream_) {
  const int n = L->n, K = L->K, dtype = L->dtype;
  if (n == 0) return 0;
  if (K < 1 || dtype < kF32 || dtype > kC128 || L->strands < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t words = kFlags + static_cast<size_t>(2) * n *
                       (dtype == kF32 ? 1 : dtype == kC128 ? 4 : 2);
  cudaError_t e = cudaMemsetAsync(scratch, 0, words * 4, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long watchdog_ns = static_cast<unsigned long long>(L->watchdog_s * 1e9);
  const int rc = exact_dtype(dtype, L->slots, L, r, y, scratch, watchdog_ns, stream, true);
  if (rc != 0) return rc;
  e = cudaMemcpyAsync(err_host, static_cast<unsigned*>(scratch) + kErrCode,
                      2 * sizeof(unsigned), cudaMemcpyDeviceToHost, stream);
  if (e == cudaSuccess) e = cudaEventRecord(static_cast<cudaEvent_t>(event), stream);
  return static_cast<int>(e);
}

// The warps of T1 resident at once on the current device, at S
// slots a lane, for dtype (negative: a CUDA error; an S not built:
// -cudaErrorInvalidValue).
int stormx_tri_grid_warps(int dtype, int S) {
  return exact_dtype(dtype, S, nullptr, nullptr, nullptr, nullptr, 0, nullptr, false);
}

// Two error words of T1 in pinned host memory, made once a slot by the
// wrapper, for stormx_tri_exact to copy them into.
int stormx_tri_host_words(void** host) {
  void* h = nullptr;
  const cudaError_t e = cudaHostAlloc(&h, 2 * sizeof(unsigned), cudaHostAllocDefault);
  if (e != cudaSuccess) return static_cast<int>(e);
  memset(h, 0, 2 * sizeof(unsigned));
  *host = h;
  return 0;
}

// The events behind T1's error words, made once and reused by the wrapper.
int stormx_tri_event_create(void** event) {
  cudaEvent_t e = nullptr;
  const cudaError_t rc = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
  *event = e;
  return static_cast<int>(rc);
}

// 0 once the event has passed, cudaErrorNotReady (600) before.
int stormx_tri_event_query(void* event) {
  return static_cast<int>(cudaEventQuery(static_cast<cudaEvent_t>(event)));
}

int stormx_tri_event_sync(void* event) {
  return static_cast<int>(cudaEventSynchronize(static_cast<cudaEvent_t>(event)));
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

// The flag-hop probe: `hops` hops of a count between two blocks through
// word (one 64-bit word, zeroed by the caller); smid (two int32) receives
// the blocks' SMs.
int stormx_flag_hop(void* word, int64_t hops, void* smid, void* stream) {
  flag_hop_kernel<<<2, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(word), hops, static_cast<int32_t*>(smid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
