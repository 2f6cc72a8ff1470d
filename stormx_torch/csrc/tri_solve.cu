// T1 and T2: the sparse triangular solve (D + N)·y = r of
// stormx_torch/precond/triangular.py for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It stands for the JAX package's level loop,
// an XLA program (stormx/precond/triangular.py:146-175, tri_solve): the
// exact solve walks the dependency levels in one lax.fori_loop, and the
// sweeps mode runs a fixed number of Jacobi sweeps.  The factor is the
// host-built ELL form of N (vals and int32 cols, (n + 1, K), the real
// entries of row i in its first row_len[i] slots, zeros after), inv_diag
// (n + 1,), and for T1 the rows cut into strands ("grid") or ordered level
// by level ("block").
//
// Both kernels add each row's slots in slot order, k = 0..K−1, one
// rounded multiply and one rounded add per slot (no FMA contraction: the
// _rn intrinsics), then form (r − acc)·inv_diag: the rounding of the plain
// version (ops/tri_solve.py, slot_sum), which they equal bit for bit in
// float32 and float64.  Complex products are written out in one fixed
// order, (a.x·b.x − a.y·b.y, a.x·b.y + a.y·b.x).
//
// T1, the exact solve in one launch, in two branches that give the same y
// bit for bit: "grid" (below, the first kernel) and "block" (after it).
//
// T1 "grid".  Bound on this card: latency, not bytes.  A row can start only
// once the rows it reads are written, so the solve is a chain of num_levels
// dependent steps against a few MB of bytes.  A step between two rows that
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

// T1 "block": the whole solve in one block on one SM, so that the hop from
// one row to a row that reads it stays inside the SM, not an L2 round trip
// between SMs.  It reads the factor in position order (the rows as order
// lists them, each dependency named by its position: build_triangular's
// pos_* arrays), so the factor streams in one direction.
//   * Producer warp (the block's last).  Copies chunks of S positions (their
//     values, column positions, inv_diag and info: row, row_len, level
//     bounds) into rings of D·S entries in shared memory with the 1-D bulk
//     copy (cp.async.bulk, complete_tx on mbarriers), up to D chunks ahead
//     of the consumers, then gathers r[row] of each chunk's rows into its
//     ring with cp.async (4-, 8- or 16-byte async copies, no register
//     held), kLag chunks behind its bulk copies, so that the rows it reads
//     have landed.  S and D are powers of two: position p sits at entry
//     p mod D·S of every ring.
//   * Consumer warps (T = 512 threads) walk the positions in passes of T,
//     whatever their levels; thread t takes position a + t of the pass from
//     a.  Before the barrier that ends a pass, each thread loads its
//     position of the next pass out of the rings into registers, since
//     none of it depends on y.  A dependency at position q ≥ b − W (b the
//     pass's end) is read from a window of the W most recent positions in
//     shared memory, whose words each carry a 32-bit tag, the position,
//     beside 32 bits of its y (as "grid"'s flags do in L2): a row whose
//     dependency lies in its own pass polls the slot until the tag is q,
//     one poll loop for all its slots.  An older dependency is read from
//     global y (through L2), which this block wrote before an earlier
//     barrier, and that read too is made before the barrier (W ≥ 2T puts q
//     in a pass that ended before it).  Each row adds its real slots in
//     slot order, then forms (r − acc)·inv_diag, and writes y to its
//     window slot (tagged) and to y[row].  One named barrier over the
//     consumer warps ends each pass; after it, thread 0 hands the producer
//     back every stage whose positions are all in registers or done.
//   * Progress.  A row reads only positions before it and before its
//     level's start (anything else is an error, below), and every row of a
//     pass has its own thread, so the lowest unfinished row of a pass can
//     always finish.  The ring holds ceil(T/S) + kLag + 2 stages or more, so
//     the producer can always fill the stages the next pass needs.
//   * Errors.  A column position outside [0, min(the row's level start,
//     its position)) is a dependency that is not in an earlier level: a
//     corrupt factor.  Its row gets NaN (and the rows that read it, through
//     the arithmetic), the first such row and code 3 go into the header,
//     and the solve runs on; no row waits on it.  The branch needs no
//     watchdog, no scratch and no memset: the kernel writes its two error
//     words at its end.
//   * Bound on this card: the chain of rows (block_level_ns measures one
//     barrier hop inside a block) against one SM's stream of the factor;
//     scripts/torch_t1_variants.py reports both.  On an H100 it beats
//     "grid" on chains and on levels of up to ~100 rows, and loses on the
//     smoke's mesh factors (PERF.md §6), so the branch rule
//     (ops/tri_solve.py, t1_branch) gives it only narrow levels and K ≤
//     kBlockMaxK.

// T2, one Jacobi sweep y' = inv_diag·(r − N·y) in one launch, one thread a
// row over all K slots (padding included, as the plain version reads
// them).  The first sweep of a solve forms y0 = inv_diag·r inline where it
// reads y, so a k-sweep solve is k launches.  Bound on this card: bytes
// (the factor, r, inv_diag and y once each).
//
// stormx_l2_chase: a measurement probe, on no path.  One thread follows a
// random cycle of int32 links through L2 (ld.cg), the dependent L2 round
// trip that T1 "grid"'s latency bound counts once per level.
//
// stormx_flag_hop: a measurement probe, on no path.  Two one-thread blocks
// pass a count back and forth through one 64-bit word, each polling it
// relaxed until it holds its turn and storing the next (relaxed): the hop
// T1 "grid" pays a level, with no work around it.
//
// stormx_tri_block_hop: a measurement probe, on no path.  One block of
// 1,024 threads walks a chain of levels; at each, one thread reads from
// shared memory the value another warp wrote before the last barrier, adds
// one and writes it, then every thread passes a barrier: the hop that T1
// "block"'s latency bound counts once per level.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

// A factor's T1 launch, packed once by the wrapper (ops/tri_solve.py,
// _Launch): the arrays "grid" reads, those "block" reads, and the shape.
// New fields go at the end: scripts/torch_t1_variants.py runs builds of
// earlier versions of this source on today's records.
struct TriLaunch {
  const void* vals;
  const void* cols;
  const void* inv_diag;
  const void* order;  // the rows level by level: read by earlier versions only
  const void* row_len;
  const void* pos_vals;
  const void* pos_cols;
  const void* pos_inv_diag;
  const void* pos_info;
  int n, n_pad, K, dtype, S, D, W;
  double watchdog_s;
  // "grid": slots a lane at once, and the strands (precond/triangular.py,
  // strands): strand_rows (n,), strand_ptr (strands + 1,), int32.
  int slots, strands;
  const void* strand_rows;
  const void* strand_ptr;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kExactThreads = 32;  // T1 "grid": a warp a strand, one a block
constexpr int kSweepThreads = 256;
constexpr unsigned kPollsPerCheck = 64;  // flag polls between watchdog checks
constexpr int kBlockMaxK = 8;  // slots a row of T1 "block" holds in registers
constexpr int kLag = 2;        // chunks the producer's r gather runs behind its bulk copies
constexpr int kHopThreads = 1024;
constexpr int kMaxDevices = 64;

// Words of T1's scratch: the header, then one ready flag a row.
enum Header { kAbort = 0, kErrCode = 1, kErrRow = 2, kFlags = 4 };
enum ErrorCode { kTimeout = 1, kBadColumn = 2, kBadDependency = 3 };
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

// -- T1 "block" ----------------------------------------------------------------

// Threads of a block: 512 consumers and the producer warp.
constexpr int kBlockThreads = 512 + 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// An arrival that also arms the barrier with `bytes` of transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned); completion counted on `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One value of T from global `src` to shared `dst`, asynchronously.
template <typename T>
__device__ __forceinline__ void gather_async(T* dst, const T* src) {
  if constexpr (sizeof(T) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(static_cast<int>(sizeof(T)))
                 : "memory");
  }
}

// An arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void gather_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// y of a finished row, read through L2 (this block wrote it before an
// earlier barrier; L2 is where the SM's stores meet its loads).
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  Chunks<T> c;
  const unsigned* w = reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int j = 0; j < Chunks<T>::kWords; ++j) c.w[j] = __ldcg(w + j);
  return value_of(c);
}

__device__ __forceinline__ void consumers_sync(int consumers) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
}

// The ring: D·S positions (D and S powers of two) of values (K each),
// column positions (K each), inv_diag, info (int4) and r, one ring per
// array, so position p sits at entry p mod D·S of each; chunk c fills
// entries [(c mod D)·S, (c mod D)·S + S) of every ring, each run 16-byte
// aligned.  Then the window, W slots of sizeof(T)/4 64-bit words (a
// position's tag and 32 bits of its y each), and 3·D mbarriers.  Kept
// equal to tri_solve.block_smem_bytes.
template <typename T>
size_t block_smem_bytes(int S, int D, int K, int W) {
  const size_t entry = static_cast<size_t>(K) * (sizeof(T) + 4) + 2 * sizeof(T) + 16;
  return static_cast<size_t>(D) * S * entry + static_cast<size_t>(W) * 2 * sizeof(T) +
         3 * static_cast<size_t>(D) * sizeof(uint64_t);
}

// One thread's row of the next pass, loaded ahead: with dep[k] ≥ 0, the
// product of pv[k] and y of position dep[k], read from the window; with
// dep[k] < 0, pv[k] already is the product (a dependency older than the
// window), or the slot is past row_len.
template <typename T, int K>
struct Pending {
  int row, len;  // row < 0: no position in the pass
  bool bad;
  T r, d;
  T pv[K];
  int dep[K];
};

// K, the factor's slots a row, is a template constant (1..kBlockMaxK): a
// pass is a short run of instructions on each thread's critical path, and
// the slots are unrolled to exactly K.
template <typename T, int K>
__global__ void __launch_bounds__(kBlockThreads, 1)
    tri_block_kernel(const T* __restrict__ pos_vals, const int32_t* __restrict__ pos_cols,
                     const T* __restrict__ pos_inv_diag, const int4* __restrict__ pos_info,
                     const T* __restrict__ r, T* y, unsigned* __restrict__ err, int n,
                     int n_pad, int S, int D, int W) {
  using A = Arith<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned err_code, err_row;
  const int ds = D * S;  // positions the ring holds; a power of two
  T* ring_vals = reinterpret_cast<T*>(smem);
  int32_t* ring_cols = reinterpret_cast<int32_t*>(ring_vals + ds * K);
  T* ring_inv = reinterpret_cast<T*>(ring_cols + ds * K);
  int4* ring_info = reinterpret_cast<int4*>(ring_inv + ds);
  T* ring_r = reinterpret_cast<T*>(ring_info + ds);
  unsigned long long* win = reinterpret_cast<unsigned long long*>(ring_r + ds);
  uint64_t* meta = reinterpret_cast<uint64_t*>(win + W * Chunks<T>::kWords);  // info landed
  uint64_t* full = meta + D;                              // values, columns, inv_diag, r landed
  uint64_t* empty = full + D;                             // the consumers are done with a stage
  const int log_s = __ffs(S) - 1, log_d = __ffs(D) - 1;
  const int consumers = static_cast<int>(blockDim.x) - 32;
  const int chunks = (n_pad + S - 1) >> log_s;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D; ++s) {
      mbar_init(meta + s, 1);
      mbar_init(full + s, 1 + 32);  // the bulk copies' arrival, then each producer lane's
      mbar_init(empty + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    err_code = 0u;
    err_row = 0u;
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {  // the producer warp
    const int lane = threadIdx.x - consumers;
    for (int c = 0; c < chunks + kLag; ++c) {
      if (c < chunks) {
        const int s = c & (D - 1);
        // Use u = c / D of stage s waits for the consumers' release of use u − 1.
        if (c >= D) mbar_wait(empty + s, ((c >> log_d) - 1) & 1);
        if (lane == 0) {
          const unsigned rows = static_cast<unsigned>(min(S, n_pad - (c << log_s)));
          const size_t p0 = static_cast<size_t>(c) << log_s;
          const int e0 = s << log_s;  // the chunk's first ring entry
          mbar_arrive_expect_tx(meta + s, rows * 16u);
          bulk_load(ring_info + e0, pos_info + p0, rows * 16u, meta + s);
          mbar_arrive_expect_tx(full + s, rows * static_cast<unsigned>(K * (sizeof(T) + 4) +
                                                                       sizeof(T)));
          bulk_load(ring_vals + e0 * K, pos_vals + p0 * K,
                    rows * K * static_cast<unsigned>(sizeof(T)), full + s);
          bulk_load(ring_cols + e0 * K, pos_cols + p0 * K, rows * K * 4u, full + s);
          bulk_load(ring_inv + e0, pos_inv_diag + p0, rows * static_cast<unsigned>(sizeof(T)),
                    full + s);
        }
      }
      const int g = c - kLag;  // the chunk whose r this pass gathers
      if (g >= 0 && g < chunks) {
        const int s = g & (D - 1);
        mbar_wait(meta + s, (g >> log_d) & 1);
        const int e0 = s << log_s;
        const int rows = min(S, n_pad - (g << log_s));
        for (int i = lane; i < rows; i += 32) {
          const int row = ring_info[e0 + i].x;
          if (static_cast<unsigned>(row) < static_cast<unsigned>(n))
            gather_async(ring_r + e0 + i, r + row);
        }
        gather_arrive(full + s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wmask = W - 1, rmask = ds - 1;
  constexpr int kW = Chunks<T>::kWords;
  // No slot holds a position yet.
  for (int i = t; i < W * kW; i += consumers) win[i] = ~0ull;
  // lane 0's: the last chunk this warp has seen land.  Chunks are waited
  // for in order and stay until handed back past every position of the pass
  // that reads them, so each is waited for once.
  int waited = -1;

  // Every chunk from a's to the one that holds this warp's last position of
  // the pass from a has landed; the warp's other lanes see them after
  // __syncwarp.
  auto wait_chunks = [&](int a) {
    if (lane == 0) {
      const int c1 = min((a + (t | 31)) >> log_s, chunks - 1);
      for (int c = max(a >> log_s, waited + 1); c <= c1; ++c) {
        const unsigned parity = (c >> log_d) & 1;
        mbar_wait(meta + (c & (D - 1)), parity);
        mbar_wait(full + (c & (D - 1)), parity);
      }
      waited = max(waited, c1);
    }
    __syncwarp();
  };

  // Position a + t of the pass [a, b) out of the ring into o, and y of its
  // dependencies older than the window.  Every load is issued before any
  // is used.
  auto load = [&](int a, int b, Pending<T, K>& o) {
    const int p = a + t;
    const int e = p & rmask;
    const int4 info = ring_info[e];
    const T rv = ring_r[e], dv = ring_inv[e];
    int dep[K];
    T val[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dep[k] = ring_cols[e * K + k];
      val[k] = ring_vals[e * K + k];
    }
    o.row = -1;
    o.len = 0;
    o.bad = false;
    if (p >= b) return;
    o.row = static_cast<unsigned>(info.x) < static_cast<unsigned>(n) ? info.x : n;  // n: no row
    o.len = info.y;
    o.r = rv;
    o.d = dv;
    if (o.len < 0 || o.len > K || o.row == n) {
      o.bad = true;
      o.len = 0;
    }
    // A dependency must lie in an earlier level, so before the row's level
    // start and before the row: nothing waits on itself.  Selects, not
    // branches: only a dependency older than the window (rare on a mesh
    // factor) takes one.
    const int before = min(info.z, p);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool real = k < o.len;
      const bool bad = real && (dep[k] < 0 || dep[k] >= before);
      const bool old = real && !bad && dep[k] < b - W;
      o.bad = o.bad || bad;
      o.dep[k] = real && !bad && !old ? dep[k] : -1;
      o.pv[k] = val[k];
      if (old) o.pv[k] = A::mul(val[k], load_cg(y + __ldg(&pos_info[dep[k]].x)));
    }
  };

  // Whether position q's window slot holds q: each of its words carries
  // q's tag, so a word and its tag arrive together.
  auto landed = [&](int q) -> bool {
    const volatile unsigned long long* w = win + (q & wmask) * kW;
    bool ready = true;
#pragma unroll
    for (int j = 0; j < kW; ++j) ready = ready && static_cast<int>(w[j] >> 32) == q;
    return ready;
  };
  auto read_window = [&](int q) -> T {
    const volatile unsigned long long* w = win + (q & wmask) * kW;
    Chunks<T> c;
#pragma unroll
    for (int j = 0; j < kW; ++j) c.w[j] = static_cast<unsigned>(w[j]);
    return value_of(c);
  };

  // Row a + t of the pass from a: once every window dependency has landed
  // (one poll loop for all of them), its real slots in slot order, then
  // (r − acc)·inv_diag, to the window (tagged) and to y.  A slot past
  // row_len leaves acc as it was, as if it were not there.
  auto solve = [&](int a, const Pending<T, K>& o) {
    if (o.row < 0) return;
    while (true) {
      bool ready = true;
#pragma unroll
      for (int k = 0; k < K; ++k) ready = ready && (o.dep[k] < 0 || landed(o.dep[k]));
      if (ready) break;
    }
    T acc = A::zero();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T prod = o.dep[k] >= 0 ? A::mul(o.pv[k], read_window(o.dep[k])) : o.pv[k];
      const T sum = A::add(acc, prod);
      acc = k < o.len ? sum : acc;
    }
    T yv = A::mul(A::sub(o.r, acc), o.d);
    if (o.bad) {
      yv = A::nan();
      if (atomicCAS(&err_code, 0u, static_cast<unsigned>(kBadDependency)) == 0u)
        err_row = static_cast<unsigned>(o.row);
    }
    if (o.row < n) y[o.row] = yv;
    const int p = a + t;
    volatile unsigned long long* w = win + (p & wmask) * kW;
    const Chunks<T> c = chunks_of(yv);
#pragma unroll
    for (int j = 0; j < kW; ++j)
      w[j] = (static_cast<unsigned long long>(static_cast<unsigned>(p)) << 32) | c.w[j];
  };

  // Thread 0 hands back every stage below b once every consumer has its
  // positions below b in registers or done (past a barrier).
  int released = 0;
  auto release_below = [&](int b) {
    if (t != 0) return;
    while (((released + 1) << log_s) <= b) {
      mbar_arrive(empty + (released & (D - 1)));
      ++released;
    }
  };

  // Passes of T consecutive positions, whatever their levels: a row waits
  // in the window for the rows of its own pass that it reads, and finds
  // those of earlier passes there or in y.
  wait_chunks(0);
  int a = 0, b = min(n, consumers);
  Pending<T, K> q, qn;  // this thread's row of the pass in hand, of the next
  load(a, b, q);
  consumers_sync(consumers);  // also shows every slot's empty tag
  release_below(b);
  while (true) {
    // The next pass's loads go out before this pass's arithmetic.
    const int na = b, nb = min(n, b + consumers);
    if (na < n) {
      wait_chunks(na);
      load(na, nb, qn);
    }
    solve(a, q);
    consumers_sync(consumers);
    if (na >= n) break;
    release_below(nb);
    a = na;
    b = nb;
    q = qn;
  }
  if (t == 0) {  // to the caller's mapped host words, seen once the launch has ended
    err[0] = err_code;
    err[1] = err_row;
    __threadfence_system();
  }
}

__global__ void __launch_bounds__(kHopThreads) block_hop_kernel(int64_t levels, int32_t* out) {
  __shared__ int32_t cell[2];
  if (threadIdx.x == 0) cell[1] = 0;
  __syncthreads();
  for (int64_t l = 0; l < levels; ++l) {
    // Level l's thread: lane 0 of warp l mod 32, never the last level's warp.
    if (threadIdx.x == static_cast<unsigned>((l & 31) * 32)) {
      const int32_t v = reinterpret_cast<volatile int32_t*>(cell)[(l + 1) & 1];
      reinterpret_cast<volatile int32_t*>(cell)[l & 1] = v + 1;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = cell[(levels + 1) & 1];
}

// Above 48 KB a block's dynamic shared memory must be allowed first, once
// per device and instantiation: allow the card's opt-in maximum less the
// kernel's static shared memory.
template <typename T, int K>
cudaError_t allow_block_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, tri_block_kernel<T, K>);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tri_block_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(attr.sharedSizeBytes));
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return e;
}

template <typename T, int K>
int launch_block_k(const void* pos_vals, const void* pos_cols, const void* pos_inv_diag,
                   const void* pos_info, const void* r, void* y, void* err, int n, int n_pad,
                   int S, int D, int W, size_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = allow_block_smem<T, K>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tri_block_kernel<T, K><<<1, kBlockThreads, bytes, stream>>>(
      static_cast<const T*>(pos_vals), static_cast<const int32_t*>(pos_cols),
      static_cast<const T*>(pos_inv_diag), static_cast<const int4*>(pos_info),
      static_cast<const T*>(r), static_cast<T*>(y), static_cast<unsigned*>(err), n, n_pad, S, D,
      W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_block(const void* pos_vals, const void* pos_cols, const void* pos_inv_diag,
                 const void* pos_info, const void* r, void* y, void* err, int n, int n_pad,
                 int K, int S, int D, int W, cudaStream_t stream) {
  const int consumers = kBlockThreads - 32;
  // The geometry the kernel's progress and its window rest on (the wrapper
  // picks it: tri_solve.block_geometry).
  if (K < 1 || K > kBlockMaxK || S < 4 || (S & (S - 1)) || (D & (D - 1)) || n_pad % 4 ||
      n_pad < n || D < (consumers + S - 1) / S + kLag + 2 || W < 2 * consumers || (W & (W - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = block_smem_bytes<T>(S, D, K, W);
  switch (K) {
    case 1:
      return launch_block_k<T, 1>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
    case 2:
      return launch_block_k<T, 2>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
    case 3:
      return launch_block_k<T, 3>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
    case 4:
      return launch_block_k<T, 4>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
    case 5:
      return launch_block_k<T, 5>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
    case 6:
      return launch_block_k<T, 6>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
    case 7:
      return launch_block_k<T, 7>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
    default:
      return launch_block_k<T, 8>(pos_vals, pos_cols, pos_inv_diag, pos_info, r, y,
                                    err, n, n_pad, S, D, W, bytes, stream);
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

// T1 "grid".  L's vals (n + 1, K) and inv_diag (n + 1,) of dtype, cols
// int32 (n + 1, K), row_len and strand_rows int32 (n,), strand_ptr int32
// (strands + 1,); r and y (n,) of dtype,
// scratch (4 + 2n·itemsize/4,) 32-bit words, all contiguous on the current
// device; L's slots (S a lane: 1, 2, 4 or 8) and strands (at least 1, a
// warp each, all resident at once: stormx_tri_grid_warps).  Zeroes scratch and launches the solve on the stream, without
// waiting, then copies the two error words to err_host (pinned) and
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

// The warps of T1 "grid" resident at once on the current device, at S
// slots a lane, for dtype (negative: a CUDA error; an S not built:
// -cudaErrorInvalidValue).
int stormx_tri_grid_warps(int dtype, int S) {
  return exact_dtype(dtype, S, nullptr, nullptr, nullptr, nullptr, 0, nullptr, false);
}

// T1 "block".  L's pos_vals (n_pad, K) and pos_inv_diag (n_pad,) of dtype,
// pos_cols (n_pad, K) and pos_info (n_pad, 4) int32, each 16-byte aligned;
// S positions a chunk, D stages, a window of W positions
// (tri_solve.block_geometry); r and y (n,) of dtype.  Launches one block on
// the stream without waiting, then records event.  The kernel writes its
// two error words to err_dev, the device address of mapped host words
// (stormx_tri_host_words): 0, or 3 (a dependency outside the earlier
// levels) and the first row that met one.
int stormx_tri_exact_block(const TriLaunch* L, const void* r, void* y, void* err_dev,
                           void* event, void* stream_) {
  if (L->n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  switch (L->dtype) {
    case kF32:
      rc = launch_block<float>(L->pos_vals, L->pos_cols, L->pos_inv_diag, L->pos_info, r, y,
                               err_dev, L->n, L->n_pad, L->K, L->S, L->D, L->W, stream);
      break;
    case kF64:
      rc = launch_block<double>(L->pos_vals, L->pos_cols, L->pos_inv_diag, L->pos_info, r, y,
                                err_dev, L->n, L->n_pad, L->K, L->S, L->D, L->W, stream);
      break;
    case kC64:
      rc = launch_block<cfloat>(L->pos_vals, L->pos_cols, L->pos_inv_diag, L->pos_info, r, y,
                                err_dev, L->n, L->n_pad, L->K, L->S, L->D, L->W, stream);
      break;
    case kC128:
      rc = launch_block<cdouble>(L->pos_vals, L->pos_cols, L->pos_inv_diag, L->pos_info, r, y,
                                 err_dev, L->n, L->n_pad, L->K, L->S, L->D, L->W, stream);
      break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event), stream));
}

// Two error words of T1 in mapped pinned host memory, made once a slot by
// the wrapper: *host for the host to read, *dev for a kernel to write.
int stormx_tri_host_words(void** host, void** dev) {
  void* h = nullptr;
  cudaError_t e = cudaHostAlloc(&h, 4 * sizeof(unsigned), cudaHostAllocMapped);
  if (e != cudaSuccess) return static_cast<int>(e);
  memset(h, 0, 4 * sizeof(unsigned));
  *host = h;
  return static_cast<int>(cudaHostGetDevicePointer(dev, h, 0));
}

// The shared memory a block of this device may opt in to (negative: a
// CUDA error).
int stormx_tri_smem_optin(int device) {
  int optin = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? optin : -static_cast<int>(e);
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

// The block-hop probe: `levels` levels of one 1,024-thread block; out (one
// int32) receives the chain's count.
int stormx_tri_block_hop(int64_t levels, void* out, void* stream) {
  block_hop_kernel<<<1, kHopThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
