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
// a live slot.  K4b adds a source map, src[b, s·K + k, l]: the tile row of
// the k-th entry of row b·R + s·128 + l.  A dead entry (its row has fewer
// than K entries) names tile row M − 1, which the packer leaves all zero:
// its word is chunk 0, lane 0, so it adds 0·x[b·R − pad_lo], which is NaN
// when that x is Inf or NaN, as in the TPU kernel.  K4b's staged branch
// also takes live4[b, m], whose bit t is set when lanes 4t..4t+3 of tile
// row m hold a non-zero value, and each word's lane and chunk apart:
// xlane[b, m, l] = word & 127 (a byte) and xchunk[b, m] = word >> 7 & 31
// (the packer keeps the chunk the same in every lane of a tile row).
//
// Bound on this card: memory.  What y = A·x needs is the live values and
// their index words, x and y (8.3 µs on the 318k-cell Cahn–Hilliard
// operator, 3.8 µs on its Laplacian, at 3.35 TB/s).  The tiles hold two
// padding slots per live one on mesh operators, so what a kernel reads is
// more.  Both kernels read, per 32-byte sector, only what can hold a live
// slot:
//   * no tile row at or past rows_used[b] (30% of the Laplacian's slots, 11%
//     of the CH operator's, are such whole dead rows at the end of a block);
//   * K4a: the values of the rows below it, 16 bytes a thread, and the index
//     words and x values only of a group of four lanes that holds a
//     non-zero value (52% and 39% of those 32-byte sectors hold zeros only);
//   * K4b: values only of such a group (live4 says which, before any value
//     is read), the lanes' bytes in place of their 4-byte words, and src's
//     sub·K tile rows.
// On the CH operator that is ≈ 34 MB of values, 23 MB of index words and
// 2.5 MB of x and y for K4a; ≈ 23 MB of values, 6 MB of lanes, 12.7 MB of
// src and 2.5 MB for K4b; against 79 MB for every slot.  Reading the words
// (23 MB) instead of the lanes took 8 µs more on the CH operator
// (scripts/torch_k4b_variants.py).
//
// Skipping a zero-valued slot changes y only where x holds Inf or NaN at
// that slot's address: the TPU kernel multiplies every slot, and 0·Inf is
// NaN there.  K4a's sums take no such slot.  K4b's take exactly the slots
// its source map names, as the TPU kernel's do, dead entries included.
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
//   K4b, "staged": one block per row block, in two phases.  (1) The warps
//        walk the tile rows below rows_used[b] as K4a's do and store the
//        product of every live four-lane group into shared memory,
//        prod[m][128] (M·512 bytes; each row's live4 word and x offset
//        first, M·8 bytes); tile row M − 1 is staged whole.  A thread's
//        loads are a 16-byte float4 of values and a 4-byte word of four
//        lanes, coalesced, of a live group only.  (2) After a barrier,
//        each thread takes one row: it loads its K src words (coalesced,
//        independent: K is a template parameter for the mesh operators'
//        widths, so all K are in flight) and sums prod[src_k][l] for k = 0..
//        K−1 in order.  A warp's lanes read banks l mod 32, so these reads
//        are free of bank conflicts whatever src holds, and the sum is the
//        ELL order, the same in every run.  The old design, one thread per
//        row reading the slot that src names in global memory, made three
//        dependent loads per entry whose value and word requests each
//        touched ~22 sectors on the CH operator (src names another tile row
//        in every lane).
//   K4b, "rows": that old per-row kernel, kept for an M whose products do
//        not fit in a block's shared memory (M·520 bytes over the card's
//        opt-in limit, 227 KB on an H100: M > 447, possible at R = 2048 with
//        K ≥ 28).  The wrapper picks the branch (sell_packed.gather_branch).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kUnroll = 4;  // tile rows of one K4a warp in flight together
constexpr int kGatherThreads = 256;  // K4b "rows": threads of a block, one row each

// K4b "staged": kStagedThreads threads a block, or kStagedThreadsSmallM
// where six blocks fit an SM's shared memory (R of them for a smaller R);
// kStagedMinBlocks blocks an SM must hold, which caps the registers at 40 a
// thread: shared memory allows three blocks of the CH operator's M = 120
// (62 KB each) on an SM.  Phase 1 keeps kStageUnroll tile rows of a warp in
// flight; phase 2 unrolls the K-sum for the widths of the mesh operators
// (4: the 2-D Laplacian, 10: the Cahn–Hilliard operator) and takes others
// kChunkK entries at a time.
constexpr int kStagedThreads = 512;
constexpr int kStagedThreadsSmallM = 256;
constexpr int kStagedMinBlocks = 3;
constexpr int kStageUnroll = 2;
constexpr int kChunkK = 8;
constexpr int kMaxDevices = 64;

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

// K4b's staging: x at window offset k (chunk·128 + lane − off_lo), read only
// for a non-zero value, 0 outside [0, n_cols).
__device__ __forceinline__ float lane_x(const float* __restrict__ xw, int k, unsigned span,
                                        float val) {
  return (val != 0.0f && static_cast<unsigned>(k) < span) ? __ldg(xw + k) : 0.0f;
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
    packed_gather_rows_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
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

// Shared memory of a staged block: the products, then each tile row's live4
// word and x offset.
constexpr size_t staged_bytes(int M) {
  return static_cast<size_t>(M) * (kLanes + 2) * sizeof(float);
}

// Threads of a staged block: 256 where six such blocks fit an SM's shared
// memory (small M, where 512 threads would leave most warps one tile row
// in phase 1), else 512; R for R < 256.  Each SM keeps 1 KB a block.
int staged_threads(int M, int R, int smem_per_sm) {
  const int threads = 6 * (staged_bytes(M) + 1024) <= static_cast<size_t>(smem_per_sm)
                          ? kStagedThreadsSmallM
                          : kStagedThreads;
  return R < threads ? R : threads;
}

// KC > 0: K == KC, the K-sum unrolled; KC == 0: any K.
template <int KC>
__global__ void __launch_bounds__(kStagedThreads, kStagedMinBlocks)
    packed_gather_staged_kernel(const uint8_t* __restrict__ xlane,
                                const int32_t* __restrict__ xchunk,
                                const float* __restrict__ vals,
                                const int32_t* __restrict__ src,
                                const int32_t* __restrict__ live4,
                                const int32_t* __restrict__ rows_used,
                                const float* __restrict__ x, float* __restrict__ y,
                                int64_t n_rows, int64_t n_cols, int M, int R, int K,
                                int pad_lo) {
  extern __shared__ float4 smem[];
  float* prod = reinterpret_cast<float*>(smem);  // [M][128]
  unsigned* bits = reinterpret_cast<unsigned*>(prod + M * kLanes);  // [M]
  int* row_off = reinterpret_cast<int*>(bits + M);  // [M]: xchunk·128 − off_lo
  const int64_t b = blockIdx.x;
  const int64_t base = b * R - pad_lo;
  // The window of x as K4a reads it: off = chunk·128 + lane names x[base +
  // off], which exists for off_lo ≤ off < off_lo + span; xw = x + base + off_lo.
  const int64_t lo = base < 0 ? -base : 0;
  const int64_t hi = n_cols - base;
  const int off_lo = static_cast<int>(lo < 4096 ? lo : 4096);
  const int off_hi = static_cast<int>(hi < 0 ? 0 : hi < 4096 ? hi : 4096);
  const unsigned span = off_hi > off_lo ? off_hi - off_lo : 0;
  const float* xw = x + (base + off_lo);
  const int64_t tile = b * M * kLanes;
  // Tile rows below rows_used, and not M − 1, which is staged whole.
  const int staged = min(__ldg(rows_used + b), M - 1);
  for (int m = threadIdx.x; m < staged; m += blockDim.x) {
    bits[m] = static_cast<unsigned>(__ldg(live4 + b * M + m));
    row_off[m] = __ldg(xchunk + b * M + m) * kLanes - off_lo;
  }
  if (threadIdx.x < kLanes) {
    const int64_t slot = tile + static_cast<int64_t>(M - 1) * kLanes + threadIdx.x;
    const unsigned k = static_cast<unsigned>(
        __ldg(xchunk + b * M + M - 1) * kLanes + __ldg(xlane + slot) - off_lo);
    prod[(M - 1) * kLanes + threadIdx.x] = __ldg(vals + slot) * (k < span ? __ldg(xw + k) : 0.0f);
  }
  __syncthreads();

  // Phase 1: the products of every live four-lane group.
  const int warps = blockDim.x / 32;
  const int t = threadIdx.x % 32;
  const int l0 = 4 * t;
  const float4* v4 = reinterpret_cast<const float4*>(vals + tile + l0);
  const uint32_t* lane4 = reinterpret_cast<const uint32_t*>(xlane + tile + l0);
  for (int m0 = threadIdx.x / 32; m0 < staged; m0 += warps * kStageUnroll) {
    bool live[kStageUnroll];
    float4 v[kStageUnroll];
    uint32_t lanes[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int m = m0 + u * warps;
      live[u] = m < staged && ((bits[m] >> t) & 1u);
      if (live[u]) {
        v[u] = __ldg(v4 + m * (kLanes / 4));
        lanes[u] = __ldg(lane4 + m * (kLanes / 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      if (live[u]) {
        const int m = m0 + u * warps;
        const int off = row_off[m];
        *reinterpret_cast<float4*>(prod + m * kLanes + l0) = make_float4(
            v[u].x * lane_x(xw, off + static_cast<int>(lanes[u] & 255), span, v[u].x),
            v[u].y * lane_x(xw, off + static_cast<int>((lanes[u] >> 8) & 255), span, v[u].y),
            v[u].z * lane_x(xw, off + static_cast<int>((lanes[u] >> 16) & 255), span, v[u].z),
            v[u].w * lane_x(xw, off + static_cast<int>(lanes[u] >> 24), span, v[u].w));
      }
    }
  }
  __syncthreads();

  // Phase 2: each row's K entries, in ELL order.
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int64_t row = b * R + r;
    if (row >= n_rows) return;
    const int s = r / kLanes;
    const int l = r - s * kLanes;
    const int32_t* sp = src + tile + static_cast<int64_t>(s) * K * kLanes + l;
    float acc = 0.0f;
    if constexpr (KC > 0) {
      int m[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) m[k] = __ldg(sp + k * kLanes);
#pragma unroll
      for (int k = 0; k < KC; ++k) acc += prod[m[k] * kLanes + l];
    } else {
      for (int k0 = 0; k0 < K; k0 += kChunkK) {
        int m[kChunkK];
#pragma unroll
        for (int j = 0; j < kChunkK; ++j) m[j] = k0 + j < K ? __ldg(sp + (k0 + j) * kLanes) : -1;
#pragma unroll
        for (int j = 0; j < kChunkK; ++j) {
          if (m[j] >= 0) acc += prod[m[j] * kLanes + l];
        }
      }
    }
    y[row] = acc;
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed first, once
// per device: allow the card's opt-in maximum.
template <int KC>
cudaError_t allow_staged_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(packed_gather_staged_kernel<KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return e;
}

// The current device's shared memory per SM, or −(CUDA error).
int smem_per_sm() {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

template <int KC>
int launch_staged(const uint8_t* xlane, const int32_t* xchunk, const float* vals,
                  const int32_t* src, const int32_t* live4, const int32_t* rows_used,
                  const float* x, float* y, int64_t n_rows, int64_t n_cols, int64_t nb, int M,
                  int R, int K, int pad_lo, cudaStream_t stream) {
  const size_t bytes = staged_bytes(M);
  if (bytes > 48 * 1024) {
    const cudaError_t e = allow_staged_smem<KC>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per_sm = smem_per_sm();
  if (per_sm < 0) return -per_sm;
  packed_gather_staged_kernel<KC>
      <<<static_cast<unsigned>(nb), staged_threads(M, R, per_sm), bytes, stream>>>(
          xlane, xchunk, vals, src, live4, rows_used, x, y, n_rows, n_cols, M, R, K, pad_lo);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int staged_blocks_per_sm(int M, int R) {
  const size_t bytes = staged_bytes(M);
  if (bytes > 48 * 1024) {
    const cudaError_t e = allow_staged_smem<KC>();
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  const int per_sm = smem_per_sm();
  if (per_sm < 0) return per_sm;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, packed_gather_staged_kernel<KC>, staged_threads(M, R, per_sm), bytes);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
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

// The K4b branches, by the width of the K-sum.
#define STORMX_K_CASES(CALL) \
  switch (K) {              \
    case 4: return CALL(4); \
    case 10: return CALL(10); \
    default: return CALL(0); \
  }

// The shared memory a block may opt in to on `device` (227 KB on an H100),
// or −(CUDA error).
int stormx_smem_optin(int device) {
  int optin = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? optin : -static_cast<int>(e);
}

// Blocks of K4b's staged branch that an SM holds at once at (M, R, K), or
// −(CUDA error): measurement only, for the wave count.
int stormx_packed_gather_blocks_per_sm(int M, int R, int K) {
#define STORMX_OCCUPANCY(KC) staged_blocks_per_sm<KC>(M, R)
  STORMX_K_CASES(STORMX_OCCUPANCY)
#undef STORMX_OCCUPANCY
}

// K4b.  idx, vals, src int32 (nb, M, 128) with M ≥ sub·K, x and y as K4a.
// staged == 0: the per-row kernel, which reads idx, vals and src.  staged
// != 0: the staged branch, which reads instead of idx xlane uint8 (nb, M,
// 128) and xchunk int32 (nb, M), the lane and chunk of each slot's word,
// and also live4 int32 (nb, M) and rows_used int32 (nb,); it needs M·520
// bytes of shared memory within the opt-in limit, 16-byte aligned vals and
// 4-byte aligned xlane (a launch over the limit fails and returns its
// error).
int stormx_packed_spmv_gather(const void* idx_, const void* vals_, const void* src_,
                              const void* live4_, const void* rows_used_, const void* xlane_,
                              const void* xchunk_, const void* x_, void* y_, int64_t n_rows,
                              int64_t n_cols, int64_t nb, int M, int R, int K, int pad_lo,
                              int staged, void* stream_) {
  if (nb == 0 || n_rows == 0) return 0;
  if (R % kLanes != 0 || K < 1 || M < (R / kLanes) * K)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* vals = static_cast<const float*>(vals_);
  const int32_t* src = static_cast<const int32_t*>(src_);
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!staged) {
    const int64_t blocks = (n_rows + kGatherThreads - 1) / kGatherThreads;
    packed_gather_rows_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0, stream>>>(
        static_cast<const int32_t*>(idx_), vals, src, x, y, n_rows, n_cols, M, R, K, pad_lo);
    return static_cast<int>(cudaGetLastError());
  }
  if (R / kLanes > 16 || (reinterpret_cast<uintptr_t>(vals_) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(xlane_) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* xlane = static_cast<const uint8_t*>(xlane_);
  const int32_t* xchunk = static_cast<const int32_t*>(xchunk_);
  const int32_t* live4 = static_cast<const int32_t*>(live4_);
  const int32_t* rows_used = static_cast<const int32_t*>(rows_used_);
#define STORMX_LAUNCH(KC)                                                                    \
  launch_staged<KC>(xlane, xchunk, vals, src, live4, rows_used, x, y, n_rows, n_cols, nb, M, \
                    R, K, pad_lo, stream)
  STORMX_K_CASES(STORMX_LAUNCH)
#undef STORMX_LAUNCH
}

}  // extern "C"
