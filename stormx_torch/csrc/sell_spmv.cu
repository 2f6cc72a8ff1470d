// K1: SlicedELL sparse matrix-vector product y = A·x for Hopper (sm_90a),
// in two branches that give the same y bit for bit.
//
// Replaces the TPU kernel stormx/ops/pallas_sell.py:_kernel (driven by
// _apply and sell_matvec_pallas).  Same function: row r of block b has K
// slots (value, window-local column) and
//     y[R·b + r] = Σ_k val[b,k,r] · x[R·b − pad_lo + col[b,k,r]]
// with x read as zero outside [0, n_cols).  Both branches take the slots of
// a row in the order k = 0..K−1, each as one fmaf into an accumulator that
// starts at 0, so their sums round alike, non-finite x included (a padding
// slot, value 0 at column 0, adds 0·x[R·b − pad_lo]).
//
// Bound on this card: memory.  One apply must read the padded values and
// columns (8·nb·K·R bytes), x (4·n_cols) and write y (4·n_rows) for 2·nnz
// flops — about 0.1 flop/byte, far under the H100's float32 ridge
// (67 TFLOP/s over 3.35 TB/s, data sheet).
//
// The host lays values and columns out as (nb, K, R), so for each k the
// rows of a block read neighbouring words, and the values (or columns) of
// T consecutive blocks are one contiguous run of T·K·R words.  x is read
// straight from global memory through the read-only path: after the
// bandwidth-reducing reorder the columns of a block of rows fall inside a
// window of a few thousand floats, so those reads hit L1/L2.  The TPU
// kernel's per-chunk masked loop (its way of emulating a gather) and the
// (nb, C) window matrix in device memory are not carried over.
//
// "rows" (the first kernel): one thread per row, 256-thread blocks, every
// load through the read-only path.  A thread's slot loop (runtime K) keeps
// about two loads in flight, and on the Cahn–Hilliard operator the grid is
// 1.18 waves of resident blocks, so the second wave runs mostly empty.
//
// "staged": a persistent grid (the SMs times the blocks an SM holds) whose
// blocks walk tiles of T consecutive row blocks at a stride of gridDim.x.
// One producer thread (the block's last warp) copies each tile's values and
// columns, two contiguous runs of T·K·R·4 bytes, into an S-stage ring in
// shared memory with the 1-D bulk copy (cp.async.bulk ... complete_tx), so
// a block keeps up to S tiles of loads in flight without spending a
// register on them.  Each stage has a "full" mbarrier, which the producer
// arms with the stage's transaction bytes, and an "empty" one, on which
// every consumer warp arrives once it has read the stage; the producer
// waits on it before it refills the stage.  A consumer thread takes
// kRowsPerThread consecutive rows of a block (8-byte reads from shared
// memory at 2): K is a template parameter for K ≤ 16, so the rows' K
// columns come from shared memory first, then all their reads of x are in
// flight together, then each row's K fmafs run in slot order; a runtime-K
// instantiation takes larger K eight slots at a time.  Index math inside a
// tile is 32-bit (the wrapper keeps nb·R and n_cols under 2^31).  The
// wrapper picks T, S and the consumer threads (sell_spmv.staged_geometry)
// and the branch, from the operator's shape (sell_spmv.k1_branch), and
// refuses a ring over the shared-memory opt-in or values and columns that
// are not 16-byte aligned.
//
// What bounds both branches on an H100 (scripts/torch_k1_variants.py): the
// 318,402-row Cahn–Hilliard operator's 28 MB take ~8.5 µs from L2 (warm) and
// ~16 µs from HBM after a flush that leaves L2 dirty (its writebacks double
// the traffic), over a ~5 µs floor of the CUDA-event timer; the staged
// branch gains on the flushed case, where its copies keep more bytes in
// flight, and ties warm.  With fewer slots a row "rows" stays ahead warm
// (0.3–1.1 µs at K = 2..8 over 2,488 row blocks), so the wrapper gives
// those operators to "rows".

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsThreads = 256;
constexpr int kMaxConsumers = 512;  // consumer threads of a staged block
constexpr int kRowsPerThread = 2;   // consecutive rows of a consumer thread (1, 2 or 4)
constexpr int kChunkK = 8;          // slots in flight together at a runtime K
constexpr int kMaxTemplateK = 16;
constexpr int kMaxDevices = 64;

__global__ void sell_spmv_kernel(const float* __restrict__ vals,
                                 const int32_t* __restrict__ cols,
                                 const float* __restrict__ x,
                                 float* __restrict__ y, int64_t n_rows,
                                 int64_t n_cols, int R, int K, int pad_lo) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int64_t b = row / R;
  const int64_t r = row - b * R;
  const int64_t slab = b * K * R + r;
  const int64_t base = b * R - pad_lo;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int64_t g = base + __ldg(cols + slab + static_cast<int64_t>(k) * R);
    const float xv = (g >= 0 && g < n_cols) ? __ldg(x + g) : 0.0f;
    acc = fmaf(__ldg(vals + slab + static_cast<int64_t>(k) * R), xv, acc);
  }
  y[row] = acc;
}

// -- mbarriers and the bulk copy (PTX) ----------------------------------------

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

// The producer's arrival, which also arms the barrier with `bytes`.
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
// aligned); completion is counted on `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory of a staged block: S stages of T·K·R values and as many
// columns, then the S full and S empty barriers.  Kept equal to
// sell_spmv.ring_bytes.
size_t staged_smem_bytes(int T, int S, int K, int R) {
  return 2 * static_cast<size_t>(S) * T * K * R * sizeof(float) + 2 * S * sizeof(uint64_t);
}

// N consecutive words at p (16-byte aligned for N = 4, 8-byte for N = 2).
template <int N, typename T>
__device__ __forceinline__ void load_words(const T* p, T (&out)[N]) {
  static_assert(sizeof(T) == 4, "4-byte words");
  if constexpr (N == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out[0] = *reinterpret_cast<const T*>(&w.x);
    out[1] = *reinterpret_cast<const T*>(&w.y);
    out[2] = *reinterpret_cast<const T*>(&w.z);
    out[3] = *reinterpret_cast<const T*>(&w.w);
  } else if constexpr (N == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    out[0] = *reinterpret_cast<const T*>(&w.x);
    out[1] = *reinterpret_cast<const T*>(&w.y);
  } else {
    out[0] = *p;
  }
}

// N consecutive rows of one block in a staged tile: slots k = 0..K−1 of
// the rows at word `o` of the stage (stride R between slots), each row's
// sum in slot order; x read at base + column.  All the rows' x reads of a
// chunk of slots are in flight together.
template <int KC, int N>
__device__ __forceinline__ void staged_rows(const float* __restrict__ v,
                                            const int32_t* __restrict__ c,
                                            const float* __restrict__ x, int o, int R, int K,
                                            int base, unsigned n_cols, float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  constexpr int kChunk = KC > 0 ? KC : kChunkK;
  const int k_end = KC > 0 ? KC : K;
  for (int k0 = 0; k0 < k_end; k0 += kChunk) {
    float xv[kChunk][N];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      int col[N];
      if (KC > 0 || k0 + j < K) {
        load_words<N>(c + o + (k0 + j) * R, col);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) col[i] = -base - 1;  // reads no x
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int g = base + col[i];
        xv[j][i] = static_cast<unsigned>(g) < n_cols ? __ldg(x + g) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (KC > 0 || k0 + j < K) {
        float val[N];
        load_words<N>(v + o + (k0 + j) * R, val);
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = fmaf(val[i], xv[j][i], acc[i]);
      }
    }
  }
}

// KC > 0: K == KC; KC == 0: any K.  blockDim.x = consumers + 32: the last
// warp is the producer.
template <int KC>
__global__ void __launch_bounds__(kMaxConsumers + 32)
    sell_spmv_staged_kernel(const float* __restrict__ vals, const int32_t* __restrict__ cols,
                            const float* __restrict__ x, float* __restrict__ y, int n_rows,
                            int n_cols, int nb, int R, int K_rt, int pad_lo, int T, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = KC > 0 ? KC : K_rt;
  const int tile_words = T * K * R;  // of one array in one stage
  float* ring = reinterpret_cast<float*>(smem);  // [S][values, columns][tile_words]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * S * tile_words);
  uint64_t* empty = full + S;
  const int consumers = static_cast<int>(blockDim.x) - 32;
  const int n_tiles = (nb + T - 1) / T;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {  // the producer warp: one thread copies
    if (threadIdx.x == consumers) {
      int j = 0;  // the block's tile count; tile j sits in stage j % S
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
        const int s = j % S;
        // Use u = j / S of stage s waits for the consumers' release of use u − 1.
        if (j >= S) mbar_wait(empty + s, (j / S - 1) & 1);
        const int b0 = tile * T;
        const unsigned bytes = static_cast<unsigned>(min(T, nb - b0) * K * R) * 4u;
        const size_t off = static_cast<size_t>(b0) * K * R;
        float* dst = ring + 2 * s * tile_words;
        mbar_arrive_expect_tx(full + s, 2u * bytes);
        bulk_load(dst, vals + off, bytes, full + s);
        bulk_load(dst + tile_words, cols + off, bytes, full + s);
      }
    }
    return;
  }

  int j = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const int s = j % S;
    mbar_wait(full + s, (j / S) & 1);
    const float* v = ring + 2 * s * tile_words;
    const int32_t* c = reinterpret_cast<const int32_t*>(v + tile_words);
    const int b0 = tile * T;
    const int rows = min(T, nb - b0) * R;
    for (int r = threadIdx.x * kRowsPerThread; r < rows; r += consumers * kRowsPerThread) {
      const int row = b0 * R + r;
      if (row >= n_rows) break;  // the padding rows of the last block
      const int t = r / R;
      const int lr = r - t * R;
      float acc[kRowsPerThread];
      staged_rows<KC, kRowsPerThread>(v, c, x, t * K * R + lr, R, K, row - lr - pad_lo,
                                      static_cast<unsigned>(n_cols), acc);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (row + i < n_rows) y[row + i] = acc[i];
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed first, once
// per device and instantiation: allow the card's opt-in maximum.
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
  e = cudaFuncSetAttribute(sell_spmv_staged_kernel<KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return e;
}

template <int KC>
int launch_staged(const float* vals, const int32_t* cols, const float* x, float* y, int n_rows,
                  int n_cols, int nb, int R, int K, int pad_lo, int T, int S, int consumers,
                  int grid, cudaStream_t stream) {
  const size_t bytes = staged_smem_bytes(T, S, K, R);
  if (bytes > 48 * 1024) {
    const cudaError_t e = allow_staged_smem<KC>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sell_spmv_staged_kernel<KC><<<static_cast<unsigned>(grid), consumers + 32, bytes, stream>>>(
      vals, cols, x, y, n_rows, n_cols, nb, R, K, pad_lo, T, S);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int staged_blocks_per_sm(int consumers, size_t bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = allow_staged_smem<KC>();
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sell_spmv_staged_kernel<KC>, consumers + 32, bytes);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

}  // namespace

// The staged instantiations: K = 1..16 unrolled, any other K at run time.
#define STORMX_K_CASES(CALL) \
  switch (K) {               \
    case 1: return CALL(1);  \
    case 2: return CALL(2);  \
    case 3: return CALL(3);  \
    case 4: return CALL(4);  \
    case 5: return CALL(5);  \
    case 6: return CALL(6);  \
    case 7: return CALL(7);  \
    case 8: return CALL(8);  \
    case 9: return CALL(9);  \
    case 10: return CALL(10); \
    case 11: return CALL(11); \
    case 12: return CALL(12); \
    case 13: return CALL(13); \
    case 14: return CALL(14); \
    case 15: return CALL(15); \
    case 16: return CALL(16); \
    default: return CALL(0); \
  }
static_assert(kMaxTemplateK == 16, "STORMX_K_CASES unrolls K = 1..16");

extern "C" {

const char* stormx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The shared memory a block may opt in to on `device` (227 KB on an H100),
// or −(CUDA error).
int stormx_sell_smem_optin(int device) {
  int optin = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? optin : -static_cast<int>(e);
}

// "rows".  vals float32 (nb, K, R), cols int32 (nb, K, R), x float32
// (n_cols,), y float32 (n_rows,), all contiguous on the current device.
int stormx_sell_spmv(const void* vals, const void* cols, const void* x, void* y,
                     int64_t n_rows, int64_t n_cols, int R, int K, int pad_lo,
                     void* stream) {
  if (n_rows == 0) return 0;
  const int64_t blocks = (n_rows + kRowsThreads - 1) / kRowsThreads;
  sell_spmv_kernel<<<static_cast<unsigned>(blocks), kRowsThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const float*>(x), static_cast<float*>(y), n_rows, n_cols, R,
      K, pad_lo);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the staged branch an SM holds at once with `consumers` consumer
// threads and the ring of (T, S, K, R), or −(CUDA error).
int stormx_sell_staged_blocks_per_sm(int T, int S, int K, int R, int consumers) {
  const size_t bytes = staged_smem_bytes(T, S, K, R);
#define STORMX_OCCUPANCY(KC) staged_blocks_per_sm<KC>(consumers, bytes)
  STORMX_K_CASES(STORMX_OCCUPANCY)
#undef STORMX_OCCUPANCY
}

// "staged".  The arrays as "rows" takes them, with vals and cols 16-byte
// aligned, R a multiple of 4, nb·R and n_cols under 2^31; tiles of T row
// blocks in an S-stage ring, `consumers` (a multiple of 32, at most 512)
// consumer threads and one producer warp a block, `grid` blocks.  A ring
// over the opt-in limit fails at the launch and returns its error.
int stormx_sell_spmv_staged(const void* vals, const void* cols, const void* x, void* y,
                            int64_t n_rows, int64_t n_cols, int64_t nb, int R, int K,
                            int pad_lo, int T, int S, int consumers, int grid, void* stream_) {
  if (n_rows == 0 || nb == 0) return 0;
  if (T < 1 || S < 1 || grid < 1 || consumers < 32 || consumers > kMaxConsumers ||
      consumers % 32 != 0 || R % 4 != 0 ||
      nb * R >= (int64_t{1} << 31) || n_cols >= (int64_t{1} << 31) ||
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(cols)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* v = static_cast<const float*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int rows = static_cast<int>(n_rows), ncols = static_cast<int>(n_cols);
  const int blocks = static_cast<int>(nb);
#define STORMX_LAUNCH(KC)                                                                   \
  launch_staged<KC>(v, c, xp, yp, rows, ncols, blocks, R, K, pad_lo, T, S, consumers, grid, \
                    stream)
  STORMX_K_CASES(STORMX_LAUNCH)
#undef STORMX_LAUNCH
}

}  // extern "C"
