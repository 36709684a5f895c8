// Row gathers for Hopper (sm_90a): out[r, :] = table[idx[r], :] for an f32
// table [R, F] and int32 indices [M].
//
// Replaces the two Pallas TPU kernels of
// sdfstudio_tpu/scripts/benchmarking/probe_gather2.py:
//   * probe_pallas_take (kernel :123, pallas_call :128): jnp.take of a table
//     resident in VMEM, 2048 rows per grid step. jnp.take's fill mode gives
//     a row of NaN for an index of R;
//   * probe_pallas_loop (kernel :155, pallas_call :164): a scalar fori_loop
//     of single-row reads, the block's 1024 indices in SMEM and the table in
//     VMEM. The ref read clamps, so an index of R gives row R-1.
// Both read index -1 as row R-1. The kernels' contract is indices in [0, R].
//
// What bounds them on an H100: bytes, and in practice the latency of random
// reads of 4F bytes. Each output row streams 4 bytes of index in and 4F
// bytes of row out through HBM; the table is read once at least. Random
// 8-16 byte reads use a fraction of each 32-byte sector, so neither kernel
// comes near the bytes bound; what the design can do is keep many reads in
// flight and take the table reads off HBM:
//   * take: one thread per output row, rows read as float2 / float4 where F
//     and the pointers allow. Where the table fits a block's shared memory
//     (R * F * 4 bytes within the opt-in limit, 227 KB on an H100), each
//     block stages it there once and walks row tiles in a grid-stride loop,
//     with only as many blocks as fit on the SMs at once: staging once per
//     2048-row tile, as the TPU's grid does, would pull the table through L2
//     once per tile (268 MB at R = 2^14 and M = 2^22). Larger tables are
//     read through the read-only path (__ldg) and live in the 50 MB L2.
//   * loop: each block stages the table in shared memory once, then takes
//     8 tiles of 1024 rows at a time, one to each group of 128 threads. A
//     group copies its tile's indices into shared memory (the TPU kernel's
//     SMEM block), and each of its threads walks 8 of the tile's rows in a
//     serial loop, rows t, t + 128, ..., so a warp's writes stay contiguous.
//     The staged table leaves room for one block on each SM, so a block
//     needs many threads: with one tile per 128-thread block the kernel
//     took 32.7 us at M = 2^20 on an H100, slower than the plain version.
//     A table that does not fit shared memory is refused: the TPU kernel
//     requires it on chip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTakeThreads = 1024;
constexpr int kLoopTile = 1024;    // rows per tile, the TPU kernel's block
constexpr int kLoopWalkers = 128;  // threads that walk one tile
constexpr int kLoopGroups = 8;     // tiles a block takes at a time
constexpr int kLoopThreads = kLoopWalkers * kLoopGroups;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void set_nan(float& v) { v = __int_as_float(0x7fc00000); }
__device__ __forceinline__ void set_nan(float2& v) { set_nan(v.x); set_nan(v.y); }
__device__ __forceinline__ void set_nan(float4& v) {
  set_nan(v.x); set_nan(v.y); set_nan(v.z); set_nan(v.w);
}

// Copy n vectors of the table into shared memory, all threads of the block.
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src, long long n) {
  for (long long j = threadIdx.x; j < n; j += blockDim.x) dst[j] = __ldg(src + j);
}

// V floats per vector, W vectors per row (F = V * W). kStaged: the table is
// copied into shared memory first.
template <int V, bool kStaged>
__global__ void __launch_bounds__(kTakeThreads)
take_kernel(const float* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
            int R, int W, long long M) {
  using T = typename Vec<V>::T;
  extern __shared__ float4 smem4[];
  T* s_tab = reinterpret_cast<T*>(smem4);
  const T* g_tab = reinterpret_cast<const T*>(table);
  T* dst = reinterpret_cast<T*>(out);
  if (kStaged) {
    stage(s_tab, g_tab, (long long)R * W);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < M; r += stride) {
    int i = __ldg(idx + r);
    if (i < 0) i += R;
    const bool ok = (unsigned)i < (unsigned)R;
    for (int w = 0; w < W; ++w) {
      T v;
      if (!ok) {
        set_nan(v);
      } else if (kStaged) {
        v = s_tab[(size_t)i * W + w];
      } else {
        v = __ldg(g_tab + (size_t)i * W + w);
      }
      dst[(size_t)r * W + w] = v;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kLoopThreads)
loop_kernel(const float* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
            int R, int W, long long M) {
  using T = typename Vec<V>::T;
  extern __shared__ float4 smem4[];
  T* s_tab = reinterpret_cast<T*>(smem4);
  int* s_idx = reinterpret_cast<int*>(s_tab + (size_t)R * W);
  T* dst = reinterpret_cast<T*>(out);
  stage(s_tab, reinterpret_cast<const T*>(table), (long long)R * W);
  const int group = threadIdx.x / kLoopWalkers, lane = threadIdx.x % kLoopWalkers;
  int* my_idx = s_idx + group * kLoopTile;
  const long long n_tiles = (M + kLoopTile - 1) / kLoopTile;
  for (long long first = (long long)blockIdx.x * kLoopGroups; first < n_tiles;
       first += (long long)gridDim.x * kLoopGroups) {
    const long long tile = first + group;
    const long long base = tile * kLoopTile;
    const int rows = tile >= n_tiles ? 0 : (int)(M - base < kLoopTile ? M - base : kLoopTile);
    __syncthreads();  // the table is staged and the last tiles' indices are read
    for (int j = lane; j < rows; j += kLoopWalkers) my_idx[j] = __ldg(idx + base + j);
    __syncthreads();
    for (int j = lane; j < rows; j += kLoopWalkers) {
      int i = my_idx[j];
      if (i < 0) i += R;
      i = min(max(i, 0), R - 1);
      for (int w = 0; w < W; ++w) dst[(size_t)(base + j) * W + w] = s_tab[(size_t)i * W + w];
    }
  }
}

// The widest vector (4, 2 or 1 floats) that divides F and that both
// pointers are aligned for.
int vec_width(const void* table, const void* out, int F) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (F % 4 == 0 && a % 16 == 0) return 4;
  if (F % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

int smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return v;
}

size_t take_smem(int R, int F) { return (size_t)R * F * sizeof(float); }
size_t loop_smem(int R, int F) {
  return (size_t)R * F * sizeof(float) + kLoopGroups * kLoopTile * sizeof(int);
}

// Launch `kern` with as many blocks as fit on the card at once, and no more
// than `need`.
template <typename Kern>
int launch_resident(Kern kern, int threads, size_t smem, long long need, cudaStream_t stream,
                    const float* table, const int* idx, float* out, int R, int W, long long M) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const long long blocks = need < resident ? need : resident;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(table, idx, out, R, W, M);
  return (int)cudaGetLastError();
}

template <int V>
int take_v(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s,
           bool staged) {
  const long long need = (M + kTakeThreads - 1) / kTakeThreads;
  if (staged)
    return launch_resident(take_kernel<V, true>, kTakeThreads, take_smem(R, F), need, s, t, i, o,
                           R, F / V, M);
  return launch_resident(take_kernel<V, false>, kTakeThreads, 0, need, s, t, i, o, R, F / V, M);
}

template <int V>
int loop_v(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s) {
  const long long per_block = (long long)kLoopGroups * kLoopTile;
  const long long need = (M + per_block - 1) / per_block;
  return launch_resident(loop_kernel<V>, kLoopThreads, loop_smem(R, F), need, s, t, i, o, R,
                         F / V, M);
}

}  // namespace

extern "C" {

// Shared memory a block may opt into on the current device, in bytes (-1 on error).
int sst_row_gather_smem_limit() { return smem_limit(); }

// 1 if `take` stages a table of R x F floats in shared memory, else 0.
int sst_row_gather_take_staged(int R, int F) {
  const int limit = smem_limit();
  return limit > 0 && take_smem(R, F) <= (size_t)limit ? 1 : 0;
}

// Bytes of shared memory `loop` needs for a table of R x F floats; the
// wrapper refuses a table for which this exceeds sst_row_gather_smem_limit().
long long sst_row_gather_loop_smem_bytes(int R, int F) { return (long long)loop_smem(R, F); }

// table [R, F] f32, idx [M] int32 in [0, R], out [M, F] f32: contiguous
// device pointers. Enqueue on `stream`; return cudaGetLastError().
int sst_row_gather_take(const void* table, const void* idx, void* out, int R, int F, long long M,
                        void* stream) {
  if (R < 1 || F < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const bool staged = sst_row_gather_take_staged(R, F) != 0;
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_width(table, out, F)) {
    case 4: return take_v<4>(t, i, o, R, F, M, s, staged);
    case 2: return take_v<2>(t, i, o, R, F, M, s, staged);
    default: return take_v<1>(t, i, o, R, F, M, s, staged);
  }
}

// As sst_row_gather_take, with the clamping loop kernel; the table must fit
// shared memory.
int sst_row_gather_loop(const void* table, const void* idx, void* out, int R, int F, long long M,
                        void* stream) {
  if (R < 1 || F < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const int limit = smem_limit();
  if (limit < 0 || loop_smem(R, F) > (size_t)limit) return (int)cudaErrorInvalidValue;
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_width(table, out, F)) {
    case 4: return loop_v<4>(t, i, o, R, F, M, s);
    case 2: return loop_v<2>(t, i, o, R, F, M, s);
    default: return loop_v<1>(t, i, o, R, F, M, s);
  }
}

}  // extern "C"
