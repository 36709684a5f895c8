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
// What bounds them on an H100: bytes. Each output row streams 4 bytes of
// index in and 4F bytes of row out through HBM; the table is read at least
// once. The rows are random reads of 4F bytes, so what keeps a kernel from
// the bytes bound is the latency of those reads (by Little's law, 3.35 TB/s
// at several hundred ns needs ~15-20 KB in flight on each SM), and for a
// table beyond L1 the rate at which L2 serves random 32-byte sectors. The
// design:
//   * take: a warp takes chunks of 32 * kTakeSlots slots of 16 bytes of
//     output (4 rows of F = 1, 2 of F = 2, 1 of F = 4); lane t owns slots t,
//     t + 32, ..., so every load of indices and every store of rows is one
//     contiguous 512-byte access of the warp. A thread issues all of its
//     slots' table reads before it stores any row, and loads the next
//     chunk's indices before it stores this one's, so it pays the index
//     and the row latency once per chunk and not once per row. Indices and
//     output are read or written once and go evict-first in L1 and L2
//     (ld/st.global.cs); the table goes through the read-only path. A table
//     of the probe's 128 KB then lives in L1 (the kernel leaves the SM's
//     shared memory to L1); staging it in shared memory by bulk copy first
//     measured no faster (PERF.md).
//   * loop: each block holds the whole table in shared memory, as the TPU
//     kernel holds it in VMEM, and takes 8 tiles of 1024 rows at a time, one
//     to each group of 128 threads; a table that does not fit is refused.
//     One thread stages the table and the block's tile indices with bulk
//     asynchronous copies (cp.async.bulk, the TMA unit) completed on one
//     mbarrier, so the prologue costs one latency and not a chain of them.
//     Each walker then walks its slots of the tile, from the shared indices
//     into the shared table, and writes them as take does.
// Alignment picks a path before the launch, never by catching a failure:
// the vector width of a row follows F and the table's alignment
// (vec_width), index loads are vectors only where the index array is
// 16-byte aligned, and the bulk copies are taken only from 16-byte aligned
// sources (anything else is staged by the block's threads). The output
// comes from the wrapper's torch.empty and must be 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tf32_mma.cuh"

namespace {

constexpr int kTakeSlots = 4;             // 16-byte slots of rows a thread owns at a time
constexpr int kTakeThreads = 256;
constexpr int kLoopTile = 1024;           // rows per tile, the TPU kernel's block
constexpr int kLoopWalkers = 128;         // threads that walk one tile
constexpr int kLoopGroups = 8;            // tiles a block takes at a time
constexpr int kLoopThreads = kLoopWalkers * kLoopGroups;
constexpr int kLoopIdxBytes = kLoopGroups * kLoopTile * 4;
constexpr unsigned kBulkChunk = 32768;    // bytes per bulk copy
constexpr int kMaxDevices = 64;
constexpr int kErrNoFit = -1;             // loop: the table does not fit shared memory

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void set_nan(float& v) { v = __int_as_float(0x7fc00000); }
__device__ __forceinline__ void set_nan(float2& v) { set_nan(v.x); set_nan(v.y); }
__device__ __forceinline__ void set_nan(float4& v) {
  set_nan(v.x); set_nan(v.y); set_nan(v.z); set_nan(v.w);
}

// ---- memory operations and their cache policies ------------------------

// The index and output streams: each byte is read or written once, so both
// go evict-first in L1 and L2.
struct Streams {
  static __device__ __forceinline__ int4 ld4(const int4* p) { return __ldcs(p); }
  static __device__ __forceinline__ int2 ld2(const int2* p) { return __ldcs(p); }
  static __device__ __forceinline__ int ld1(const int* p) { return __ldcs(p); }
  template <typename T>
  static __device__ __forceinline__ void st(T* p, const T& v) { __stcs(p, v); }
};

// Table reads from device memory: the read-only path under the default
// policy. An L2 evict_last policy on them measured no faster at the probe's
// tables and 10% slower at p8's, which nearly fills L2 (PERF.md).
struct ReadOnlyTable {
  template <typename T>
  static __device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
};

// Index loads from shared memory (loop's staged tiles)
struct SharedIdx {
  static __device__ __forceinline__ int4 ld4(const int4* p) { return *p; }
  static __device__ __forceinline__ int2 ld2(const int2* p) { return *p; }
  static __device__ __forceinline__ int ld1(const int* p) { return *p; }
};

template <typename T, class Tab> struct GlobalRows {
  const T* p;
  __device__ __forceinline__ T operator()(size_t k) const { return Tab::ld(p + k); }
};
template <typename T> struct SharedRows {
  const T* p;
  __device__ __forceinline__ T operator()(size_t k) const { return p[k]; }
};

// P consecutive indices from `src`, one vector load where `vec` (src
// aligned to 4P bytes), else one load each
template <int P, class Io>
__device__ __forceinline__ void load_group(const int* __restrict__ src, bool vec, int (&i)[P]) {
  if constexpr (P == 4) {
    if (vec) {
      const int4 q = Io::ld4(reinterpret_cast<const int4*>(src));
      i[0] = q.x; i[1] = q.y; i[2] = q.z; i[3] = q.w;
      return;
    }
  } else if constexpr (P == 2) {
    if (vec) {
      const int2 q = Io::ld2(reinterpret_cast<const int2*>(src));
      i[0] = q.x; i[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) i[p] = Io::ld1(src + p);
}

// P rows of one vector each as one float4 (P * V = 4)
__device__ __forceinline__ float4 pack(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 pack(const float2 (&v)[2]) {
  return make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
}
__device__ __forceinline__ float4 pack(const float4 (&v)[1]) { return v[0]; }

// Index i of a table of R rows: -1 reads row R-1. kNan (take): the row to
// read (0 where there is none) and whether there is one; else (loop) the
// index clamped into the table.
template <bool kNan>
__device__ __forceinline__ int resolve(int i, int R, bool& ok) {
  if (i < 0) i += R;
  if (kNan) {
    ok = (unsigned)i < (unsigned)R;
    return ok ? i : 0;
  }
  ok = true;
  return min(max(i, 0), R - 1);
}

// A thread's K slots of P consecutive rows each, from their indices `i`:
// slot k is the P rows of group g0 + k * g_step (rows P * g ... P * g + P -
// 1). Where an index has no row (kNan) the row is NaN. Every read of the
// slots is issued before any of them is stored. With one vector a row and P
// * V = 4, a slot goes out as one 16-byte store, so a warp whose lanes take
// consecutive groups writes whole sectors with each instruction.
template <int K, int P, bool kNan, class Io, typename T, typename Rows>
__device__ __forceinline__ void gather_slots(const Rows& rows, const int (&i)[K][P], int R, int W,
                                             T* __restrict__ dst, long long g0, int g_step) {
  constexpr bool kPacked = P * sizeof(T) == 16;
  int s[K][P];
  bool ok[K][P];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int p = 0; p < P; ++p) s[k][p] = resolve<kNan>(i[k][p], R, ok[k][p]);
  for (int w = 0; w < W; ++w) {
    T v[K][P];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p) v[k][p] = rows((size_t)s[k][p] * W + w);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (!ok[k][p]) set_nan(v[k][p]);
      T* o = dst + (size_t)(g0 + (long long)k * g_step) * P * W;
      if constexpr (kPacked) {
        if (W == 1) {
          Io::st(reinterpret_cast<float4*>(o), pack(v[k]));
          continue;
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) Io::st(o + (size_t)p * W + w, v[k][p]);
    }
  }
}

// ---- mbarrier and bulk copy (the rest in tf32_mma.cuh) ------------------

// before the barrier's bytes are used for anything else
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(sst::smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by the TMA unit, in chunks completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  for (uint32_t off = 0; off < bytes; off += kBulkChunk)
    sst::bulk_g2s(static_cast<char*>(dst) + off, static_cast<const char*>(src) + off,
                  bytes - off < kBulkChunk ? bytes - off : kBulkChunk, bar);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- take ---------------------------------------------------------------

// V floats per vector, W vectors per row (F = V * W); P rows a slot (4 / V
// where W = 1, else 1) and K slots a thread, so a warp takes chunks of 32 K
// slots, lane t slots t, t + 32, ..., in a grid-stride loop over chunks,
// with the next chunk's indices loaded before this chunk's rows are stored.
// Rows past the last whole chunk go one per thread.
template <int V, int P, int K, int kThreads, class Io, typename Rows>
__device__ __forceinline__ void take_walk(const Rows& rows, const int* __restrict__ idx,
                                          float* __restrict__ out, int R, int W, long long M) {
  using T = typename Vec<V>::T;
  constexpr int kChunk = 32 * K;  // slots a warp takes at a time
  T* dst = reinterpret_cast<T*>(out);
  const bool idx_vec = aligned16(idx);
  const long long n_chunks = M / P / kChunk;
  const long long n_warps = (long long)gridDim.x * kThreads / 32;
  const int lane = threadIdx.x % 32;
  long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  int cur[K][P], nxt[K][P];
  auto load_chunk = [&](long long chunk, int (&i)[K][P]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      load_group<P, Io>(idx + (chunk * kChunk + k * 32 + lane) * P, idx_vec, i[k]);
  };
  if (c < n_chunks) load_chunk(c, cur);
  while (c < n_chunks) {
    const long long n = c + n_warps;
    if (n < n_chunks) load_chunk(n, nxt);
    gather_slots<K, P, true, Io>(rows, cur, R, W, dst, c * kChunk + lane, 32);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p) cur[k][p] = nxt[k][p];
    c = n;
  }
  for (long long r = n_chunks * kChunk * P + (long long)blockIdx.x * kThreads + threadIdx.x;
       r < M; r += n_warps * 32) {
    const int i[1][1] = {{Io::ld1(idx + r)}};
    gather_slots<1, 1, true, Io>(rows, i, R, W, dst, r, 0);
  }
}

// The table is read from device memory through L1 and L2, whatever its
// size: a table of the probe's 128 KB then lives in L1 (the kernel leaves
// the SM's shared memory to L1), larger ones in L2.
template <int V, int P, int K, int kThreads, class Io = Streams, class Tab = ReadOnlyTable>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
take_kernel(const float* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
            int R, int W, long long M) {
  using T = typename Vec<V>::T;
  take_walk<V, P, K, kThreads, Io>(GlobalRows<T, Tab>{reinterpret_cast<const T*>(table)}, idx,
                                   out, R, W, M);
}

// ---- loop ---------------------------------------------------------------

// Shared memory: a round's tile indices (kLoopIdxBytes, 16-byte aligned),
// then the table. The mbarrier lives in the first 8 bytes of the index
// area, so index slots 0-3 are not bulk copied: thread 0 holds slots 0-1
// in registers until the barrier is invalidated, and the other slots the
// bulk copy leaves (2-3, a tail of less than 16 bytes, or all of them where
// the index array is not 16-byte aligned) are loaded and stored by the
// block's threads while the copy runs. A walker takes the tile's groups of
// P rows lane, lane + 128, ... (V, W and P as in take_kernel).
template <int V, int P>
__global__ void __launch_bounds__(kLoopThreads)
loop_kernel(const float* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
            int R, int W, long long M) {
  using T = typename Vec<V>::T;
  constexpr int K = kLoopTile / P / kLoopWalkers;  // groups a walker takes in a tile
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  T* s_tab = reinterpret_cast<T*>(smem + kLoopIdxBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const T* g_tab = reinterpret_cast<const T*>(table);
  T* dst = reinterpret_cast<T*>(out);
  const SharedRows<T> tab{s_tab};
  const uint32_t tab_bytes = (uint32_t)((size_t)R * W * sizeof(T));
  const bool tab_bulk = aligned16(table) && tab_bytes % 16 == 0;
  const bool idx_bulk = aligned16(idx);
  const int group = threadIdx.x / kLoopWalkers, lane = threadIdx.x % kLoopWalkers;
  const long long n_tiles = (M + kLoopTile - 1) / kLoopTile;
  bool first_round = true;
  for (long long first = (long long)blockIdx.x * kLoopGroups; first < n_tiles;
       first += (long long)gridDim.x * kLoopGroups) {
    const long long base = first * kLoopTile;
    const int n = (int)(M - base < kLoopGroups * kLoopTile ? M - base : kLoopGroups * kLoopTile);
    const int n_bulk = idx_bulk && n > 4 ? (n - 4) / 4 * 4 : 0;  // slots [4, 4 + n_bulk)
    __syncthreads();  // the last round's walkers are done with the indices
    if (threadIdx.x == 0) {
      sst::mbar_init(bar, 1);
      sst::fence_mbar_init();
      const bool tab_now = first_round && tab_bulk;
      sst::mbar_arrive_expect_tx(bar, (tab_now ? tab_bytes : 0u) + 4u * n_bulk);
      if (tab_now) bulk_copy(s_tab, g_tab, tab_bytes, bar);
      if (n_bulk) bulk_copy(s_idx + 4, idx + base + 4, 4u * n_bulk, bar);
    }
    int head0 = 0, head1 = 0;
    if (threadIdx.x == 0) {
      head0 = Streams::ld1(idx + base);
      if (n > 1) head1 = Streams::ld1(idx + base + 1);
    }
    for (int j = 2 + threadIdx.x; j < n; j += kLoopThreads)
      if (j < 4 || j >= 4 + n_bulk) s_idx[j] = Streams::ld1(idx + base + j);
    if (first_round && !tab_bulk)
      for (long long j = threadIdx.x; j < (long long)R * W; j += kLoopThreads) s_tab[j] = g_tab[j];
    first_round = false;
    __syncthreads();  // the barrier is initialised before anyone waits on it
    sst::mbar_wait(bar, 0);
    __syncthreads();  // everyone has seen the phase complete
    if (threadIdx.x == 0) {
      mbar_inval(bar);
      s_idx[0] = head0;
      s_idx[1] = head1;
    }
    __syncthreads();
    const long long tile = first + group;
    if (tile >= n_tiles) continue;
    const long long t_base = tile * kLoopTile;
    const int rows = (int)(M - t_base < kLoopTile ? M - t_base : kLoopTile);
    const int* my_idx = s_idx + group * kLoopTile;
    if (rows == kLoopTile) {
      int i[K][P];
#pragma unroll
      for (int k = 0; k < K; ++k)
        load_group<P, SharedIdx>(my_idx + (k * kLoopWalkers + lane) * P, true, i[k]);
      gather_slots<K, P, false, Streams>(tab, i, R, W, dst, t_base / P + lane, kLoopWalkers);
    } else {
      for (int j = lane; j < rows; j += kLoopWalkers) {
        const int i[1][1] = {{my_idx[j]}};
        gather_slots<1, 1, false, Streams>(tab, i, R, W, dst, t_base + j, 0);
      }
    }
  }
}

// ---- host ---------------------------------------------------------------

// The widest vector (4, 2 or 1 floats) that divides F and that the table
// is aligned for (the output is 16-byte aligned).
int vec_width(const void* table, int F) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table);
  if (F % 4 == 0 && a % 16 == 0) return 4;
  if (F % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

std::mutex cache_mutex;

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

// The current device's SM count and opt-in shared memory, read once.
cudaError_t device_info(int* dev_out, DeviceInfo* info) {
  static DeviceInfo cache[kMaxDevices];
  int dev = -1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(cache_mutex);
  if (cache[dev].sms == 0) {
    DeviceInfo d;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cache[dev] = d;
  }
  *dev_out = dev;
  *info = cache[dev];
  return cudaSuccess;
}

size_t loop_smem(int R, int F) { return kLoopIdxBytes + (size_t)R * F * sizeof(float); }

// Launch `kern` with as many blocks as fit on the card at once, and no more
// than `need`. Its attributes are set once per device, and its occupancy is
// queried once per device and shared-memory size (a cache for each kernel).
template <auto kern>
int launch_resident(int threads, size_t smem, long long need, cudaStream_t stream,
                    const float* table, const int* idx, float* out, int R, int W, long long M) {
  struct Cached {
    bool configured = false;
    size_t smem = 0;
    int blocks = 0;
  };
  static Cached cache[kMaxDevices];
  int dev = -1;
  DeviceInfo info;
  cudaError_t err = device_info(&dev, &info);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  {
    std::lock_guard<std::mutex> lock(cache_mutex);
    Cached& c = cache[dev];
    if (!c.configured) {
      // up to the opt-in maximum, so every size that fits launches; a
      // kernel that stages nothing leaves the SM's shared memory to L1
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 info.smem_optin);
      if (err == cudaSuccess && smem == 0)
        err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxL1);
      if (err != cudaSuccess) return (int)err;
      c.configured = true;
    }
    if (c.blocks == 0 || c.smem != smem) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
      if (err != cudaSuccess) return (int)err;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      c.smem = smem;
      c.blocks = per_sm * info.sms;
    }
    blocks = c.blocks;
  }
  const long long grid = need < blocks ? need : blocks;
  kern<<<(unsigned)grid, threads, smem, stream>>>(table, idx, out, R, W, M);
  return (int)cudaGetLastError();
}

template <int V, int P, int K>
int take_vp(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s) {
  const long long need = (M / P / K + kTakeThreads - 1) / kTakeThreads + 1;  // a lane a slot
  return launch_resident<take_kernel<V, P, K, kTakeThreads>>(kTakeThreads, 0, need, s, t, i, o, R,
                                                             F / V, M);
}

// kTakeSlots slots a thread, each P rows: 16 bytes where a row is one
// vector, else one row
int take_launch(const void* table, const void* idx, void* out, int R, int F, long long M,
                void* stream) {
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int K = kTakeSlots;
  const int V = vec_width(table, F);
  if (V == 4) return take_vp<4, 1, K>(t, i, o, R, F, M, s);
  if (V == 2)
    return F == 2 ? take_vp<2, 2, K>(t, i, o, R, F, M, s) : take_vp<2, 1, K>(t, i, o, R, F, M, s);
  return F == 1 ? take_vp<1, 4, K>(t, i, o, R, F, M, s) : take_vp<1, 1, K>(t, i, o, R, F, M, s);
}

template <int V, int P>
int loop_vp(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s) {
  const long long per_block = (long long)kLoopGroups * kLoopTile;
  const long long need = (M + per_block - 1) / per_block;
  return launch_resident<loop_kernel<V, P>>(kLoopThreads, loop_smem(R, F), need, s, t, i, o, R,
                                            F / V, M);
}

bool args_ok(const void* out, int R, int F, long long M) {
  return R >= 1 && F >= 1 && M >= 1 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
}

}  // namespace

extern "C" {

// Shared memory a block may opt into on the current device, in bytes (-1 on error).
int sst_row_gather_smem_limit() {
  int dev;
  DeviceInfo info;
  return device_info(&dev, &info) == cudaSuccess ? info.smem_optin : -1;
}

// Rows a thread of `take` owns at a time for rows of F floats (of a
// 16-byte aligned table).
int sst_row_gather_take_rows(int F) {
  const int V = F % 4 == 0 ? 4 : F % 2 == 0 ? 2 : 1;
  return kTakeSlots * (F == V ? 4 / V : 1);
}

// Bytes of shared memory `loop` needs for a table of R x F floats; it
// refuses a table for which this exceeds sst_row_gather_smem_limit().
long long sst_row_gather_loop_smem_bytes(int R, int F) { return (long long)loop_smem(R, F); }

// table [R, F] f32, idx [M] int32 in [0, R], out [M, F] f32: contiguous
// device pointers, out 16-byte aligned. Enqueue on `stream`; return
// cudaGetLastError().
int sst_row_gather_take(const void* table, const void* idx, void* out, int R, int F, long long M,
                        void* stream) {
  if (!args_ok(out, R, F, M)) return (int)cudaErrorInvalidValue;
  return take_launch(table, idx, out, R, F, M, stream);
}

// As sst_row_gather_take, with the clamping loop kernel. Returns -1, and
// launches nothing, where the table and a round's indices do not fit a
// block's shared memory.
int sst_row_gather_loop(const void* table, const void* idx, void* out, int R, int F, long long M,
                        void* stream) {
  if (!args_ok(out, R, F, M)) return (int)cudaErrorInvalidValue;
  int dev;
  DeviceInfo info;
  const cudaError_t err = device_info(&dev, &info);
  if (err != cudaSuccess) return (int)err;
  if (loop_smem(R, F) > (size_t)info.smem_optin) return kErrNoFit;
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = vec_width(table, F);
  if (V == 4) return loop_vp<4, 1>(t, i, o, R, F, M, s);
  if (V == 2) return F == 2 ? loop_vp<2, 2>(t, i, o, R, F, M, s) : loop_vp<2, 1>(t, i, o, R, F, M, s);
  return F == 1 ? loop_vp<1, 4>(t, i, o, R, F, M, s) : loop_vp<1, 1>(t, i, o, R, F, M, s);
}

}  // extern "C"
