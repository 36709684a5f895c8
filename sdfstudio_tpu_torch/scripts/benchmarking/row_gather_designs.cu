// The row-gather kernel `take` of csrc/row_gather.cu at other design
// points than the library's, for row_gather_designs.py to time side by
// side: rows per thread, the table staged in shared memory by bulk copy
// instead of read through L1 and L2, other cache policies of the table
// reads and of the index and output streams, and two floors of the same
// walk (the index and table reads without the output, and the index and
// output streams without the table). Built on its own, beside the
// library; the library itself takes one design.

#include "../../csrc/row_gather.cu"

namespace {

constexpr int kStagedThreads = 1024;  // the staged table leaves room for one block an SM
constexpr int kStageHeader = 16;      // shared bytes before the staged table: the mbarrier

// indices and output under the default policy
struct PlainStreams {
  static __device__ __forceinline__ int4 ld4(const int4* p) { return __ldg(p); }
  static __device__ __forceinline__ int2 ld2(const int2* p) { return __ldg(p); }
  static __device__ __forceinline__ int ld1(const int* p) { return __ldg(p); }
  template <typename T>
  static __device__ __forceinline__ void st(T* p, const T& v) { *p = v; }
};

// the index stream of Streams, and no output: a value is stored only where
// its bits are a NaN that no table of the runs holds, so every read stays
// live and nothing is written
struct NoStores {
  static __device__ __forceinline__ int4 ld4(const int4* p) { return __ldcs(p); }
  static __device__ __forceinline__ int2 ld2(const int2* p) { return __ldcs(p); }
  static __device__ __forceinline__ int ld1(const int* p) { return __ldcs(p); }
  template <typename T>
  static __device__ __forceinline__ void st(T* p, const T& v) {
    const unsigned* u = reinterpret_cast<const unsigned*>(&v);
    unsigned x = 0;
#pragma unroll
    for (int j = 0; j < (int)(sizeof(T) / 4); ++j) x ^= u[j];
    if (x == 0x7f800001u) *p = v;
  }
};

// table reads through the read-only path under an L2 evict_last policy
struct KeepTable {
  static __device__ __forceinline__ uint64_t policy() {
    uint64_t p;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
    return p;
  }
  static __device__ __forceinline__ float2 ld(const float2* p) {
    float2 v;
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(v.x), "=f"(v.y) : "l"(p), "l"(policy()));
    return v;
  }
  static __device__ __forceinline__ float4 ld(const float4* p) {
    float4 v;
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(policy()));
    return v;
  }
};

// table reads that skip L1 (no allocation), default L2 policy
struct NoL1Table {
  static __device__ __forceinline__ float2 ld(const float2* p) {
    float2 v;
    asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p));
    return v;
  }
  static __device__ __forceinline__ float4 ld(const float4* p) {
    float4 v;
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  }
};

// no table: a row's value is made from its address, so nothing is read
struct NoTable {
  template <typename T>
  static __device__ __forceinline__ T ld(const T* p) {
    T v;
    float* f = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int j = 0; j < (int)(sizeof(T) / 4); ++j)
      f[j] = __int_as_float((int)reinterpret_cast<uintptr_t>(p) + j);
    return v;
  }
};

// design (i): the table staged in shared memory by bulk copy under one
// mbarrier (in the header), then the library's walk over it
template <int V, int P, int K>
__global__ void __launch_bounds__(kStagedThreads, 1)
take_staged_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int R, int W, long long M) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* s_tab = reinterpret_cast<T*>(smem + kStageHeader);
  const uint32_t tab_bytes = (uint32_t)((size_t)R * W * sizeof(T));
  if (threadIdx.x == 0) {
    sst::mbar_init(bar, 1);
    sst::fence_mbar_init();
    sst::mbar_arrive_expect_tx(bar, tab_bytes);
    bulk_copy(s_tab, table, tab_bytes, bar);
  }
  __syncthreads();
  sst::mbar_wait(bar, 0);
  take_walk<V, P, K, kStagedThreads, Streams>(SharedRows<T>{s_tab}, idx, out, R, W, M);
}

size_t staged_smem(int R, int F) { return kStageHeader + (size_t)R * F * sizeof(float); }

template <int V, int P, int K>
int staged_vp(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s) {
  const long long need = (M / P / K + kStagedThreads - 1) / kStagedThreads + 1;
  return launch_resident<take_staged_kernel<V, P, K>>(kStagedThreads, staged_smem(R, F), need, s,
                                                      t, i, o, R, F / V, M);
}

template <int V, int P, int K, class Io, class Tab>
int design_vp(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s) {
  const long long need = (M / P / K + kTakeThreads - 1) / kTakeThreads + 1;
  return launch_resident<take_kernel<V, P, K, kTakeThreads, Io, Tab>>(kTakeThreads, 0, need, s, t,
                                                                      i, o, R, F / V, M);
}

// the designs are timed on aligned tables of F = 2 and F = 4; B rows a thread
template <int B, class Io, class Tab>
int design_b(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s,
             bool staged) {
  const bool f4 = F == 4 && vec_width(t, F) == 4, f2 = F == 2 && vec_width(t, F) == 2;
  if (staged && f4) return staged_vp<4, 1, B>(t, i, o, R, F, M, s);
  if (staged && f2) return staged_vp<2, 2, B / 2>(t, i, o, R, F, M, s);
  if (f4) return design_vp<4, 1, B, Io, Tab>(t, i, o, R, F, M, s);
  if (f2) return design_vp<2, 2, B / 2, Io, Tab>(t, i, o, R, F, M, s);
  return (int)cudaErrorInvalidValue;
}

template <class Io, class Tab>
int design_p(const float* t, const int* i, float* o, int R, int F, long long M, cudaStream_t s,
             int batch, bool staged) {
  switch (batch) {
    case 4: return design_b<4, Io, Tab>(t, i, o, R, F, M, s, staged);
    case 8: return design_b<8, Io, Tab>(t, i, o, R, F, M, s, staged);
    case 16: return design_b<16, Io, Tab>(t, i, o, R, F, M, s, staged);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// `take` with `batch` rows a thread (4, 8 or 16). `staged`: the table in
// shared memory (it must fit), the library's streams. Else `policy` picks
// the streams' and the table's cache policies: 0 the library's (streams
// evict-first, the table default), 1 default everywhere, 2 streams
// evict-first and the table evict_last, 3 streams default and the table
// evict_last, 4 streams evict-first and the table past L1, 5 streams
// default and the table past L1; and two floors with the library's
// policies: 6 reads only (no output), 7 streams only (no table). Returns
// cudaGetLastError().
int sst_design_take(const void* table, const void* idx, void* out, int R, int F, long long M,
                    void* stream, int batch, int staged, int policy) {
  if (!args_ok(out, R, F, M)) return (int)cudaErrorInvalidValue;
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    int dev;
    DeviceInfo info;
    const cudaError_t err = device_info(&dev, &info);
    if (err != cudaSuccess) return (int)err;
    if (staged_smem(R, F) > (size_t)info.smem_optin || !aligned16(table) || (R * F) % 4)
      return (int)cudaErrorInvalidValue;
    return design_p<Streams, ReadOnlyTable>(t, i, o, R, F, M, s, batch, true);
  }
  switch (policy) {
    case 0: return design_p<Streams, ReadOnlyTable>(t, i, o, R, F, M, s, batch, false);
    case 1: return design_p<PlainStreams, ReadOnlyTable>(t, i, o, R, F, M, s, batch, false);
    case 2: return design_p<Streams, KeepTable>(t, i, o, R, F, M, s, batch, false);
    case 3: return design_p<PlainStreams, KeepTable>(t, i, o, R, F, M, s, batch, false);
    case 4: return design_p<Streams, NoL1Table>(t, i, o, R, F, M, s, batch, false);
    case 5: return design_p<PlainStreams, NoL1Table>(t, i, o, R, F, M, s, batch, false);
    case 6: return design_p<NoStores, ReadOnlyTable>(t, i, o, R, F, M, s, batch, false);
    case 7: return design_p<Streams, NoTable>(t, i, o, R, F, M, s, batch, false);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
