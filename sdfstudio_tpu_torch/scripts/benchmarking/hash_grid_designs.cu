// The hash-grid kernels at other design points than the library's, for
// hash_grid_designs.py to time side by side on the same inputs:
//   * sst_baseline_hash_encode_fwd / _bwd: the first design of these kernels,
//     kept verbatim as the baseline (namespace baseline below): a thread per
//     (point, level), neighbouring threads on neighbouring levels of one
//     point, 8 float2 row loads in flight, one float2 reduction a corner;
//     F = 2 only. It runs on no path of the port;
//   * sst_design_hash_fwd: other forwards than the library's: over the
//     backward's level-major tiles (with paired 16-byte x-corner loads, one
//     item a warp, a register cap), the library's mapping with the weights
//     rebuilt after the loads, paired x-corner loads or a register cap, and
//     two levels a thread (with the hashed levels read past L1);
//   * sst_design_hash_bwd: the library's backward with each move switched
//     on or off: the paired float4 reductions (F = 2) and the warp
//     aggregation;
//   * sst_design_hash_floor: three floors of the walk.
// Built on its own, beside the library; with SST_HASH_BASELINE_ONLY defined
// it holds the first design alone (what chip_smoke.py times the library
// against), a build of a few kernels instead of dozens.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SST_HASH_BASELINE_ONLY
#include "../../csrc/hash_grid.cu"
#endif

namespace baseline {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

struct Levels {
  int num;
  uint32_t table_mask;  // 2^log2 - 1
  uint32_t dense;       // bit l: level l is indexed densely
  float res[kMaxLevels];
  uint32_t stride[kMaxLevels];  // res + 1
  uint32_t offset[kMaxLevels];
};

// The kernels take F = 2 features a level, every hash grid of the ported
// methods: a row is one float2, a thread's out slice one float2 and its
// jac slice three.
constexpr int kF = 2;

// Read-once and write-once streams go evict-first: N float2s at p.
template <int N>
__device__ __forceinline__ void load_stream(const float* __restrict__ p, float (&v)[2 * N]) {
#pragma unroll
  for (int h = 0; h < N; ++h) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p) + h);
    v[2 * h] = q.x;
    v[2 * h + 1] = q.y;
  }
}

template <int N>
__device__ __forceinline__ void store_stream(float* __restrict__ p, const float (&v)[2 * N]) {
#pragma unroll
  for (int h = 0; h < N; ++h)
    __stcs(reinterpret_cast<float2*>(p) + h, make_float2(v[2 * h], v[2 * h + 1]));
}

// The cell of x at level l: the 8 corner rows, their weights and, with kJac,
// d weight / dx (encodings.py:328-430).
template <bool kJac>
__device__ __forceinline__ void cell(const Levels& lv, int l, bool smooth, const float (&x)[3],
                                     uint32_t (&idx)[8], float (&w)[8], float (&dw)[8][3]) {
  const float r = lv.res[l];
  uint32_t c[3];
  float cw1[3], cw0[3], dv[3];  // per axis: weight of the ceiling / floor corner, its derivative
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(x[a], r);
    const float fl = floorf(s);
    const float o = __fsub_rn(s, fl);
    c[a] = (uint32_t)(int)fl;
    if (smooth) {
      cw1[a] = __fmul_rn(__fmul_rn(o, o), __fsub_rn(3.0f, __fmul_rn(2.0f, o)));
      dv[a] = __fmul_rn(__fmul_rn(6.0f, o), __fsub_rn(1.0f, o));
    } else {
      cw1[a] = o;
      dv[a] = 1.0f;
    }
    cw0[a] = __fsub_rn(1.0f, cw1[a]);
  }
  const bool dense = (lv.dense >> l) & 1u;
  const uint32_t st = lv.stride[l];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t cx = c[0] + (k & 1), cy = c[1] + ((k >> 1) & 1), cz = c[2] + ((k >> 2) & 1);
    const uint32_t i = dense ? cx + cy * st + cz * st * st
                             : ((cx ^ (cy * kPrime1) ^ (cz * kPrime2)) & lv.table_mask);
    idx[k] = i + lv.offset[l];
    const float f0 = (k & 1) ? cw1[0] : cw0[0];
    const float f1 = (k & 2) ? cw1[1] : cw0[1];
    const float f2 = (k & 4) ? cw1[2] : cw0[2];
    w[k] = __fmul_rn(__fmul_rn(f0, f1), f2);
    if constexpr (kJac) {
      // sign * dsmooth_a * prod_{b != a} cw_b * res
      dw[k][0] = __fmul_rn(__fmul_rn((k & 1) ? dv[0] : -dv[0], __fmul_rn(f1, f2)), r);
      dw[k][1] = __fmul_rn(__fmul_rn((k & 2) ? dv[1] : -dv[1], __fmul_rn(f0, f2)), r);
      dw[k][2] = __fmul_rn(__fmul_rn((k & 4) ? dv[2] : -dv[2], __fmul_rn(f0, f1)), r);
    }
  }
}

template <bool kJac>
__global__ void __launch_bounds__(kThreads)
hash_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                float* __restrict__ out, float* __restrict__ jac, long long n, uint32_t rows,
                Levels lv, bool smooth) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const int l = (int)(t - p * lv.num);
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);  // shared by the point's L threads
  uint32_t idx[8];
  float w[8], dw[8][3];
  cell<kJac>(lv, l, smooth, xp, idx, w, dw);
  float2 rv[8];  // all 8 rows in flight before any is blended
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float nan = __int_as_float(0x7fc00000);
    rv[k] = idx[k] < rows ? __ldg(reinterpret_cast<const float2*>(table) + idx[k])
                          : make_float2(nan, nan);
  }
  float acc[kF] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[0] += w[k] * rv[k].x;
    acc[1] += w[k] * rv[k].y;
  }
  store_stream<1>(out + (size_t)t * kF, acc);
  if constexpr (kJac) {
    float jv[3 * kF];  // [f][a]
#pragma unroll
    for (int e = 0; e < 3 * kF; ++e) jv[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        jv[a] += dw[k][a] * rv[k].x;
        jv[3 + a] += dw[k][a] * rv[k].y;
      }
    store_stream<3>(jac + (size_t)t * 3 * kF, jv);
  }
}

template <bool kOut, bool kJac>
__global__ void __launch_bounds__(kThreads)
hash_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g_out,
                const float* __restrict__ g_jac, float* __restrict__ grad, long long n,
                uint32_t rows, Levels lv, bool smooth) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const int l = (int)(t - p * lv.num);
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);
  uint32_t idx[8];
  float w[8], dw[8][3];
  cell<kJac>(lv, l, smooth, xp, idx, w, dw);
  float go[kF] = {0.0f, 0.0f}, gj[3 * kF];
  if constexpr (kOut) load_stream<1>(g_out + (size_t)t * kF, go);
  if constexpr (kJac) load_stream<3>(g_jac + (size_t)t * 3 * kF, gj);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (idx[k] >= rows) continue;
    float u[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      float v = 0.0f;
      if constexpr (kOut) v = w[k] * go[f];
      if constexpr (kJac)
        v += dw[k][0] * gj[3 * f] + dw[k][1] * gj[3 * f + 1] + dw[k][2] * gj[3 * f + 2];
      u[f] = v;
    }
    // one vector reduction of the row's two floats (sm_90)
    atomicAdd(reinterpret_cast<float2*>(grad) + idx[k], make_float2(u[0], u[1]));
  }
}

bool make_levels(int L, const int* res, const uint32_t* offsets, const int* dense, int log2_size,
                 Levels* lv) {
  if (L < 1 || L > kMaxLevels || log2_size < 1 || log2_size > 31) return false;
  lv->num = L;
  lv->table_mask = (1u << log2_size) - 1u;
  lv->dense = 0;
  for (int l = 0; l < L; ++l) {
    if (res[l] < 1) return false;
    lv->res[l] = (float)res[l];
    lv->stride[l] = (uint32_t)res[l] + 1u;
    lv->offset[l] = offsets[l];
    if (dense[l]) lv->dense |= 1u << l;
  }
  return true;
}

unsigned grid_for(long long n, int L) { return (unsigned)((n * L + kThreads - 1) / kThreads); }

bool args_ok(long long n, long long rows, int F, int L) {
  return n > 0 && rows > 0 && rows <= 0xffffffffLL && F == kF
         && n * L <= (long long)INT32_MAX * kThreads;  // the grid's x dimension
}

}  // namespace baseline

#ifndef SST_HASH_BASELINE_ONLY
namespace {

constexpr int kMaxWarps = 16;  // a tile block of the designs: up to one item a warp
constexpr int kMaxThreads = 32 * kMaxWarps;

// The blend of one (point, level): out[f] = sum_k w_k v_k[f] and, with
// kJac, jv[3 f + a] = sum_k dw_k/dx_a v_k[f], the weights rebuilt here.
template <int F, bool kJac>
__device__ __forceinline__ void blend(const Cell& cl, const float (&v)[8][F], float (&acc)[F],
                                      float (&jv)[3 * F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int e = 0; e < 3 * F; ++e) jv[e] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = weight(cl, k);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += w * v[k][f];
    if constexpr (kJac)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float d = dweight(cl, k, a);
#pragma unroll
        for (int f = 0; f < F; ++f) jv[3 * f + a] += d * v[k][f];
      }
  }
}

// The 8 corner rows of a cell, every load issued before any is used. With
// kPair (F = 2) the x-neighbours c, c+1 whose rows form one 16-byte aligned
// pair come from one 16-byte load; without, the library's loads.
template <int F, bool kPair>
__device__ __forceinline__ void load_rows_design(const float* __restrict__ table, uint32_t rows,
                                          const uint32_t (&idx)[8], float (&v)[8][F]) {
  if constexpr (kPair && F == 2) {
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const uint32_t a = idx[k], b = idx[k + 1];
      const bool whole = (a | 1u) < rows;  // a's aligned pair lies in the table
      float2 ra, other = nan2();
      if (whole) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(table) + (a >> 1));
        ra = (a & 1u) ? make_float2(q.z, q.w) : make_float2(q.x, q.y);
        other = (a & 1u) ? make_float2(q.x, q.y) : make_float2(q.z, q.w);
      } else {
        ra = a < rows ? __ldg(reinterpret_cast<const float2*>(table) + a) : nan2();
      }
      const bool pair = whole && (a ^ b) == 1u;
      const float2 rb = pair ? other
                             : (b < rows ? __ldg(reinterpret_cast<const float2*>(table) + b) : nan2());
      v[k][0] = ra.x; v[k][1] = ra.y;
      v[k + 1][0] = rb.x; v[k + 1][1] = rb.y;
    }
  } else {
    load_rows<F>(table, rows, idx, v);
  }
}

// Copy np points' rows of U float2s from shared memory at row stride S to a
// global run (16-byte aligned): float2 loads, 16-byte evict-first stores.
__device__ __forceinline__ void tile_store(const float2* s, int S, int U, int np, float* g) {
  const int total = np * U;
  for (int q = 2 * threadIdx.x; q < total; q += 2 * blockDim.x) {
    const int p = q / U, c = q - p * U;
    const float2 a = s[p * S + c];
    if (q + 1 < total) {
      const int p1 = (q + 1) / U, c1 = q + 1 - p1 * U;
      const float2 b = s[p1 * S + c1];
      __stcs(reinterpret_cast<float4*>(g) + (q >> 1), make_float4(a.x, a.y, b.x, b.y));
    } else {
      __stcs(reinterpret_cast<float2*>(g) + q, a);
    }
  }
}

// The forward over level-major tiles, as the backward runs: a warp is 32
// consecutive points at one level, x staged once a tile, out and jac
// assembled in shared memory and stored as contiguous 16-byte runs.
template <int F, bool kJac, bool kPair, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
hash_fwd_tiles_kernel(const float* __restrict__ x, const float* __restrict__ table,
                float* __restrict__ out, float* __restrict__ jac, long long n, uint32_t rows,
                Levels lv, bool smooth, int G) {
  extern __shared__ __align__(16) float smem[];
  const TileShape ts = tile_shape(lv.num, F, G);
  const long long p0 = (long long)blockIdx.x * ts.P;
  const int np = (int)(n - p0 < ts.P ? n - p0 : ts.P);
  float* sx = smem;
  float2* so = reinterpret_cast<float2*>(smem + 3 * ts.P);
  float2* sj = so + ts.P * ts.Su;
  tile_load_x(sx, np, x + 3 * p0);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = warp; it < ts.G * lv.num; it += (int)(blockDim.x >> 5)) {
    const int g = it % ts.G, l = it / ts.G, pt = 32 * g + lane;
    if (pt >= np) continue;  // no shuffles here: a lane past the batch may leave
    const float xp[3] = {sx[3 * pt], sx[3 * pt + 1], sx[3 * pt + 2]};
    const Cell cl = make_cell(lv, l, smooth, xp);
    uint32_t idx[8];
    corner_rows(lv, l, cl, idx);
    float v[8][F], acc[F], jv[3 * F];
    load_rows_design<F, kPair>(table, rows, idx, v);
    blend<F, kJac>(cl, v, acc, jv);
#pragma unroll
    for (int h = 0; h < F / 2; ++h)
      so[pt * ts.Su + l * (F / 2) + h] = make_float2(acc[2 * h], acc[2 * h + 1]);
    if constexpr (kJac)
#pragma unroll
      for (int h = 0; h < 3 * F / 2; ++h)
        sj[pt * ts.Sj + l * (3 * F / 2) + h] = make_float2(jv[2 * h], jv[2 * h + 1]);
  }
  __syncthreads();
  tile_store(so, ts.Su, ts.U, np, out + p0 * 2 * ts.U);
  if constexpr (kJac) tile_store(sj, ts.Sj, ts.Uj, np, jac + p0 * 2 * ts.Uj);
}

// The forward with a thread per point and pair of levels (2j, 2j + 1):
// its 16 row loads are in flight together, twice the first design's, and
// its out and jac slices of both levels are one contiguous run, stored as
// 16-byte vectors (F = 2: out 16 bytes, jac 48; F = 4: 32 and 96). With
// kBypass the hashed levels' rows are read past L1 (ld.global.cg), so
// that the fine levels' random rows do not evict the dense levels' cells,
// which the samples of a ray share.
template <int F, bool kJac, bool kBypass>
__global__ void __launch_bounds__(kRowThreads)
hash_fwd_pairs_kernel(const float* __restrict__ x, const float* __restrict__ table,
                      float* __restrict__ out, float* __restrict__ jac, long long n,
                      uint32_t rows, Levels lv, bool smooth) {
  const int H = (lv.num + 1) >> 1;  // level pairs a point
  const long long t = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= n * H) return;
  const long long p = t / H;
  const int j = (int)(t - p * H);
  const int l0 = 2 * j;
  const bool two = l0 + 1 < lv.num;
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);
  Cell cl[2];
  uint32_t idx[2][8];
  float v[2][8][F];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = two ? l0 + h : l0;
    cl[h] = make_cell(lv, l, smooth, xp);
    corner_rows(lv, l, cl[h], idx[h]);
    if (h == 1 && !two)  // a lone last level: its second half loads nothing and stores nothing
#pragma unroll
      for (int k = 0; k < 8; ++k) idx[h][k] = rows;
    if (kBypass && !((lv.dense >> l) & 1u)) {
      using R = Row<F>;
      typename R::T rv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        rv[k] = idx[h][k] < rows ? __ldcg(reinterpret_cast<const typename R::T*>(table) + idx[h][k])
                                 : R::nan();
#pragma unroll
      for (int k = 0; k < 8; ++k) R::get(rv[k], v[h][k]);
    } else {
      load_rows<F>(table, rows, idx[h], v[h]);
    }
  }
  float acc[2][F], jv[2][3 * F];
#pragma unroll
  for (int h = 0; h < 2; ++h) blend<F, kJac>(cl[h], v[h], acc[h], jv[h]);
  const long long o = (p * lv.num + l0) * F;  // the first level's out slice
  // 16-byte vectors where the slice is 16-byte aligned: always at F = 4, at
  // F = 2 where p L + 2j is even (every point at an even L)
  const bool v4 = two && (F == 4 || ((p * lv.num + l0) & 1) == 0);
  float q[2 * F], r[6 * F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    q[f] = acc[0][f];
    q[F + f] = acc[1][f];
  }
#pragma unroll
  for (int e = 0; e < 3 * F; ++e) {
    r[e] = jv[0][e];
    r[3 * F + e] = jv[1][e];
  }
  const int nq = two ? 2 * F : F;  // floats of out (jac: 3 nq) this thread writes
  if (v4) {
#pragma unroll
    for (int h = 0; h < 2 * F / 4; ++h)
      __stcs(reinterpret_cast<float4*>(out + o) + h,
             make_float4(q[4 * h], q[4 * h + 1], q[4 * h + 2], q[4 * h + 3]));
    if constexpr (kJac)
#pragma unroll
      for (int h = 0; h < 6 * F / 4; ++h)
        __stcs(reinterpret_cast<float4*>(jac + 3 * o) + h,
               make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]));
  } else {
#pragma unroll
    for (int h = 0; h < F; ++h)
      if (2 * h < nq) __stcs(reinterpret_cast<float2*>(out + o) + h, make_float2(q[2 * h], q[2 * h + 1]));
    if constexpr (kJac)
#pragma unroll
      for (int h = 0; h < 3 * F; ++h)
        if (2 * h < 3 * nq)
          __stcs(reinterpret_cast<float2*>(jac + 3 * o) + h, make_float2(r[2 * h], r[2 * h + 1]));
  }
}

// The library's forward with a register budget (kMinBlocks), with kRebuild
// the corner weights rebuilt from the cell after the loads instead of
// computed before them and held across them, and with kPair (F = 2) the
// paired 16-byte x-corner loads.
template <int F, bool kJac, int kMinBlocks, bool kRebuild, bool kPair = false>
__global__ void __launch_bounds__(kRowThreads, kMinBlocks)
hash_fwd_direct_design_kernel(const float* __restrict__ x, const float* __restrict__ table,
                              float* __restrict__ out, float* __restrict__ jac, long long n,
                              uint32_t rows, Levels lv, bool smooth) {
  const long long t = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const int l = (int)(t - p * lv.num);
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);  // shared by the point's L threads
  float v[8][F], acc[F], jv[3 * F];
  if constexpr (kRebuild) {
    const Cell cl = make_cell(lv, l, smooth, xp);
    uint32_t idx[8];
    corner_rows(lv, l, cl, idx);
    load_rows<F>(table, rows, idx, v);
    blend<F, kJac>(cl, v, acc, jv);
  } else {
    uint32_t c[3], idx[8];
    float w[8], dw[8][3];
    cell<kJac>(lv, l, smooth, xp, c, idx, w, dw);
    load_rows_design<F, kPair>(table, rows, idx, v);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[f] += w[k] * v[k][f];
      if constexpr (kJac)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) s += dw[k][a] * v[k][f];
          jv[3 * f + a] = s;
        }
    }
  }
#pragma unroll
  for (int h = 0; h < F / 2; ++h)
    __stcs(reinterpret_cast<float2*>(out + t * F) + h, make_float2(acc[2 * h], acc[2 * h + 1]));
  if constexpr (kJac)
#pragma unroll
    for (int h = 0; h < 3 * F / 2; ++h)
      __stcs(reinterpret_cast<float2*>(jac + t * 3 * F) + h, make_float2(jv[2 * h], jv[2 * h + 1]));
}

// One (group, level) item a warp: G = 16 / L groups (1 for L >= 16) and G L
// warps, at most 16, which take the items in turn past that.
inline TilePlan item_plan(int L) {
  const int G = L >= kMaxWarps ? 1 : kMaxWarps / L;
  return {G, G * L < kMaxWarps ? G * L : kMaxWarps};
}

template <int F, bool kJac, bool kPair, int kMinBlocks>
int fwd_tiles(const float* x, const float* table, float* out, float* jac, long long n,
              uint32_t rows, const Levels& lv, bool smooth, cudaStream_t s, const TilePlan& tp) {
  const int smem = tile_smem(tile_shape(lv.num, F, tp.G), true, kJac);
  return launch_tiles(hash_fwd_tiles_kernel<F, kJac, kPair, kMinBlocks>, n, tp, smem, s, x, table,
                      out, jac, n, rows, lv, smooth);
}

template <int F, bool kJac, bool kBypass>
int fwd_pairs(const float* x, const float* table, float* out, float* jac, long long n,
              uint32_t rows, const Levels& lv, bool smooth, cudaStream_t s) {
  const long long items = n * ((lv.num + 1) / 2);
  const unsigned grid = (unsigned)((items + kRowThreads - 1) / kRowThreads);
  hash_fwd_pairs_kernel<F, kJac, kBypass><<<grid, kRowThreads, 0, s>>>(x, table, out, jac, n, rows,
                                                                      lv, smooth);
  return (int)cudaGetLastError();
}

template <int F, bool kJac, int kMinBlocks, bool kRebuild, bool kPair = false>
int fwd_direct(const float* x, const float* table, float* out, float* jac, long long n,
               uint32_t rows, const Levels& lv, bool smooth, cudaStream_t s) {
  const unsigned grid = (unsigned)((n * lv.num + kRowThreads - 1) / kRowThreads);
  hash_fwd_direct_design_kernel<F, kJac, kMinBlocks, kRebuild, kPair>
      <<<grid, kRowThreads, 0, s>>>(x, table, out, jac, n, rows, lv, smooth);
  return (int)cudaGetLastError();
}

// The forward designs: 0 tiles, 1 tiles with paired x-corners (F = 2), 2
// tiles with one item a warp, 3 tiles at most 42 registers (a 512-thread
// block's bound with 3 blocks an SM), 4 the library's mapping with the
// weights rebuilt after the loads, 5 the library's at most 42 registers,
// 6 two levels a thread, 7 the same with the hashed levels read past L1,
// 8 the library's mapping with paired x-corner loads (F = 2).
template <int F, bool kJac>
int design_fwd(const float* xp, const float* tp, float* op, float* jp, long long n, uint32_t r,
               const Levels& lv, bool sm, cudaStream_t s, int variant) {
  const TilePlan tiles = tile_plan(lv.num);
  switch (variant) {
    case 0: return fwd_tiles<F, kJac, false, 1>(xp, tp, op, jp, n, r, lv, sm, s, tiles);
    case 1: return fwd_tiles<F, kJac, F == 2, 1>(xp, tp, op, jp, n, r, lv, sm, s, tiles);
    case 2: return fwd_tiles<F, kJac, false, 1>(xp, tp, op, jp, n, r, lv, sm, s, item_plan(lv.num));
    case 3: return fwd_tiles<F, kJac, false, 3>(xp, tp, op, jp, n, r, lv, sm, s, tiles);
    case 4: return fwd_direct<F, kJac, 1, true>(xp, tp, op, jp, n, r, lv, sm, s);
    case 5: return fwd_direct<F, kJac, 6, false>(xp, tp, op, jp, n, r, lv, sm, s);
    case 6: return fwd_pairs<F, kJac, false>(xp, tp, op, jp, n, r, lv, sm, s);
    case 7: return fwd_pairs<F, kJac, true>(xp, tp, op, jp, n, r, lv, sm, s);
    case 8: return fwd_direct<F, kJac, 1, false, F == 2>(xp, tp, op, jp, n, r, lv, sm, s);
  }
  return (int)cudaErrorInvalidValue;
}


// Floors of the walk, which are not the function and are not compared with
// it: the forward's table reads alone (the direct mapping's rows summed,
// stored only where the sum's bits are a NaN no table of the runs holds),
// its streams alone (x read, out and jac written, no table read), and the
// backward's reductions alone (the first design's mapping: each corner
// adds a constant to its row, no cotangent read).
template <int F>
__global__ void __launch_bounds__(kRowThreads)
floor_reads_kernel(const float* __restrict__ x, const float* __restrict__ table,
                   float* __restrict__ out, long long n, uint32_t rows, Levels lv, bool smooth) {
  const long long t = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const int l = (int)(t - p * lv.num);
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);
  const Cell cl = make_cell(lv, l, smooth, xp);
  uint32_t idx[8];
  corner_rows(lv, l, cl, idx);
  float v[8][F];
  load_rows<F>(table, rows, idx, v);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int f = 0; f < F; ++f) s += v[k][f];
  if (__float_as_uint(s) == 0x7f800001u) out[t * F] = s;
}

template <int F, bool kJac>
__global__ void __launch_bounds__(kRowThreads)
floor_streams_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ jac,
                     long long n, Levels lv) {
  const long long t = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const float s = __ldg(x + 3 * p) + __ldg(x + 3 * p + 1) + __ldg(x + 3 * p + 2);
#pragma unroll
  for (int h = 0; h < F / 2; ++h) __stcs(reinterpret_cast<float2*>(out + t * F) + h, make_float2(s, s));
  if constexpr (kJac)
#pragma unroll
    for (int h = 0; h < 3 * F / 2; ++h)
      __stcs(reinterpret_cast<float2*>(jac + t * 3 * F) + h, make_float2(s, s));
}

template <int F>
__global__ void __launch_bounds__(kRowThreads)
floor_reductions_kernel(const float* __restrict__ x, float* __restrict__ grad, long long n,
                        uint32_t rows, Levels lv, bool smooth) {
  const long long t = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const int l = (int)(t - p * lv.num);
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);
  const Cell cl = make_cell(lv, l, smooth, xp);
  uint32_t idx[8];
  corner_rows(lv, l, cl, idx);
  float u[8][F];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int f = 0; f < F; ++f) u[k][f] = 1.0f;
  add_rows<F, false>(grad, rows, idx, u);
}


}  // namespace
#endif  // SST_HASH_BASELINE_ONLY

extern "C" {

// The first design's entry points, as the library's take their arguments
// (F = 2 only; 8-byte aligned rows).
int sst_baseline_hash_encode_fwd(const void* x, const void* table, void* out, void* jac,
                                 long long n, long long rows, int F, int L, const int* res,
                                 const uint32_t* offsets, const int* dense, int log2_size,
                                 int smoothstep, void* stream) {
  namespace b = baseline;
  b::Levels lv;
  if (!b::args_ok(n, rows, F, L) || !b::make_levels(L, res, offsets, dense, log2_size, &lv)
      || !out)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  float* jp = static_cast<float*>(jac);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = b::grid_for(n, L);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  if (jp)
    b::hash_fwd_kernel<true><<<grid, b::kThreads, 0, s>>>(xp, tp, op, jp, n, r, lv, sm);
  else
    b::hash_fwd_kernel<false><<<grid, b::kThreads, 0, s>>>(xp, tp, op, jp, n, r, lv, sm);
  return (int)cudaGetLastError();
}

int sst_baseline_hash_encode_bwd(const void* x, const void* g_out, const void* g_jac, void* grad,
                                 long long n, long long rows, int F, int L, const int* res,
                                 const uint32_t* offsets, const int* dense, int log2_size,
                                 int smoothstep, void* stream) {
  namespace b = baseline;
  b::Levels lv;
  if (!b::args_ok(n, rows, F, L) || !b::make_levels(L, res, offsets, dense, log2_size, &lv)
      || !grad || (!g_out && !g_jac))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* go = static_cast<const float*>(g_out);
  const float* gj = static_cast<const float*>(g_jac);
  float* gp = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = b::grid_for(n, L);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  if (go && gj)
    b::hash_bwd_kernel<true, true><<<grid, b::kThreads, 0, s>>>(xp, go, gj, gp, n, r, lv, sm);
  else if (go)
    b::hash_bwd_kernel<true, false><<<grid, b::kThreads, 0, s>>>(xp, go, gj, gp, n, r, lv, sm);
  else
    b::hash_bwd_kernel<false, true><<<grid, b::kThreads, 0, s>>>(xp, go, gj, gp, n, r, lv, sm);
  return (int)cudaGetLastError();
}

#ifndef SST_HASH_BASELINE_ONLY
// A forward design of design_fwd's list (variant), and a backward design of
// the library's (pair: paired x-corner reductions at F = 2; agg: the warp
// aggregation), with the library's arguments.
int sst_design_hash_fwd(const void* x, const void* table, void* out, void* jac, long long n,
                        long long rows, int F, int L, const int* res, const uint32_t* offsets,
                        const int* dense, int log2_size, int smoothstep, void* stream, int variant) {
  Levels lv;
  if (!args_ok(n, rows, F, L) || !make_levels(L, res, offsets, dense, log2_size, &lv) || !out)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  float* jp = static_cast<float*>(jac);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  if (F == 4)
    return jp ? design_fwd<4, true>(xp, tp, op, jp, n, r, lv, sm, s, variant)
              : design_fwd<4, false>(xp, tp, op, jp, n, r, lv, sm, s, variant);
  return jp ? design_fwd<2, true>(xp, tp, op, jp, n, r, lv, sm, s, variant)
            : design_fwd<2, false>(xp, tp, op, jp, n, r, lv, sm, s, variant);
}

int sst_design_hash_bwd(const void* x, const void* g_out, const void* g_jac, void* grad,
                        long long n, long long rows, int F, int L, const int* res,
                        const uint32_t* offsets, const int* dense, int log2_size, int smoothstep,
                        void* stream, int pair, int agg) {
  Levels lv;
  if (!args_ok(n, rows, F, L) || !make_levels(L, res, offsets, dense, log2_size, &lv) || !grad
      || (!g_out && !g_jac) || (pair && F != 2))
    return (int)cudaErrorInvalidValue;
  const TilePlan plan = tile_plan(L);
  const float* xp = static_cast<const float*>(x);
  const float* go = static_cast<const float*>(g_out);
  const float* gj = static_cast<const float*>(g_jac);
  float* gp = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  if (F == 4)
    return agg ? bwd_launch<4, false, true>(xp, go, gj, gp, n, r, lv, sm, s, plan)
               : bwd_launch<4, false, false>(xp, go, gj, gp, n, r, lv, sm, s, plan);
  if (pair)
    return agg ? bwd_launch<2, true, true>(xp, go, gj, gp, n, r, lv, sm, s, plan)
               : bwd_launch<2, true, false>(xp, go, gj, gp, n, r, lv, sm, s, plan);
  return agg ? bwd_launch<2, false, true>(xp, go, gj, gp, n, r, lv, sm, s, plan)
             : bwd_launch<2, false, false>(xp, go, gj, gp, n, r, lv, sm, s, plan);
}


// floor: 0 the forward's table reads, 1 its streams, 2 the backward's
// reductions (into grad, zeroed by the caller); out / jac / grad as the
// library's entry points take them.
int sst_design_hash_floor(const void* x, const void* table, void* out, void* jac, long long n,
                          long long rows, int F, int L, const int* res, const uint32_t* offsets,
                          const int* dense, int log2_size, int smoothstep, void* stream, int floor) {
  Levels lv;
  if (!args_ok(n, rows, F, L) || !make_levels(L, res, offsets, dense, log2_size, &lv) || !out)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  float* jp = static_cast<float*>(jac);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  const unsigned grid = (unsigned)((n * L + kRowThreads - 1) / kRowThreads);
  if (floor == 0) {
    if (F == 2) floor_reads_kernel<2><<<grid, kRowThreads, 0, s>>>(xp, tp, op, n, r, lv, sm);
    else floor_reads_kernel<4><<<grid, kRowThreads, 0, s>>>(xp, tp, op, n, r, lv, sm);
  } else if (floor == 1) {
    if (F == 2 && jp) floor_streams_kernel<2, true><<<grid, kRowThreads, 0, s>>>(xp, op, jp, n, lv);
    else if (F == 2) floor_streams_kernel<2, false><<<grid, kRowThreads, 0, s>>>(xp, op, jp, n, lv);
    else if (jp) floor_streams_kernel<4, true><<<grid, kRowThreads, 0, s>>>(xp, op, jp, n, lv);
    else floor_streams_kernel<4, false><<<grid, kRowThreads, 0, s>>>(xp, op, jp, n, lv);
  } else {
    if (F == 2) floor_reductions_kernel<2><<<grid, kRowThreads, 0, s>>>(xp, op, n, r, lv, sm);
    else floor_reductions_kernel<4><<<grid, kRowThreads, 0, s>>>(xp, op, n, r, lv, sm);
  }
  return (int)cudaGetLastError();
}

#endif  // SST_HASH_BASELINE_ONLY

}  // extern "C"
