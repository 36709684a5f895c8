// Multi-resolution hash-grid encode for Hopper (sm_90a): the forward with its
// analytic jacobian, and the table gradient.
//
// Replaces XLA code of the JAX package (there is no Pallas kernel for it):
// HashEncoding.__call__ in sdfstudio_tpu/ops/encodings.py:349-434 (corner
// indices :328-370, smoothstep weights, the gather, the trilinear blend and
// the jacobian from exclusive products) and the custom VJP of table_gather
// (:206-242), whose backward scatters the corner cotangents into an f32
// table gradient (a sort and a cumsum on the TPU, ops/scatter.py).
//
//   sst_hash_encode_fwd: x [N, 3] f32 in [0, 1], table [R, F] f32 ->
//       out [N, L*F] and, optionally, jac [N, L*F, 3] (F minor, then axis);
//   sst_hash_encode_bwd: x, g_out [N, L*F] and/or g_jac [N, L*F, 3] ->
//       grad [R, F] += the corner cotangents (grad zeroed by the caller).
//
// The function, as JAX computes it: level l scales x by its resolution r_l,
// takes floor and offset in f32, and forms the 8 corners (bit b of corner c
// takes the ceiling on axis b) in uint32 arithmetic, which wraps exactly as
// JAX's uint32 does. A level whose (r_l+1)^3 fits the 2^log2 rows of a
// level is indexed densely (x + y s + z s^2, s = r_l + 1), not reduced mod
// its size: at x = 1.0 the far corner reads the next level's rows, with
// weight 0. The others are hashed (x * 1 ^ y * 2654435761 ^ z * 805459861)
// mod 2^log2. Each level's rows start at its offset. A row at or past R
// reads as NaN, jnp.take's fill mode, and its gradient is dropped. The
// scaled position and the offset are rounded as XLA rounds them (__fmul_rn,
// __fsub_rn: no contraction into an FMA), so the corners are JAX's exactly.
//
// What bounds them on an H100: bytes, by far. The forward reads 12 bytes of
// x and 8 random rows of 4F bytes per point and level and writes 4F bytes
// of out (and 12F of jac); the backward reads x and the cotangents and adds
// 8 rows per point and level. Both do a few dozen flops per row. What keeps
// them from the bytes bound is the latency of the random row reads (and of
// the atomics), served by L2 for tables that fit its 50 MB (the proposal
// grids, 2.2 and 3.5 MB) and mostly by HBM for the SDF grid (48.8 MB), and
// in the backward the serialisation of atomics on one address: the coarse
// levels hold a few thousand rows that every sample of a ray batch hits.
// The design, simple first: one thread per (point, level), neighbouring
// threads on neighbouring levels of one point, so each thread's out / jac
// slice lies next to its neighbours' and every store of the warp is
// contiguous. A thread issues its 8 row loads (one float2 each, F = 2,
// through the read-only path under the default L2 policy) before it blends
// any.
// x, out, jac and the cotangents are read or written once and go
// evict-first (ld/st.global.cs), as the row gathers' streams do. The
// backward adds each corner's update with one float2 atomicAdd (sm_90),
// whose return value is unused: a reduction (REDG.E.ADD.F32x2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

// x [n, 3], table [rows, F], out [n, L*F], jac [n, L*F, 3] or null: contiguous
// f32 device pointers, 8-byte aligned but x; F must be 2. res / offsets /
// dense: L host ints per level. Enqueue on `stream`; return
// cudaGetLastError().
int sst_hash_encode_fwd(const void* x, const void* table, void* out, void* jac, long long n,
                        long long rows, int F, int L, const int* res, const uint32_t* offsets,
                        const int* dense, int log2_size, int smoothstep, void* stream) {
  Levels lv;
  if (!args_ok(n, rows, F, L) || !make_levels(L, res, offsets, dense, log2_size, &lv) || !out)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  float* jp = static_cast<float*>(jac);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n, L);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  if (jp)
    hash_fwd_kernel<true><<<grid, kThreads, 0, s>>>(xp, tp, op, jp, n, r, lv, sm);
  else
    hash_fwd_kernel<false><<<grid, kThreads, 0, s>>>(xp, tp, op, jp, n, r, lv, sm);
  return (int)cudaGetLastError();
}

// x [n, 3], g_out [n, L*F] and / or g_jac [n, L*F, 3] (either may be null,
// not both), grad [rows, F] zeroed by the caller: as sst_hash_encode_fwd.
int sst_hash_encode_bwd(const void* x, const void* g_out, const void* g_jac, void* grad,
                        long long n, long long rows, int F, int L, const int* res,
                        const uint32_t* offsets, const int* dense, int log2_size, int smoothstep,
                        void* stream) {
  Levels lv;
  if (!args_ok(n, rows, F, L) || !make_levels(L, res, offsets, dense, log2_size, &lv) || !grad
      || (!g_out && !g_jac))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* go = static_cast<const float*>(g_out);
  const float* gj = static_cast<const float*>(g_jac);
  float* gp = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n, L);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  if (go && gj)
    hash_bwd_kernel<true, true><<<grid, kThreads, 0, s>>>(xp, go, gj, gp, n, r, lv, sm);
  else if (go)
    hash_bwd_kernel<true, false><<<grid, kThreads, 0, s>>>(xp, go, gj, gp, n, r, lv, sm);
  else
    hash_bwd_kernel<false, true><<<grid, kThreads, 0, s>>>(xp, go, gj, gp, n, r, lv, sm);
  return (int)cudaGetLastError();
}

}  // extern "C"
