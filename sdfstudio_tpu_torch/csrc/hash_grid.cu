// Multi-resolution hash-grid encode for Hopper (sm_90a): the forward with its
// analytic jacobian, and the table gradient (by atomics, or deterministic).
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
//       grad [R, F] += the corner cotangents (grad zeroed by the caller);
//   sst_hash_corner_rows + sst_hash_segment_sum: the same table gradient in
//       an order that does not change from run to run: every corner's row
//       and update written out, the rows sorted stably by the caller
//       (torch.sort, which gives the order only), then each row's run
//       summed in an order fixed by the sorted rows and written once.
// F is 2, 4 or 8 features a level.
//
// The function, as JAX computes it: level l scales x by its resolution r_l,
// takes floor and offset in f32, and forms the 8 corners (bit b of corner c
// takes the ceiling on axis b) in uint32 arithmetic, which wraps exactly as
// JAX's uint32 does. A level whose (r_l+1)^3 fits the 2^log2 rows of a
// level is indexed densely (x + y s + z s^2, s = r_l + 1), not reduced mod
// its size: at x = 1.0 the far corner reads the next level's rows, with
// weight 0. The others are hashed (x * 1 ^ y * 2654435761 ^ z * 805459861)
// mod 2^log2. Each level's rows start at its offset. JAX adds the offset in
// int32 and jnp.take reads a negative index from the table's end: a corner
// at -1 (x just below 0, a tap of a numerical gradient) on a dense level
// wraps to a large uint32, which reads row i + R here as there. A row that
// is still at or past R reads as NaN, jnp.take's fill mode, and its
// gradient is dropped. The
// scaled position and the offset are rounded as XLA rounds them (__fmul_rn,
// __fsub_rn: no contraction into an FMA), so the corners are JAX's exactly.
//
// What bounds them on an H100: bytes, by far. The forward reads 12 bytes of
// x and 8 random rows of 4F bytes per point and level and writes 4F bytes
// of out (and 12F of jac); the backward reads x and the cotangents and adds
// 8 rows per point and level. Both do a few dozen flops per row. A random
// row of 8 or 16 bytes costs a whole 32-byte sector at L2, so what keeps
// them from the bytes bound is the rate at which L2 serves random sectors
// (and HBM the misses: the SDF grid's 48.8 MB table does not stay in the 50
// MB L2 beside the streams) and, in the backward, atomics on one address:
// the coarse levels hold a few thousand rows that every sample of a batch
// hits.
//
// The design, each move measured on a real step's captured samples
// (scripts/benchmarking/hash_grid_designs.py, PERF.md). A step's points come
// in ray order, 48 to 256 samples a ray, so neighbouring points share the
// cells of the coarse levels.
//   * The forward keeps the first design's mapping: a thread per (point,
//     level), neighbouring threads on neighbouring levels of one point, so
//     a warp's out and jac slices are contiguous and it stores them
//     directly; its 8 row loads are in flight before any is blended.
//     Level-major tiles staged in shared memory, paired 16-byte x-corner
//     loads, two levels a thread, weights rebuilt after the loads, register
//     caps and reading the hashed levels past L1 were each measured no
//     faster: the forward takes the time of its table reads (a 32-byte L2
//     sector for a row of 8 or 16 bytes; the coarse levels' shared rows
//     already hit L1) plus its streams, each measured alone.
//   * The backward, level-major tiles: a block takes a tile of 32 G points
//     (G = 8 / gcd(8, L)) and its 8 warps take its (group, level) items in
//     turn; a warp is 32 consecutive points at one level, x is read once a
//     tile, and the cotangents, [N, L*F] and [N, L*F, 3], are read as whole
//     16-byte runs into shared memory (a point's row at an odd stride of
//     float2s, so the warp's 8-byte reads meet no bank conflict).
//   * Warp aggregation in the backward: where some lane shares its cell with
//     the lane before it (the test is warp-uniform), a segmented suffix sum
//     over the lanes (5 shuffle steps) leaves each run of lanes in one cell
//     with one head that holds the run's sum, and only heads add: a step's
//     coarse levels take a fraction of the atomics.
//   * Paired x-corners in the backward (F = 2): corners c and c+1 differ on
//     x only. Their rows are neighbours in a dense level (i, i+1), and for
//     an even cx in a hashed level (the prime on x is 1: i, i ^ 1). Where
//     the two rows form one 16-byte aligned pair, one vector reduction
//     (atomicAdd of a float4, RED.E.ADD.F32x4 on sm_90) adds both: the
//     backward is held by the rate of the atomic units, counted in
//     operations, not bytes.
//   * F = 8 (Neuralangelo's grid): a row is 32 bytes, exactly one L2 sector,
//     read as two float4 loads and added as two float4 reductions. There is
//     no pairing to do: the widest f32 reduction is 16 bytes, and a row
//     already fills two. Out and jac go as float4 stores. Row offsets are
//     formed in 64 bits (2 * (size_t)row float4s): the 55.9M-row table of
//     16 levels at 2^22 takes offsets of 1.79e9 bytes, and a product in 32
//     bits would pass 2^31 at twice that.
// The table goes through the read-only path under the default L2 policy;
// x, the cotangents, out and jac are read or written once and go
// evict-first (ld/st.global.cs), as the row gathers' streams do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kTileWarps = 8;  // the backward's tile block
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kRowThreads = 256;  // a thread per (point, level): the forward, the corner rows
constexpr int kStaticSmem = 48 * 1024;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int num;
  uint32_t table_mask;  // 2^log2 - 1
  uint32_t dense;       // bit l: level l is indexed densely
  float res[kMaxLevels];
  uint32_t stride[kMaxLevels];  // res + 1
  uint32_t offset[kMaxLevels];
};

// The tile of one block: G groups of 32 points; a point's out row is U
// float2s, kept at stride Su (odd) in shared memory, and its jac row Uj at
// stride Sj. The block's warps take its G L (group, level) items in turn.
struct TileShape {
  int G, P, U, Su, Uj, Sj;
};

__host__ __device__ inline TileShape tile_shape(int L, int F, int G) {
  TileShape t;
  t.G = G;
  t.P = 32 * t.G;
  t.U = L * F / 2;
  t.Su = t.U | 1;
  t.Uj = 3 * L * F / 2;
  t.Sj = t.Uj | 1;
  return t;
}

// shared bytes of a tile: x, then the out (or g_out) rows, then the jac (or g_jac) rows
inline int tile_smem(const TileShape& t, bool out, bool jac) {
  return 4 * (3 * t.P + (out ? 2 * t.P * t.Su : 0) + (jac ? 2 * t.P * t.Sj : 0));
}

__device__ __forceinline__ float2 nan2() {
  const float v = __int_as_float(0x7fc00000);
  return make_float2(v, v);
}

template <int F> struct Row;
template <> struct Row<2> {
  using T = float2;
  static __device__ __forceinline__ void get(const T& r, float (&v)[2]) { v[0] = r.x; v[1] = r.y; }
  static __device__ __forceinline__ T nan() { return nan2(); }
};
template <> struct Row<4> {
  using T = float4;
  static __device__ __forceinline__ void get(const T& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ T nan() {
    const float v = __int_as_float(0x7fc00000);
    return make_float4(v, v, v, v);
  }
};
// a 32-byte row: one L2 sector, two float4 halves
template <> struct Row<8> {
  struct T {
    float4 a, b;
  };
  static __device__ __forceinline__ void get(const T& r, float (&v)[8]) {
    v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
    v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
  }
  static __device__ __forceinline__ T nan() { return T{Row<4>::nan(), Row<4>::nan()}; }
};

// row i of an [R, F] f32 array through the read-only path; the offset in 64 bits
template <int F>
__device__ __forceinline__ typename Row<F>::T load_row(const float* __restrict__ a, size_t i) {
  if constexpr (F == 8) {
    const float4* p = reinterpret_cast<const float4*>(a) + 2 * i;
    return typename Row<8>::T{__ldg(p), __ldg(p + 1)};
  } else {
    return __ldg(reinterpret_cast<const typename Row<F>::T*>(a) + i);
  }
}

// The table row of a corner's uint32 index: JAX's int32 index, negative
// ones read from the table's end (jnp.take); at or past `rows` it reads NaN.
__device__ __forceinline__ uint32_t table_row(uint32_t i, uint32_t rows) {
  return i < rows ? i : i + rows;
}

// The cell of x at level l (encodings.py:328-430): its integer corner c,
// per axis the weights of the floor and ceiling corners and the
// derivative of the ceiling's, and the level's resolution. A corner's
// weight and its derivative follow from these in a few products, so a
// kernel that holds rows in flight rebuilds them after the loads instead
// of keeping 32 values live across them.
struct Cell {
  uint32_t c[3];
  float cw0[3], cw1[3], dv[3], r;
};

__device__ __forceinline__ Cell make_cell(const Levels& lv, int l, bool smooth,
                                          const float (&x)[3]) {
  Cell cl;
  cl.r = lv.res[l];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(x[a], cl.r);
    const float fl = floorf(s);
    const float o = __fsub_rn(s, fl);
    cl.c[a] = (uint32_t)(int)fl;
    if (smooth) {
      cl.cw1[a] = __fmul_rn(__fmul_rn(o, o), __fsub_rn(3.0f, __fmul_rn(2.0f, o)));
      cl.dv[a] = __fmul_rn(__fmul_rn(6.0f, o), __fsub_rn(1.0f, o));
    } else {
      cl.cw1[a] = o;
      cl.dv[a] = 1.0f;
    }
    cl.cw0[a] = __fsub_rn(1.0f, cl.cw1[a]);
  }
  return cl;
}

// The 8 corner rows: bit b of corner k takes the ceiling on axis b.
__device__ __forceinline__ void corner_rows(const Levels& lv, int l, const Cell& cl,
                                            uint32_t (&idx)[8]) {
  const bool dense = (lv.dense >> l) & 1u;
  const uint32_t st = lv.stride[l];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t cx = cl.c[0] + (k & 1), cy = cl.c[1] + ((k >> 1) & 1),
                   cz = cl.c[2] + ((k >> 2) & 1);
    const uint32_t i = dense ? cx + cy * st + cz * st * st
                             : ((cx ^ (cy * kPrime1) ^ (cz * kPrime2)) & lv.table_mask);
    idx[k] = i + lv.offset[l];
  }
}

// corner k's weight, the product of its axes' weights
__device__ __forceinline__ float weight(const Cell& cl, int k) {
  return __fmul_rn(__fmul_rn((k & 1) ? cl.cw1[0] : cl.cw0[0], (k & 2) ? cl.cw1[1] : cl.cw0[1]),
                   (k & 4) ? cl.cw1[2] : cl.cw0[2]);
}

// d weight_k / dx_a = sign * dsmooth_a * prod_{b != a} cw_b * res
__device__ __forceinline__ float dweight(const Cell& cl, int k, int a) {
  const float f0 = (k & 1) ? cl.cw1[0] : cl.cw0[0];
  const float f1 = (k & 2) ? cl.cw1[1] : cl.cw0[1];
  const float f2 = (k & 4) ? cl.cw1[2] : cl.cw0[2];
  const float d = ((k >> a) & 1) ? cl.dv[a] : -cl.dv[a];
  const float e = a == 0 ? __fmul_rn(f1, f2) : a == 1 ? __fmul_rn(f0, f2) : __fmul_rn(f0, f1);
  return __fmul_rn(__fmul_rn(d, e), cl.r);
}

// The cell, its corner rows, their weights and, with kJac, d weight / dx.
template <bool kJac>
__device__ __forceinline__ void cell(const Levels& lv, int l, bool smooth, const float (&x)[3],
                                     uint32_t (&c)[3], uint32_t (&idx)[8], float (&w)[8],
                                     float (&dw)[8][3]) {
  const Cell cl = make_cell(lv, l, smooth, x);
  corner_rows(lv, l, cl, idx);
#pragma unroll
  for (int a = 0; a < 3; ++a) c[a] = cl.c[a];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = weight(cl, k);
    if constexpr (kJac)
#pragma unroll
      for (int a = 0; a < 3; ++a) dw[k][a] = dweight(cl, k, a);
  }
}

// The 8 corner rows of a cell, every load issued before any is used; a
// negative index reads from the table's end, a row still at or past the
// table reads as NaN.
template <int F>
__device__ __forceinline__ void load_rows(const float* __restrict__ table, uint32_t rows,
                                          const uint32_t (&idx)[8], float (&v)[8][F]) {
  using R = Row<F>;
  typename R::T rv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t j = table_row(idx[k], rows);
    rv[k] = j < rows ? load_row<F>(table, j) : R::nan();
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) R::get(rv[k], v[k]);
}

// Add each corner's update to its row (a negative index from the table's
// end, rows still past the table dropped). With kPair (F = 2) an aligned pair
// of x-neighbours takes one float4 reduction; an F = 8 row takes two.
template <int F, bool kPair>
__device__ __forceinline__ void add_rows(float* __restrict__ grad, uint32_t rows,
                                         const uint32_t (&idx)[8], const float (&u)[8][F]) {
  if constexpr (F == 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t j = table_row(idx[k], rows);
      if (j < rows) {
        float4* p = reinterpret_cast<float4*>(grad) + 2 * (size_t)j;
        atomicAdd(p, make_float4(u[k][0], u[k][1], u[k][2], u[k][3]));
        atomicAdd(p + 1, make_float4(u[k][4], u[k][5], u[k][6], u[k][7]));
      }
    }
  } else if constexpr (F == 4) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t j = table_row(idx[k], rows);
      if (j < rows)
        atomicAdd(reinterpret_cast<float4*>(grad) + j,
                  make_float4(u[k][0], u[k][1], u[k][2], u[k][3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const uint32_t a = table_row(idx[k], rows), b = table_row(idx[k + 1], rows);
      if (kPair && (a ^ b) == 1u && (a | 1u) < rows) {
        const float4 v = (a & 1u) ? make_float4(u[k + 1][0], u[k + 1][1], u[k][0], u[k][1])
                                  : make_float4(u[k][0], u[k][1], u[k + 1][0], u[k + 1][1]);
        atomicAdd(reinterpret_cast<float4*>(grad) + (a >> 1), v);
      } else {
        if (a < rows) atomicAdd(reinterpret_cast<float2*>(grad) + a, make_float2(u[k][0], u[k][1]));
        if (b < rows)
          atomicAdd(reinterpret_cast<float2*>(grad) + b, make_float2(u[k + 1][0], u[k + 1][1]));
      }
    }
  }
}

// Copy np points' rows of U float2s from a global run (16-byte aligned) into
// shared memory at row stride S: 16-byte evict-first loads, float2 stores.
__device__ __forceinline__ void tile_load(float2* s, int S, int U, int np, const float* g) {
  const int total = np * U;
  for (int q = 2 * threadIdx.x; q < total; q += 2 * blockDim.x) {
    const int p = q / U, c = q - p * U;
    if (q + 1 < total) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(g) + (q >> 1));
      const int p1 = (q + 1) / U, c1 = q + 1 - p1 * U;
      s[p * S + c] = make_float2(v.x, v.y);
      s[p1 * S + c1] = make_float2(v.z, v.w);
    } else {
      s[p * S + c] = __ldcs(reinterpret_cast<const float2*>(g) + q);
    }
  }
}

__device__ __forceinline__ void tile_load_x(float* sx, int np, const float* __restrict__ x) {
  for (int i = threadIdx.x; i < 3 * np; i += blockDim.x) sx[i] = __ldcs(x + i);
}

// N floats to a run of global memory, evict-first: float4 stores at F = 8
// (every slice 32-byte aligned), float2 stores below (a point-level slice
// of F = 2 is only 8-byte aligned)
template <int F, int N>
__device__ __forceinline__ void store_cs(float* __restrict__ dst, const float (&v)[N]) {
  if constexpr (F == 8) {
#pragma unroll
    for (int h = 0; h < N / 4; ++h)
      __stcs(reinterpret_cast<float4*>(dst) + h,
             make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]));
  } else {
#pragma unroll
    for (int h = 0; h < N / 2; ++h)
      __stcs(reinterpret_cast<float2*>(dst) + h, make_float2(v[2 * h], v[2 * h + 1]));
  }
}

// The forward: a thread per (point, level), neighbouring threads on
// neighbouring levels of one point, so a warp's out and jac slices are
// contiguous and it stores them directly.
template <int F, bool kJac>
__global__ void __launch_bounds__(kRowThreads)
hash_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                float* __restrict__ out, float* __restrict__ jac, long long n, uint32_t rows,
                Levels lv, bool smooth) {
  const long long t = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const int l = (int)(t - p * lv.num);
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);  // shared by the point's L threads
  uint32_t c[3], idx[8];
  float w[8], dw[8][3], v[8][F], acc[F], jv[3 * F];
  cell<kJac>(lv, l, smooth, xp, c, idx, w, dw);
  load_rows<F>(table, rows, idx, v);
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
  store_cs<F>(out + t * F, acc);
  if constexpr (kJac) store_cs<F>(jac + t * 3 * F, jv);
}

// The backward over tiles (see the design note above).
template <int F, bool kOut, bool kJac, bool kPair, bool kAgg>
__global__ void __launch_bounds__(kTileThreads)
hash_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g_out,
                const float* __restrict__ g_jac, float* __restrict__ grad, long long n,
                uint32_t rows, Levels lv, bool smooth, int G) {
  extern __shared__ __align__(16) float smem[];
  const TileShape ts = tile_shape(lv.num, F, G);
  const long long p0 = (long long)blockIdx.x * ts.P;
  const int np = (int)(n - p0 < ts.P ? n - p0 : ts.P);
  float* sx = smem;
  float2* so = reinterpret_cast<float2*>(smem + 3 * ts.P);
  float2* sj = so + (kOut ? ts.P * ts.Su : 0);
  tile_load_x(sx, np, x + 3 * p0);
  if constexpr (kOut) tile_load(so, ts.Su, ts.U, np, g_out + p0 * 2 * ts.U);
  if constexpr (kJac) tile_load(sj, ts.Sj, ts.Uj, np, g_jac + p0 * 2 * ts.Uj);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // every lane stays through the item loop: the aggregation shuffles over the warp
  for (int it = warp; it < ts.G * lv.num; it += (int)(blockDim.x >> 5)) {
    const int g = it % ts.G, l = it / ts.G, pt = 32 * g + lane;
    const bool valid = pt < np;
    float xp[3] = {0.0f, 0.0f, 0.0f};
    if (valid) {
      xp[0] = sx[3 * pt]; xp[1] = sx[3 * pt + 1]; xp[2] = sx[3 * pt + 2];
    }
    uint32_t c[3], idx[8];
    float w[8], dw[8][3];
    cell<kJac>(lv, l, smooth, xp, c, idx, w, dw);
    float go[F], gj[3 * F];
#pragma unroll
    for (int h = 0; h < F / 2; ++h) {
      const float2 q =
          (kOut && valid) ? so[pt * ts.Su + l * (F / 2) + h] : make_float2(0.0f, 0.0f);
      go[2 * h] = q.x;
      go[2 * h + 1] = q.y;
    }
#pragma unroll
    for (int h = 0; h < 3 * F / 2; ++h) {
      const float2 q =
          (kJac && valid) ? sj[pt * ts.Sj + l * (3 * F / 2) + h] : make_float2(0.0f, 0.0f);
      gj[2 * h] = q.x;
      gj[2 * h + 1] = q.y;
    }
    float u[8][F];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float v = 0.0f;
        if constexpr (kOut) v = w[k] * go[f];
        if constexpr (kJac)
          v += dw[k][0] * gj[3 * f] + dw[k][1] * gj[3 * f + 1] + dw[k][2] * gj[3 * f + 2];
        u[k][f] = v;
      }
    bool head = valid;
    if constexpr (kAgg) {
      const uint32_t q0 = __shfl_up_sync(kFull, c[0], 1), q1 = __shfl_up_sync(kFull, c[1], 1),
                     q2 = __shfl_up_sync(kFull, c[2], 1);
      const int vp = __shfl_up_sync(kFull, (int)valid, 1);
      const bool same = valid && vp && lane > 0 && q0 == c[0] && q1 == c[1] && q2 == c[2];
      if (__any_sync(kFull, same)) {  // warp-uniform: some run of lanes shares a cell
        const bool next_same = __shfl_down_sync(kFull, (int)same, 1) != 0;
        const unsigned tails = __ballot_sync(kFull, lane == 31 || !next_same);
        const int end = __ffs(tails & (kFull << lane)) - 1;  // the last lane of my run
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
#pragma unroll
          for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int f = 0; f < F; ++f) {
              const float t = __shfl_down_sync(kFull, u[k][f], off);
              if (lane + off <= end) u[k][f] += t;
            }
        head = valid && !same;
      }
    }
    if (head) add_rows<F, kPair>(grad, rows, idx, u);
  }
}

// ---- the deterministic table gradient -------------------------------------

// One thread per (point, level), neighbouring threads on neighbouring
// levels of one point: the 8 corners' rows (R for a row past the table, so
// that it sorts after every row) and updates, at entry (p L + l) 8 + k.
template <int F, bool kOut, bool kJac>
__global__ void __launch_bounds__(kRowThreads)
hash_corner_rows_kernel(const float* __restrict__ x, const float* __restrict__ g_out,
                        const float* __restrict__ g_jac, int* __restrict__ keys,
                        float* __restrict__ upd, long long n, uint32_t rows, Levels lv,
                        bool smooth) {
  const long long t = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (t >= n * lv.num) return;
  const long long p = t / lv.num;
  const int l = (int)(t - p * lv.num);
  float xp[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = __ldg(x + 3 * p + a);
  uint32_t c[3], idx[8];
  float w[8], dw[8][3];
  cell<kJac>(lv, l, smooth, xp, c, idx, w, dw);
  float go[F], gj[3 * F];
#pragma unroll
  for (int f = 0; f < F; ++f) go[f] = kOut ? __ldcs(g_out + t * F + f) : 0.0f;
#pragma unroll
  for (int e = 0; e < 3 * F; ++e) gj[e] = kJac ? __ldcs(g_jac + t * 3 * F + e) : 0.0f;
  int kv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t j = table_row(idx[k], rows);
    kv[k] = j < rows ? (int)j : (int)rows;
  }
  int4* kp = reinterpret_cast<int4*>(keys + t * 8);
  __stcs(kp, make_int4(kv[0], kv[1], kv[2], kv[3]));
  __stcs(kp + 1, make_int4(kv[4], kv[5], kv[6], kv[7]));
  float* up = upd + t * 8 * F;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float s = 0.0f;
      if constexpr (kOut) s = w[k] * go[f];
      if constexpr (kJac)
        s += dw[k][0] * gj[3 * f] + dw[k][1] * gj[3 * f + 1] + dw[k][2] * gj[3 * f + 2];
      v[f] = s;
    }
    store_cs<F>(up + k * F, v);
  }
}

// keys [m] sorted stably, perm [m] the entry each sorted key came from.
// The first thread of each row's run of fewer than kLongRun entries sums
// the run's updates in sorted (corner) order, four loads in flight at a
// time, and writes the row. A longer run (a coarse level's row, which a
// step's samples hit thousands of times) is summed by its warp together,
// four chunks of 32 entries in flight: lane i adds entries i, i + 32, ...
// in order, then a fixed butterfly of shuffles adds the lanes. Either
// order is fixed by the sorted keys alone, so the result repeats bit for
// bit. The caller zeroes grad, so untouched
// rows stay 0; keys of R (past the table) are dropped.
constexpr int kLongRun = 32;

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ grad, int row, const float (&v)[F]) {
  if constexpr (F == 2) {
    reinterpret_cast<float2*>(grad)[row] = make_float2(v[0], v[1]);
  } else if constexpr (F == 4) {
    reinterpret_cast<float4*>(grad)[row] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    float4* p = reinterpret_cast<float4*>(grad) + 2 * (size_t)row;
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <int F>
__global__ void __launch_bounds__(kRowThreads)
hash_segment_sum_kernel(const int* __restrict__ keys, const long long* __restrict__ perm,
                        const float* __restrict__ upd, float* __restrict__ grad, long long m,
                        int rows) {
  using R = Row<F>;
  const long long j = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // every lane stays: the warp sums its long runs together
  int key = rows;
  bool head = false, long_run = false;
  if (j < m) {
    key = __ldg(keys + j);
    head = key < rows && (j == 0 || __ldg(keys + j - 1) != key);
    long_run = head && j + kLongRun - 1 < m && __ldg(keys + j + kLongRun - 1) == key;
  }
  if (head && !long_run) {
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    for (long long e = j;; e += 4) {
      bool in[4];
      typename R::T v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) in[q] = e + q < m && __ldg(keys + e + q) == key;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = in[q] ? load_row<F>(upd, (size_t)__ldg(perm + e + q)) : typename R::T{};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float r[F];
        R::get(v[q], r);
        if (in[q])
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] += r[f];
      }
      if (!in[3]) break;
    }
    store_row<F>(grad, key, acc);
  }
  for (unsigned longs = __ballot_sync(kFull, long_run); longs; longs &= longs - 1) {
    const int src = __ffs(longs) - 1;
    const long long h = __shfl_sync(kFull, j, src);
    const int k = __shfl_sync(kFull, key, src);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    for (long long e = h;; e += 4 * 32) {  // four chunks of 32 entries in flight
      bool in[4];
      typename R::T v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long q = e + 32 * c + lane;
        in[c] = q < m && __ldg(keys + q) == k;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = in[c] ? load_row<F>(upd, (size_t)__ldg(perm + e + 32 * c + lane))
                     : typename R::T{};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float r[F];
        R::get(v[c], r);
        if (in[c])
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] += r[f];
      }
      if (!__shfl_sync(kFull, (int)in[3], 31)) break;  // the run goes on past these chunks
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += __shfl_xor_sync(kFull, acc[f], off);
    if (lane == 0) store_row<F>(grad, k, acc);
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

bool args_ok(long long n, long long rows, int F, int L) {
  return n > 0 && rows > 0 && rows <= 0x7fffffffLL && (F == 2 || F == 4 || F == 8)
         && n * L <= (long long)INT32_MAX * kRowThreads;  // the grids' x dimension
}

// The tile of a block and its warps: 8 warps over 8 / gcd(8, L) groups of 32
// points, each warp taking G L / 8 (group, level) items in turn.
struct TilePlan {
  int G, warps;
};

inline TilePlan tile_plan(int L) {
  const int gcd8 = (L & 7) == 0 ? 8 : (L & 3) == 0 ? 4 : (L & 1) == 0 ? 2 : 1;
  return {8 / gcd8, kTileWarps};
}

// Launch a tile kernel with `smem` bytes of dynamic shared memory, opting
// in above the static 48 KB.
template <typename K, typename... A>
int launch_tiles(K kern, long long n, const TilePlan& tp, int smem, cudaStream_t s, A... args) {
  if (smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int P = 32 * tp.G;
  kern<<<(unsigned)((n + P - 1) / P), 32 * tp.warps, smem, s>>>(args..., tp.G);
  return (int)cudaGetLastError();
}

template <int F>
int fwd_launch(const float* x, const float* table, float* out, float* jac, long long n,
               uint32_t rows, const Levels& lv, bool smooth, cudaStream_t s) {
  const unsigned grid = (unsigned)((n * lv.num + kRowThreads - 1) / kRowThreads);
  if (jac)
    hash_fwd_kernel<F, true><<<grid, kRowThreads, 0, s>>>(x, table, out, jac, n, rows, lv, smooth);
  else
    hash_fwd_kernel<F, false><<<grid, kRowThreads, 0, s>>>(x, table, out, jac, n, rows, lv, smooth);
  return (int)cudaGetLastError();
}

template <int F, bool kPair, bool kAgg>
int bwd_launch(const float* x, const float* go, const float* gj, float* grad, long long n,
               uint32_t rows, const Levels& lv, bool smooth, cudaStream_t s, const TilePlan& tp) {
  const int smem = tile_smem(tile_shape(lv.num, F, tp.G), go != nullptr, gj != nullptr);
  if (go && gj)
    return launch_tiles(hash_bwd_kernel<F, true, true, kPair, kAgg>, n, tp, smem, s, x, go, gj,
                        grad, n, rows, lv, smooth);
  if (go)
    return launch_tiles(hash_bwd_kernel<F, true, false, kPair, kAgg>, n, tp, smem, s, x, go, gj,
                        grad, n, rows, lv, smooth);
  return launch_tiles(hash_bwd_kernel<F, false, true, kPair, kAgg>, n, tp, smem, s, x, go, gj,
                      grad, n, rows, lv, smooth);
}

template <int F>
int corner_rows_launch(const float* x, const float* go, const float* gj, int* keys, float* upd,
                       long long n, uint32_t rows, const Levels& lv, bool smooth, cudaStream_t s) {
  const unsigned grid = (unsigned)((n * lv.num + kRowThreads - 1) / kRowThreads);
  if (go && gj)
    hash_corner_rows_kernel<F, true, true><<<grid, kRowThreads, 0, s>>>(x, go, gj, keys, upd, n,
                                                                        rows, lv, smooth);
  else if (go)
    hash_corner_rows_kernel<F, true, false><<<grid, kRowThreads, 0, s>>>(x, go, gj, keys, upd, n,
                                                                         rows, lv, smooth);
  else
    hash_corner_rows_kernel<F, false, true><<<grid, kRowThreads, 0, s>>>(x, go, gj, keys, upd, n,
                                                                         rows, lv, smooth);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, 3] (any alignment), table [rows, F], out [n, L*F], jac [n, L*F, 3]
// or null: contiguous f32 device pointers, all but x 16-byte aligned; F is
// 2, 4 or 8; rows below 2^31 (JAX's int32 index). res / offsets / dense: L host ints per level. Enqueue on
// `stream`; return cudaGetLastError().
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
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  return F == 2   ? fwd_launch<2>(xp, tp, op, jp, n, r, lv, sm, s)
         : F == 4 ? fwd_launch<4>(xp, tp, op, jp, n, r, lv, sm, s)
                  : fwd_launch<8>(xp, tp, op, jp, n, r, lv, sm, s);
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
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  const TilePlan plan = tile_plan(L);
  return F == 2   ? bwd_launch<2, true, true>(xp, go, gj, gp, n, r, lv, sm, s, plan)
         : F == 4 ? bwd_launch<4, false, true>(xp, go, gj, gp, n, r, lv, sm, s, plan)
                  : bwd_launch<8, false, true>(xp, go, gj, gp, n, r, lv, sm, s, plan);
}

// The deterministic path, step 1: keys [n*L*8] int32 and upd [n*L*8, F]
// (16-byte aligned) for x and the cotangents as sst_hash_encode_bwd takes
// them; rows must be below 2^31.
int sst_hash_corner_rows(const void* x, const void* g_out, const void* g_jac, void* keys, void* upd,
                         long long n, long long rows, int F, int L, const int* res,
                         const uint32_t* offsets, const int* dense, int log2_size, int smoothstep,
                         void* stream) {
  Levels lv;
  if (!args_ok(n, rows, F, L) || rows >= (long long)INT32_MAX
      || !make_levels(L, res, offsets, dense, log2_size, &lv) || !keys || !upd
      || (!g_out && !g_jac))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* go = static_cast<const float*>(g_out);
  const float* gj = static_cast<const float*>(g_jac);
  int* kp = static_cast<int*>(keys);
  float* up = static_cast<float*>(upd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t r = (uint32_t)rows;
  const bool sm = smoothstep != 0;
  return F == 2   ? corner_rows_launch<2>(xp, go, gj, kp, up, n, r, lv, sm, s)
         : F == 4 ? corner_rows_launch<4>(xp, go, gj, kp, up, n, r, lv, sm, s)
                  : corner_rows_launch<8>(xp, go, gj, kp, up, n, r, lv, sm, s);
}

// The deterministic path, step 3: keys [m] sorted stably, perm [m] int64
// (the sort's indices), upd [m, F] of step 1, grad [rows, F] zeroed by the
// caller (16-byte aligned).
int sst_hash_segment_sum(const void* keys, const void* perm, const void* upd, void* grad,
                         long long m, long long rows, int F, void* stream) {
  if (m < 1 || rows < 1 || rows >= (long long)INT32_MAX || (F != 2 && F != 4 && F != 8) || !keys
      || !perm
      || !upd || !grad || (m + kRowThreads - 1) / kRowThreads > (long long)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int* kp = static_cast<const int*>(keys);
  const long long* pp = static_cast<const long long*>(perm);
  const float* up = static_cast<const float*>(upd);
  float* gp = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((m + kRowThreads - 1) / kRowThreads);
  if (F == 2)
    hash_segment_sum_kernel<2><<<grid, kRowThreads, 0, s>>>(kp, pp, up, gp, m, (int)rows);
  else if (F == 4)
    hash_segment_sum_kernel<4><<<grid, kRowThreads, 0, s>>>(kp, pp, up, gp, m, (int)rows);
  else
    hash_segment_sum_kernel<8><<<grid, kRowThreads, 0, s>>>(kp, pp, up, gp, m, (int)rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
