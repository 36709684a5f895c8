// Fully-fused MLP backward for Hopper (sm_90a): 3xTF32 on the tensor cores
// (wgmma), weights staged by the TMA unit.
//
// Replaces the Pallas TPU kernel sdfstudio_tpu/ops/pallas_mlp.py::
// _fused_mlp_padded_bwd (inner `kernel`, bound to the forward by defvjp).
// Given x [n, d0], the layers W_l [d_l, d_{l+1}], b_l and the cotangent
// g [n, dL] of y = out_act(...act(x W_0 + b_0)... W_{L-1} + b_{L-1}) it
// returns
//     delta_{L-1} = g * out_act'(pre_{L-1})
//     delta_{l-1} = (delta_l W_l^T) * act'(pre_{l-1})
//     dW_l = a_l^T delta_l,  db_l = sum_rows delta_l,  dx = delta_0 W_0^T
// with a_0 = x, a_l = act(pre_{l-1}), and act' taken from the pre-activation
// as pallas_mlp.py:74-79 does (relu: pre > 0; softplus100: sigmoid(100 pre);
// none: 1), at f32 accuracy (3xTF32, tf32_mma.cuh).
//
// What bounds it on an H100: arithmetic. dW costs what the forward costs
// (2 n sum d_l d_{l+1}) and the delta chain as much again for every layer
// but the first, plus the forward it rebuilds; in 3xTF32 at 165 TFLOP/s of
// f32-accurate products that is still far above the ridge. The design also
// pays bytes: the Z / D scratch below, written once and read back.
//
// Design. The TPU kernel sums dW and db across a grid that runs in order;
// Hopper blocks run in parallel and in no order, so the work is a few
// launches (after the split pre-pass of the weights, fused_mlp_chain.cuh):
//   1. rows kernel, forward: one block per 128 rows rebuilds the forward on
//      the tensor cores (the TPU kernel does the same: its residuals are
//      only (x, W, b)), storing each hidden pre-activation to a scratch Z_l
//      [n, d_{l+1}] and the last layer's delta to D_{L-1}. It lists the rows
//      with a pre-activation too close to 0 for 3xTF32 to be sure of the
//      relu's side (the fix below).
//   2. fix kernel: the listed rows' forward again, exactly as the plain
//      version computes it in f32 (a k-ordered FMA chain, then the bias), on
//      the CUDA cores; it overwrites their Z. A few rows in a hundred.
//   3. rows kernel, backward: from D_{L-1}, the delta chain back through
//      W_l^T on the tensor cores (the wgmma B operand is W_l as stored, which
//      is K-major for this product), storing each delta_l to a scratch D_l,
//      and dx when the caller needs it (the proposal nets' input needs none).
//   4. dW kernel, a split-K product on the tensor cores: block (tile, split)
//      sums a_l^T D_l over its share of the rows (at most 2048) for a
//      64 x 128 tile of dW_l, plus db_l in the tiles of the first k row, and
//      writes one partial. wgmma's tf32 operands must be K-major, and K is
//      the rows here, so each 32-row chunk of a_l = act(Z_{l-1}) (or x) and
//      of D_l arrives by cp.async two chunks ahead, is split into hi and lo
//      and stored transposed into shared memory. No bulk copy: the operand
//      has to pass through registers for act() and the split anyway, and
//      x's rows (39, 51, 321 floats) are not 16-byte aligned. The dW of a
//      head (at most 8 columns) is a narrow kernel on the FP32 cores.
//   5. reduce kernel: sums the partials over the splits in a fixed order,
//      so the result is the same bits from run to run (no atomics; the fix
//      list's order varies, but each row is computed the same way).
// Still paid: the rebuild (60.8 of 174.6 GFLOP of a 2048-ray step of
// neus-facto-tpu-p8) and the Z / D scratch, 1.88 GB written and read back a
// step.

#include "fused_mlp_chain.cuh"

namespace {

using namespace sst;

// dW kernels
constexpr int DW_THREADS = 128;  // one warpgroup
constexpr int GM = 64;           // dW tile rows (layer inputs)
constexpr int GN = 128;          // dW tile columns (layer outputs)
constexpr int BR = 32;           // rows of the sum per chunk: 4 k8 steps
constexpr int A_FLOATS = GM * BR;
constexpr int B_FLOATS = GN * BR;
constexpr int RAW_FLOATS = A_FLOATS + B_FLOATS;  // one chunk as read, f32
constexpr int BUF_FLOATS = 2 * RAW_FLOATS;       // one chunk split into hi and lo
constexpr int RAW_STAGES = 2;
// two raw chunks in flight and one split chunk: 96 KB, two blocks an SM
constexpr int DW_SMEM = (RAW_STAGES * RAW_FLOATS + BUF_FLOATS) * 4;
constexpr int NARROW = 8;        // dW of a head of at most 8 columns: FP32 cores
constexpr int NK = 32;           // k extent of a narrow dW tile (one lane each)
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMaxSplits = 256;
constexpr int kMinRowsPerSplit = 256;
// the tensor cores sum a split's rows in one accumulator; shorter sums,
// added in f32 by the reduce kernel, keep dW's error at a few 1e-6
constexpr int kMaxRowsPerSplit = 2048;
// a row with a forward pre-activation within this fraction of the row's
// scale of 0 is recomputed exactly (the rows kernel's fix)
constexpr float kFlipBand = 1.f / 16384;

struct DwArgs {
  const float* z[kMaxLayers];
  const float* d[kMaxLayers];
  int64_t off[kMaxLayers];    // offset of dW_l in a flat result; db_l follows it
  int items[kMaxLayers + 1];  // prefix count of tensor-core dW tiles per layer
  int narrow[kMaxLayers + 1];  // prefix count of narrow dW tiles per layer
  int dims[kMaxLayers + 1];
  int n_layers, n_rows, act, splits, rows_per_split;
  int64_t total;  // floats in one flat result (every dW_l and db_l)
};

template <int MAXT>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_bwd_rows_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring = setup_ring<MAXT>(smem, a.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == CONSUMER_WARPS) {
    if (lane == 0) produce(a, ring);
    return;
  }
  const int wg = warp >> 2, wwarp = warp & 3;
  float* act = ring.buf + (size_t)a.stages * ring.stage_floats + (size_t)wg * WG_ROWS * a.ld;
  const int row0 = blockIdx.x * BM + wg * WG_ROWS;
  load_rows(a.init, a.init_w, a.init_ones != 0, act, a.ld, row0, a.n_rows, wwarp, lane);
  const uint32_t act_s = smem_u32(act);
  const int ld = a.ld, n_rows = a.n_rows, hid = a.act, out = a.out_act;
  // per tile: Z or D (and dx) to device memory, the next job's input in
  // place. The accumulator already holds the bias (plan_chain's bias row).
  // The last layer reads g and the delta chain reads Z, every pair's loads
  // in flight before the first is used.
  auto epi = [&](const Job& jb, int T, const float(&acc)[32], int ww, int ln) {
    const int N = jb.N, col0 = (jb.t0 + T) * TILE_N;
    float* out_p = jb.out;
    // pairs (c, c + 1) are 8-byte aligned in device memory
    const bool even = (N & 1) == 0 && (reinterpret_cast<uintptr_t>(out_p) & 7) == 0;
    auto store = [&](int row, int c, float v0, float v1) {
      float* dst = out_p + (size_t)row * N + c;
      if (even && c + 1 < N) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (c < N) dst[0] = v0;
        if (c + 1 < N) dst[1] = v1;
      }
    };
    if (jb.kind == kFwdHidden) {
      with_act(hid, [&](auto A) {
        tile_pairs(acc, ww, ln, col0, [&](int, int r, int c, float v0, float v1) {
          if (row0 + r < n_rows) store(row0 + r, c, v0, v1);  // Z
          const uint32_t dst = act_s + (uint32_t)(r * ld + c) * 4;
          if (c + 1 < N) {
            sts2(dst, apply_act(v0, decltype(A)::value), apply_act(v1, decltype(A)::value));
          } else if (c < N) {
            sts(dst, apply_act(v0, decltype(A)::value));
          }
        });
      });
    } else if (jb.kind == kDx) {
      tile_pairs(acc, ww, ln, col0, [&](int, int r, int c, float v0, float v1) {
        if (row0 + r < n_rows) store(row0 + r, c, v0, v1);
      });
    } else {
      // delta: g * out_act'(pre) for the last layer, acc * act'(Z) before it
      const float* in = jb.in;
      float2 sv[16];
      tile_pairs(acc, ww, ln, col0, [&](int p, int r, int c, float, float) {
        const int row = row0 + r;
        const float* src = in + (size_t)row * N + c;
        // Z was written by this kernel: a coherent load, not the read-only path
        sv[p].x = row < n_rows && c < N ? __ldcg(src) : 0.f;
        sv[p].y = row < n_rows && c + 1 < N ? __ldcg(src + 1) : 0.f;
      });
      const bool last = jb.kind == kFwdLast;
      with_act(last ? out : hid, [&](auto A) {
        tile_pairs(acc, ww, ln, col0, [&](int p, int r, int c, float v0, float v1) {
          const bool valid = row0 + r < n_rows;
          constexpr int a_ = decltype(A)::value;
          const float d0 = !valid ? 0.f : last ? sv[p].x * act_grad(v0, a_) : v0 * act_grad(sv[p].x, a_);
          const float d1 = !valid ? 0.f : last ? sv[p].y * act_grad(v1, a_) : v1 * act_grad(sv[p].y, a_);
          if (valid) store(row0 + r, c, d0, d1);  // D
          const uint32_t dst = act_s + (uint32_t)(r * ld + c) * 4;
          if (c + 1 < N) {
            sts2(dst, d0, d1);
          } else if (c < N) {
            sts(dst, d0);
          }
        });
      });
    }
  };
  // The relu's derivative is decided by the sign of a forward layer's
  // pre-activation. 3xTF32 errs up to a few 1e-6 of a row's scale where the
  // plain version's f32 errs ~1e-7, so where a pre-activation lies that close
  // to 0 the two could take the relu's two sides, and that moves the row's
  // delta by its full value: one such entry of the color net moves dx by
  // ~3e-4 of its norm. So a row with any pre-activation within kFlipBand of
  // the row's scale (the largest |value| this thread holds of it) goes on the
  // fix list, and fused_mlp_bwd_fix_kernel recomputes its chain exactly
  // before the delta chain reads Z: a few rows in a hundred.
  uint32_t flagged = 0;  // this warp's listed rows
  auto fix = [&](const Job& jb, auto& acc, int ww, int ln) {
    if (!((jb.kind == kFwdHidden && hid == 1) || (jb.kind == kFwdLast && out == 1))) return;
    constexpr int NT = sizeof(acc) / sizeof(acc[0]);
    float m[2] = {0.f, 0.f};  // rows g and g + 8
#pragma unroll
    for (int T = 0; T < NT; ++T)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (T < jb.nt) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], fabsf(acc[T][i]));
    bool near[2] = {false, false};
#pragma unroll
    for (int T = 0; T < NT; ++T)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int c = (jb.t0 + T) * TILE_N + 8 * (i >> 2) + 2 * (ln & 3) + (i & 1);
        near[h] |= T < jb.nt && c < jb.N && fabsf(acc[T][i]) < kFlipBand * m[h];
      }
    // lane L holds rows L / 4 and L / 4 + 8 of the warp's 16; a row already
    // listed by an earlier layer is listed once
    const uint32_t lo = __ballot_sync(0xffffffffu, near[0]), hi = __ballot_sync(0xffffffffu, near[1]);
    uint32_t rows = 0;
    for (int g = 0; g < 8; ++g) {
      if ((lo >> (4 * g)) & 0xf) rows |= 1u << g;
      if ((hi >> (4 * g)) & 0xf) rows |= 1u << (g + 8);
    }
    const uint32_t fresh = rows & ~flagged;
    flagged |= rows;
    const int row = row0 + ww * 16 + ln;
    if (ln < 16 && ((fresh >> ln) & 1) && row < n_rows) a.fix_list[atomicAdd(a.fix_count, 1)] = row;
  };
  consume<MAXT>(a, act, ring, wwarp, lane, fix, epi);
}

__device__ __forceinline__ void store_split4(float* hi, float* lo, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], h[i], l[i]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The exact forward of the listed rows (the rows kernel's fix list), as the
// plain version computes it: each pre-activation a k-ordered FMA chain from
// 0, then the bias. A block takes FIX_ROWS rows and keeps their activations
// in shared memory; thread n computes column n of every row, reading each
// weight once. It overwrites those rows' Z and, for a relu output, their
// last delta. The rows' order in the list does not matter: each row is
// computed the same way wherever it lands.
constexpr int FIX_ROWS = 32;
constexpr int FIX_THREADS = 256;

__global__ void __launch_bounds__(FIX_THREADS)
fused_mlp_bwd_fix_kernel(const __grid_constant__ ChainArgs a, const float* __restrict__ x) {
  extern __shared__ __align__(16) float hs[];  // [2][FIX_ROWS][ld]: this layer's input, its output
  const int cnt = *a.fix_count;
  const int first = blockIdx.x * FIX_ROWS;
  if (first >= cnt) return;
  const int rows = min(FIX_ROWS, cnt - first);
  const int ld = a.ld;
  float* in = hs;
  float* outb = hs + FIX_ROWS * ld;
  const int K0 = a.dims[0];
  for (int i = threadIdx.x; i < rows * K0; i += FIX_THREADS) {
    const int r = i / K0, k = i - r * K0;
    in[r * ld + k] = __ldg(x + (size_t)a.fix_list[first + r] * K0 + k);
  }
  __syncthreads();
  for (int j = 0; j < a.n_jobs; ++j) {
    const Job jb = a.jobs[j];
    const bool last = jb.kind == kFwdLast;
    if (last && a.out_act != 1) break;
    const int K = jb.K, N = jb.N;
    for (int n = threadIdx.x; n < N; n += FIX_THREADS) {
      float z[FIX_ROWS];
#pragma unroll
      for (int r = 0; r < FIX_ROWS; ++r) z[r] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float w = __ldg(jb.w + (size_t)k * N + n);
#pragma unroll
        for (int r = 0; r < FIX_ROWS; ++r) z[r] = fmaf(in[r * ld + k], w, z[r]);
      }
      const float b = __ldg(jb.bias + n);
#pragma unroll
      for (int r = 0; r < FIX_ROWS; ++r) {
        if (r >= rows) break;
        const float v = z[r] + b;
        const size_t e = (size_t)a.fix_list[first + r] * N + n;
        if (last) {
          jb.out[e] = __ldg(jb.in + e) * act_grad(v, a.out_act);  // D
        } else {
          jb.out[e] = v;  // Z
          outb[r * ld + n] = apply_act(v, a.act);
        }
      }
    }
    __syncthreads();
    float* t = in;
    in = outb;
    outb = t;
    if (last) break;
  }
}

// the dW of a head (at most NARROW columns, NJ of them loaded: 1, 4 or 8):
// lane = k, warp w takes rows r_beg + w, + 4, ..., U rows a step with every
// load of the step in flight; a fixed-order sum over the warps
template <int NJ>
__global__ void __launch_bounds__(DW_THREADS)
fused_mlp_bwd_dw_narrow_kernel(const float* __restrict__ x, float* __restrict__ partial,
                               const __grid_constant__ DwArgs a) {
  __shared__ float red[DW_THREADS / 32][NK * NJ + NJ];
  const int tid = threadIdx.x, item = blockIdx.x, split = blockIdx.y;
  int l = 0;
  while (item >= a.narrow[l + 1]) ++l;
  const int K = a.dims[l], N = a.dims[l + 1];
  const int r_beg = split * a.rows_per_split;
  const int r_end = min(a.n_rows, r_beg + a.rows_per_split);
  const float* __restrict__ D = a.d[l];
  float* P = partial + (size_t)split * a.total + a.off[l];
  float* Pb = P + (size_t)K * N;
  const int lane = tid & 31, w = tid >> 5;
  const int k = (item - a.narrow[l]) * NK + lane;
  const bool first = item == a.narrow[l];
  float acc[NJ], bacc = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  constexpr int U = NJ == 1 ? 16 : 8, STRIDE = DW_THREADS / 32;
  // the layer's input: x, or Z_{l-1} to which the activation is applied
  // after the loads, so none of them waits for another
  const float* __restrict__ A = l == 0 ? x : a.z[l - 1];
  with_act(l == 0 ? 0 : a.act, [&](auto AC) {
    for (int r = r_beg + w; r < r_end; r += U * STRIDE) {
      float av[U], dv[U][NJ];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * STRIDE;
        const bool ok = rr < r_end;
        av[u] = ok && k < K ? __ldg(A + (size_t)rr * K + k) : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dv[u][j] = ok && j < N ? __ldg(D + (size_t)rr * N + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float in = apply_act(av[u], decltype(AC)::value);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[j] = fmaf(in, dv[u][j], acc[j]);
          if (first && j == lane) bacc += dv[u][j];
        }
      }
    }
  });
#pragma unroll
  for (int j = 0; j < NJ; ++j) red[w][lane * NJ + j] = acc[j];
  if (lane < NJ) red[w][NK * NJ + lane] = bacc;
  __syncthreads();
  for (int i = tid; i < NK * NJ + NJ; i += DW_THREADS) {
    float s = 0.f;
    for (int v = 0; v < DW_THREADS / 32; ++v) s += red[v][i];  // fixed order
    if (i < NK * NJ) {
      const int kk = (item - a.narrow[l]) * NK + i / NJ, j = i % NJ;
      if (kk < K && j < N) P[(size_t)kk * N + j] = s;
    } else if (first && i - NK * NJ < N) {
      Pb[i - NK * NJ] = s;
    }
  }
}

// rows r0 .. r0 + BR of a row-major [n, width] source, columns c0 .. c0 + W,
// into dst [BR][W] by cp.async, 0 outside the source; 16-byte copies where
// the rows allow them
template <int W>
__device__ __forceinline__ void load_raw(uint32_t dst, const float* __restrict__ src, int width,
                                         int c0, int r0, int r_end, int tid) {
  if ((width & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int v = tid; v < BR * W / 4; v += DW_THREADS) {
      const int r = v / (W / 4), c = (v % (W / 4)) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const int left = (width - gc) * 4;
      const int bytes = gr < r_end && left > 0 ? (left < 16 ? left : 16) : 0;
      cp_async16(dst + (uint32_t)(r * W + c) * 4, bytes ? src + (size_t)gr * width + gc : src, bytes);
    }
  } else {
    for (int e = tid; e < BR * W; e += DW_THREADS) {
      const int r = e / W, c = e % W;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < r_end && gc < width;
      cp_async4(dst + (uint32_t)(r * W + c) * 4, ok ? src + (size_t)gr * width + gc : src, ok);
    }
  }
}

// dW on the tensor cores: a 64 x 128 tile of dW_l = a_l^T D_l over the
// split's rows, 32 rows a chunk. Each chunk of a_l (x, or Z_{l-1} to which
// the activation is applied here) and of D_l arrives by cp.async two chunks
// ahead, is split into tf32 hi and lo and stored K-major (rows of the sum
// contiguous), and takes 3 x 4 wgmma m64n128k8.
__global__ void __launch_bounds__(DW_THREADS, 2)
fused_mlp_bwd_dw_kernel(const float* __restrict__ x, float* __restrict__ partial,
                        const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(128) float sm[];
  const int tid = threadIdx.x;
  const int item = blockIdx.x, split = blockIdx.y;
  int l = 0;
  while (item >= a.items[l + 1]) ++l;
  const int K = a.dims[l], N = a.dims[l + 1];
  const int r_beg = split * a.rows_per_split;
  const int r_end = min(a.n_rows, r_beg + a.rows_per_split);
  const float* __restrict__ D = a.d[l];
  const float* __restrict__ A = l == 0 ? x : a.z[l - 1];
  const int act = l == 0 ? 0 : a.act;
  float* P = partial + (size_t)split * a.total + a.off[l];
  float* Pb = P + (size_t)K * N;
  const int nnt = cdiv(N, GN);
  const int mt = (item - a.items[l]) / nnt, ntile = (item - a.items[l]) % nnt;
  const int m0 = mt * GM, n0 = ntile * GN;
  float* ahi = sm + RAW_STAGES * RAW_FLOATS;
  float* alo = ahi + A_FLOATS;
  float* bhi = alo + A_FLOATS;
  float* blo = bhi + B_FLOATS;
  const uint32_t raw0 = smem_u32(sm);
  auto fetch = [&](int c) {  // chunk c into raw stage c % RAW_STAGES
    const int r0 = r_beg + c * BR;
    if (r0 < r_end) {
      const uint32_t st = raw0 + (uint32_t)((c % RAW_STAGES) * RAW_FLOATS) * 4;
      load_raw<GM>(st, A, K, m0, r0, r_end, tid);
      load_raw<GN>(st + A_FLOATS * 4, D, N, n0, r0, r_end, tid);
    }
    cp_async_commit();
  };
  const int chunks = cdiv(r_end - r_beg, BR);
  for (int c = 0; c < RAW_STAGES; ++c) fetch(c);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float bacc = 0.f;
  // the conversion's thread map: A quads q = tid / 64 + 2 i (4 rows each) of
  // input m0 + tid % 64; D quads q = 0..7 of output n0 + tid
  const int fa = tid & 63, qa = tid >> 6;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<RAW_STAGES - 1>();  // chunk c has landed (this thread's copies)
    __syncthreads();                  // everyone's, and chunk c - 1's products are done
    const float* raw = sm + (c % RAW_STAGES) * RAW_FLOATS;
    // transposed stores, K-major: element (m, r) of a k8 step at
    // ((m / 8) * 2 + (r % 8) / 4) * 32 + (m % 8) * 4 + r % 4
    with_act(act, [&](auto AC) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qa + 2 * i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = apply_act(raw[(4 * q + j) * GM + fa], decltype(AC)::value);
        const int o = ((q >> 1) * (GM / 8) + (fa >> 3)) * 64 + (q & 1) * 32 + (fa & 7) * 4;
        store_split4(ahi + o, alo + o, v);
      }
    });
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = raw[A_FLOATS + (4 * q + j) * GN + tid];
      const int o = ((q >> 1) * (GN / 8) + (tid >> 3)) * 64 + (q & 1) * 32 + (tid & 7) * 4;
      store_split4(bhi + o, blo + o, v);
      if (mt == 0) bacc += (v[0] + v[1]) + (v[2] + v[3]);
    }
    fence_proxy_async();
    __syncthreads();  // the split chunk is complete and its raw stage is free
    fetch(c + RAW_STAGES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BR / 8; ++ks) {
      const uint64_t dah = make_desc(ahi + ks * GM * 8, kLBO, kSBO);
      const uint64_t dal = make_desc(alo + ks * GM * 8, kLBO, kSBO);
      const uint64_t dbh = make_desc(bhi + ks * GN * 8, kLBO, kSBO);
      const uint64_t dbl = make_desc(blo + ks * GN * 8, kLBO, kSBO);
      wgmma_ss_n128(acc, dal, dbh);
      wgmma_ss_n128(acc, dah, dbl);
      wgmma_ss_n128(acc, dah, dbh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int k = m0 + warp * 16 + gq + 8 * ((i >> 1) & 1);
    const int n = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (k < K && n < N) P[(size_t)k * N + n] = acc[i];
  }
  if (mt == 0 && n0 + tid < N) Pb[n0 + tid] = bacc;
}

__global__ void fused_mlp_bwd_reduce_kernel(const float* __restrict__ partial,
                                            float* __restrict__ out, int splits, int64_t total) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[(size_t)p * total + e];  // fixed order
    out[e] = s;
  }
}

// floats of one Z or D region, rounded up so every region starts 16-byte aligned
inline int64_t region(int n_rows, int width) { return ((int64_t)n_rows * width + 3) / 4 * 4; }

// Fills everything of the dW launch but the pointers; returns the floats of
// scratch (Z and D).
int64_t plan_dw(const int* dims, int n_layers, int n_rows, DwArgs* a) {
  for (int l = 0; l <= n_layers; ++l) a->dims[l] = dims[l];
  a->n_layers = n_layers;
  a->n_rows = n_rows;
  int64_t total = 0;
  a->items[0] = a->narrow[0] = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int K = dims[l], N = dims[l + 1];
    a->off[l] = total;
    total += (int64_t)K * N + N;
    a->items[l + 1] = a->items[l] + (N <= NARROW ? 0 : cdiv(K, GM) * cdiv(N, GN));
    a->narrow[l + 1] = a->narrow[l] + (N <= NARROW ? cdiv(K, NK) : 0);
  }
  a->total = total;
  int splits = cdiv(kTargetBlocks, a->items[n_layers] + a->narrow[n_layers]);
  const int by_len = cdiv(n_rows, kMaxRowsPerSplit);
  splits = splits > by_len ? splits : by_len;
  splits = splits < kMaxSplits ? splits : kMaxSplits;
  const int by_rows = n_rows / kMinRowsPerSplit;
  splits = splits < by_rows ? splits : by_rows;
  splits = splits > 1 ? splits : 1;
  a->rows_per_split = round_up(cdiv(n_rows, splits), BR);
  a->splits = cdiv(n_rows, a->rows_per_split);
  int64_t scratch = 0;
  for (int l = 0; l < n_layers; ++l)
    scratch += region(n_rows, dims[l + 1]) * (l < n_layers - 1 ? 2 : 1);
  return scratch + region(n_rows, 1) + 4;  // the fix list and its count (ints)
}

template <int MAXT>
cudaError_t launch_rows(const ChainArgs& a, int smem, cudaStream_t st) {
  auto kern = fused_mlp_bwd_rows_kernel<MAXT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<cdiv(a.n_rows, BM), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_rows(int maxt, const ChainArgs& a, int smem, cudaStream_t st) {
  return maxt == 2 ? launch_rows<2>(a, smem, st)
       : maxt == 4 ? launch_rows<4>(a, smem, st)
                   : launch_rows<5>(a, smem, st);
}

}  // namespace

extern "C" {

int sst_fused_mlp_bwd_smem_limit() { return kSmemLimit; }

// out[0] = partial splits, out[1] = floats of the flat result (dW_0, db_0,
// dW_1, db_1, ...), out[2] = floats of the Z / D scratch, out[3] = shared
// memory of the rows kernel in bytes, out[4] = floats of the split scratch,
// out[5] = status (as sst_fused_mlp_fwd_workspace's).
void sst_fused_mlp_bwd_workspace(const void* dims, int n_layers, int n_rows, int need_dx,
                                 int64_t* out) {
  const int* d = static_cast<const int*>(dims);
  const ChainPlan p = plan_chain(d, n_layers, true, need_dx != 0);
  out[5] = p.status;
  if (p.status != 0) return;
  DwArgs a;
  out[2] = plan_dw(d, n_layers, n_rows, &a);
  out[0] = a.splits;
  out[1] = a.total;
  out[3] = p.smem;
  out[4] = p.split_floats;
}

// x [n_rows, dims[0]], g [n_rows, dims[n_layers]], dx (null when not
// needed) like x; w_ptrs / b_ptrs: host arrays of device pointers to W_l and
// b_l; split, scratch, partial and result are device buffers of the sizes
// the workspace call gives (split, scratch and splits * total floats, and
// `total` floats). All f32 and contiguous; dims is a host int32 array.
// Enqueues the kernels on `stream` and returns the first CUDA error.
int sst_fused_mlp_bwd(const void* x, const void* g, void* dx, const void* w_ptrs,
                      const void* b_ptrs, void* split, void* scratch, void* partial, void* result,
                      const void* dims, int n_layers, int n_rows, int act, int out_act,
                      void* stream) {
  if (n_rows < 1) return (int)cudaErrorInvalidValue;
  const int* d = static_cast<const int*>(dims);
  ChainPlan p = plan_chain(d, n_layers, true, dx != nullptr);
  if (p.status != 0 || p.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  bind_chain(p, w_ptrs, b_ptrs, static_cast<float*>(split));
  DwArgs da;
  plan_dw(d, n_layers, n_rows, &da);
  // the scratch: Z_l for every layer but the last, then D_l for every layer
  float* z[kMaxLayers] = {};
  float* dl[kMaxLayers] = {};
  float* s = static_cast<float*>(scratch);
  for (int l = 0; l < n_layers - 1; ++l) {
    z[l] = s;
    s += region(n_rows, d[l + 1]);
  }
  for (int l = 0; l < n_layers; ++l) {
    dl[l] = s;
    s += region(n_rows, d[l + 1]);
  }
  int* fix_list = reinterpret_cast<int*>(s);
  int* fix_count = reinterpret_cast<int*>(s + region(n_rows, 1));
  for (int l = 0; l < n_layers; ++l) {
    da.z[l] = z[l];
    da.d[l] = dl[l];
  }
  for (int j = 0; j < p.args.n_jobs; ++j) {
    Job& jb = p.args.jobs[j];
    const int l = jb.layer;
    jb.w = reinterpret_cast<const float*>(static_cast<const uint64_t*>(w_ptrs)[l]);
    jb.bias = reinterpret_cast<const float*>(static_cast<const uint64_t*>(b_ptrs)[l]);
    if (jb.kind == kFwdHidden) {
      jb.out = z[l];
    } else if (jb.kind == kFwdLast) {
      jb.out = dl[l];
      jb.in = static_cast<const float*>(g);
    } else if (jb.kind == kDelta) {
      jb.out = dl[l - 1];
      jb.in = z[l - 1];
    } else {
      jb.out = static_cast<float*>(dx);
    }
  }
  p.args.n_rows = n_rows;
  p.args.act = act;
  p.args.out_act = out_act;
  p.args.fix_list = fix_list;
  p.args.fix_count = fix_count;
  da.act = act;
  const float* xp = static_cast<const float*>(x);
  // the rows pass in three launches: the forward rebuilt (it lists the rows
  // to fix), the listed rows' exact forward, the delta chain from the last
  // layer's delta
  int n_fwd = 0;
  while (n_fwd < p.args.n_jobs &&
         (p.args.jobs[n_fwd].kind == kFwdHidden || p.args.jobs[n_fwd].kind == kFwdLast))
    ++n_fwd;
  ChainArgs fwd = p.args, back = p.args;
  fwd.n_jobs = n_fwd;
  fwd.init = xp;
  fwd.init_w = d[0];
  fwd.init_ones = 1;
  back.n_jobs = p.args.n_jobs - n_fwd;
  for (int j = 0; j < back.n_jobs; ++j) back.jobs[j] = p.args.jobs[n_fwd + j];
  back.init = dl[n_layers - 1];
  back.init_w = d[n_layers];
  back.init_ones = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(fix_count, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = launch_split(p, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_rows(p.maxt, fwd, p.smem, st);
  if (err != cudaSuccess) return (int)err;
  const int fix_smem = 2 * FIX_ROWS * p.args.ld * (int)sizeof(float);
  err = cudaFuncSetAttribute(fused_mlp_bwd_fix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fix_smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_bwd_fix_kernel<<<cdiv(n_rows, FIX_ROWS), FIX_THREADS, fix_smem, st>>>(fwd, xp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (back.n_jobs > 0) {
    err = launch_rows(p.maxt, back, p.smem, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (da.items[n_layers] > 0) {
    err = cudaFuncSetAttribute(fused_mlp_bwd_dw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_dw_kernel<<<dim3(da.items[n_layers], da.splits), DW_THREADS, DW_SMEM, st>>>(
        xp, static_cast<float*>(partial), da);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (da.narrow[n_layers] > 0) {
    int widest = 1;  // the widest head that takes the narrow path
    for (int l = 0; l < n_layers; ++l)
      if (d[l + 1] <= NARROW && d[l + 1] > widest) widest = d[l + 1];
    auto narrow = widest == 1 ? fused_mlp_bwd_dw_narrow_kernel<1>
                : widest <= 4 ? fused_mlp_bwd_dw_narrow_kernel<4>
                              : fused_mlp_bwd_dw_narrow_kernel<NARROW>;
    narrow<<<dim3(da.narrow[n_layers], da.splits), DW_THREADS, 0, st>>>(
        xp, static_cast<float*>(partial), da);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((da.total + 255) / 256);
  fused_mlp_bwd_reduce_kernel<<<blocks < 1024 ? blocks : 1024, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(result), da.splits, da.total);
  return (int)cudaGetLastError();
}

}  // extern "C"
