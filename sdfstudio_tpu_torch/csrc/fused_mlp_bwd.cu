// Fully-fused MLP backward for Hopper (sm_90a), FP32 on the CUDA cores.
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
// none: 1).
//
// What bounds it on an H100: arithmetic. dW costs what the forward costs
// (2 n sum d_l d_{l+1}) and dx as much again for every layer but the first,
// against a few floats of HBM traffic per row, far above the FP32 ridge.
//
// Design. The TPU kernel sums dW and db across a grid that runs in order
// into outputs with a constant index; Hopper blocks run in parallel and in
// no order, so the work is split in three launches:
//   1. rows kernel, one block per 64 rows (as the forward kernel): it
//      recomputes the forward in shared memory (the TPU kernel does the
//      same: its residuals are only (x, W, b)), storing each hidden
//      pre-activation to a global scratch Z_l, then runs the delta chain
//      back through W_l^T in shared memory, storing each delta_l to a
//      scratch D_l, and writes dx. The weights stream through shared memory
//      in 16 x 128 slices as in the forward (the color net's 580 KB do not
//      fit a block); W_l^T is read by a transposed, still coalesced, load.
//      dx is skipped when the caller does not need it (the proposal nets'
//      input is a positional encoding of positions that need no gradient).
//   2. dW kernel, a split-K product: block (tile, split) sums
//      act(Z_{l-1})^T D_l over its share of the rows for a 64 x 128 tile of
//      dW_l in registers, plus db_l for the tiles in the first k row, and
//      writes one partial. Heads of at most 8 columns take a narrow path
//      (lane = k, warp = row stride, a fixed-order reduction over warps).
//   3. reduce kernel: sums the partials over the splits in a fixed order,
//      so the result is the same from run to run (no atomics).
// Trade-off: this version pays twice. It recomputes the forward (its FLOPs
// again: 60.8 of the 174.6 GFLOP of a 2048-ray step of neus-facto-tpu-p8),
// and it also writes every hidden pre-activation Z and every delta D to a
// transient HBM scratch that the dW kernel reads back: 1.07 GB for the
// first proposal net's call, 1.88 GB over a step's three calls. Saving Z in
// the forward instead would hold ~0.94 GB from the forward to the backward
// but drop the rebuild; fusing the dW partials into the rows kernel would
// keep D off HBM. Tensor cores (TF32/bf16 wgmma) and TMA are later work:
// this version is the plain FP32 reference point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int BM = 64;         // rows per block of the rows kernel
constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid
constexpr int TM = 4, TN = 8;    // per-thread tile: rows ty + 16 i, cols tx + 16 j
constexpr int NC = TX * TN;      // 128 output columns per pass
constexpr int BK = 16;           // K depth of a weight slice
constexpr int WLD = NC + 4;      // row stride of the weight slice (transposed stores)
constexpr int WREG = BK * NC / THREADS;  // 8 prefetch registers per thread
constexpr int NARROW = 8;        // N <= NARROW -> row-dot / narrow paths
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
// dW kernel
constexpr int GK = 64;           // k extent of a dW tile (rows ty + 16 i)
constexpr int GN = 128;          // n extent (cols tx + 16 j)
constexpr int BR = 16;           // rows per chunk of the split-K loop
constexpr int NK = 32;           // k extent of a narrow dW tile (one lane each)
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMaxSplits = 256;
constexpr int kMinRowsPerSplit = 256;
constexpr int kSmemPerSM = 233472;  // shared memory of one SM (228 KB)
constexpr int kSmemPerBlockReserved = 1024;  // the runtime's share of each resident block

static_assert(TY * TM == BM, "thread grid must cover the row block");
static_assert(BM * 4 == THREADS, "row-dot path uses 4 threads per row");
static_assert(TY * 4 == GK && TX * TN == GN, "dW tile must match the thread grid");

struct BwdArgs {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float* z[kMaxLayers];  // pre-activation of layer l, [n_rows, dims[l+1]], l < n_layers - 1
  float* d[kMaxLayers];  // delta of layer l, [n_rows, dims[l+1]]
  int64_t off[kMaxLayers];  // offset of dW_l in a flat result; db_l follows it
  int items[kMaxLayers + 1];  // prefix count of dW tiles per layer
  int dims[kMaxLayers + 1];
  int n_layers;
  int n_rows;
  int act;
  int out_act;
  int ld;  // row stride (floats) of the shared activation buffers
  int splits;
  int rows_per_split;
  int64_t total;  // floats in one flat result (every dW_l and db_l)
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int cdiv(int v, int m) { return (v + m - 1) / m; }

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) {
    const float t = 100.f * v;
    return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) * 0.01f;
  }
  return v;
}

// derivative of the activation from its pre-activation (pallas_mlp.py:74-79)
__device__ __forceinline__ float act_grad(float pre, int act) {
  if (act == 1) return pre > 0.f ? 1.f : 0.f;
  if (act == 2) return 1.f / (1.f + expf(-100.f * pre));
  return 1.f;
}

// element (k, n) of the K x N matrix a layer multiplies by: W itself
// ([K, N]) or, with TRANS, W^T of a W stored [N, K]
template <bool TRANS>
__device__ __forceinline__ float wload(const float* __restrict__ W, int K, int N, int k, int n) {
  return TRANS ? __ldg(W + (size_t)n * K + k) : __ldg(W + (size_t)k * N + n);
}

template <bool TRANS>
__device__ __forceinline__ void load_w_slice(float (&r)[WREG], const float* __restrict__ W,
                                             int K, int N, int k0, int n0, int tid) {
#pragma unroll
  for (int s = 0; s < WREG; ++s) {
    const int i = tid + s * THREADS;
    // neighbouring threads walk the contiguous axis of W in both layouts
    const int kk = TRANS ? i % BK : i / NC, nn = TRANS ? i / BK : i % NC;
    const int k = k0 + kk, n = n0 + nn;
    r[s] = (k < K && n < N) ? wload<TRANS>(W, K, N, k, n) : 0.f;
  }
}

template <bool TRANS>
__device__ __forceinline__ void store_w_slice(const float (&r)[WREG], float* wt, int tid) {
#pragma unroll
  for (int s = 0; s < WREG; ++s) {
    const int i = tid + s * THREADS;
    const int kk = TRANS ? i % BK : i / NC, nn = TRANS ? i / BK : i % NC;
    wt[kk * WLD + nn] = r[s];
  }
}

// acc[r, n] = sum_k in[r, k] M(k, n) for the block's BM rows, handed to
// epi(r, n, acc) once per output. `in` must be zero in columns K ..
// round_up(K, BK). Ends with a __syncthreads.
template <bool TRANS, class Epi>
__device__ __forceinline__ void block_layer(const float* in, int ld, const float* __restrict__ W,
                                            int K, int N, float* wt, int tid, Epi epi) {
  if (N <= NARROW) {
    const int r = tid >> 2, part = tid & 3;
    float acc[NARROW];
#pragma unroll
    for (int j = 0; j < NARROW; ++j) acc[j] = 0.f;
    for (int k = part; k < K; k += 4) {
      const float av = in[r * ld + k];
#pragma unroll
      for (int j = 0; j < NARROW; ++j)
        if (j < N) acc[j] = fmaf(av, wload<TRANS>(W, K, N, k, j), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NARROW; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 2);
    }
    if (part == 0) {
#pragma unroll
      for (int j = 0; j < NARROW; ++j)
        if (j < N) epi(r, j, acc[j]);
    }
    __syncthreads();
    return;
  }
  const int tx = tid % TX, ty = tid / TX;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    float wr[WREG];
    load_w_slice<TRANS>(wr, W, K, N, 0, n0, tid);
    store_w_slice<TRANS>(wr, wt, tid);
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += BK) {
      const bool more = k0 + BK < K;
      if (more) load_w_slice<TRANS>(wr, W, K, N, k0 + BK, n0, tid);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = in[(ty + i * TY) * ld + k0 + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = wt[kk * WLD + tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
      if (more) {
        store_w_slice<TRANS>(wr, wt, tid);
        __syncthreads();
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) {
#pragma unroll
        for (int i = 0; i < TM; ++i) epi(ty + i * TY, n, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// zero columns N .. round_up(N, BK) of a shared buffer: the K padding of
// the next layer's input
__device__ __forceinline__ void zero_pad(float* buf, int ld, int N, int tid) {
  const int pad = round_up(N, BK) - N;
  for (int i = tid; i < BM * pad; i += THREADS) buf[(i / pad) * ld + N + i % pad] = 0.f;
  __syncthreads();
}

// MIN_BLOCKS = 2 caps registers at 128 so that two blocks share an SM where
// their shared memory allows it (the proposal nets); the color net's 180 KB
// leave room for one block, which then keeps the registers it wants rather
// than spill for an occupancy it cannot have.
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_mlp_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          float* __restrict__ dx, const BwdArgs a) {
  extern __shared__ float smem[];
  const int ld = a.ld;
  float* in = smem;
  float* out = smem + BM * ld;
  float* wt = smem + 2 * BM * ld;  // [BK][WLD]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, a.n_rows - row0);
  const int L = a.n_layers;

  {
    const int d_in = a.dims[0];
    const int kp = round_up(d_in, BK);
    for (int i = tid; i < BM * kp; i += THREADS) {
      const int r = i / kp, c = i % kp;
      in[r * ld + c] = (r < rows && c < d_in) ? x[(size_t)(row0 + r) * d_in + c] : 0.f;
    }
  }
  __syncthreads();

  // forward, keeping pre-activations in Z; the last layer's epilogue turns
  // its pre-activation straight into delta_{L-1}
  for (int l = 0; l < L; ++l) {
    const int K = a.dims[l], N = a.dims[l + 1];
    const float* __restrict__ B = a.b[l];
    if (l < L - 1) {
      float* Z = a.z[l];
      const int act = a.act;
      block_layer<false>(in, ld, a.w[l], K, N, wt, tid, [&](int r, int n, float acc) {
        const float v = acc + __ldg(B + n);
        if (r < rows) Z[(size_t)(row0 + r) * N + n] = v;
        out[r * ld + n] = apply_act(v, act);
      });
    } else {
      float* D = a.d[l];
      const int out_act = a.out_act;
      block_layer<false>(in, ld, a.w[l], K, N, wt, tid, [&](int r, int n, float acc) {
        const float v = acc + __ldg(B + n);
        const size_t e = (size_t)(row0 + r) * N + n;
        const float dl = r < rows ? g[e] * act_grad(v, out_act) : 0.f;
        if (r < rows) D[e] = dl;
        out[r * ld + n] = dl;
      });
    }
    zero_pad(out, ld, N, tid);
    float* t = in;
    in = out;
    out = t;
  }

  // delta chain back through W_l^T
  for (int l = L - 1; l >= 1; --l) {
    const int K = a.dims[l + 1], N = a.dims[l];
    const float* Z = a.z[l - 1];
    float* D = a.d[l - 1];
    const int act = a.act;
    block_layer<true>(in, ld, a.w[l], K, N, wt, tid, [&](int r, int n, float acc) {
      const size_t e = (size_t)(row0 + r) * N + n;
      const float dl = r < rows ? acc * act_grad(Z[e], act) : 0.f;
      if (r < rows) D[e] = dl;
      out[r * ld + n] = dl;
    });
    zero_pad(out, ld, N, tid);
    float* t = in;
    in = out;
    out = t;
  }

  if (dx != nullptr) {
    const int K = a.dims[1], N = a.dims[0];
    block_layer<true>(in, ld, a.w[0], K, N, wt, tid, [&](int r, int n, float acc) {
      if (r < rows) dx[(size_t)(row0 + r) * N + n] = acc;
    });
  }
}

// A_l(r, k): the input of layer l, x or act(Z_{l-1})
__device__ __forceinline__ float layer_input(const BwdArgs& a, const float* __restrict__ x, int l,
                                             int r, int k) {
  const int K = a.dims[l];
  return l == 0 ? __ldg(x + (size_t)r * K + k) : apply_act(a.z[l - 1][(size_t)r * K + k], a.act);
}

// two blocks an SM: the tile loop, capped at 128 registers, spills a few
// bytes and gains the second block's latency hiding
__global__ void __launch_bounds__(THREADS, 2)
fused_mlp_bwd_dw_kernel(const float* __restrict__ x, float* __restrict__ partial, const BwdArgs a) {
  __shared__ float As[BR][GK];
  __shared__ float Ds[BR][GN];
  __shared__ float red[THREADS / 32][NK * NARROW + NARROW];
  const int tid = threadIdx.x;
  const int item = blockIdx.x, split = blockIdx.y;
  int l = 0;
  while (item >= a.items[l + 1]) ++l;
  const int K = a.dims[l], N = a.dims[l + 1];
  const int r_beg = split * a.rows_per_split;
  const int r_end = min(a.n_rows, r_beg + a.rows_per_split);
  const float* __restrict__ D = a.d[l];
  float* P = partial + (size_t)split * a.total + a.off[l];
  float* Pb = P + (size_t)K * N;

  if (N <= NARROW) {
    // narrow head: lane = k, warp w takes rows r_beg + w, + 8, ...
    const int lane = tid & 31, w = tid >> 5;
    const int k = (item - a.items[l]) * NK + lane;
    const bool first = item == a.items[l];
    float acc[NARROW], bacc = 0.f;
#pragma unroll
    for (int j = 0; j < NARROW; ++j) acc[j] = 0.f;
    for (int r = r_beg + w; r < r_end; r += THREADS / 32) {
      const float av = k < K ? layer_input(a, x, l, r, k) : 0.f;
#pragma unroll
      for (int j = 0; j < NARROW; ++j)
        if (j < N) acc[j] = fmaf(av, __ldg(D + (size_t)r * N + j), acc[j]);
      if (first && lane < N) bacc += __ldg(D + (size_t)r * N + lane);
    }
#pragma unroll
    for (int j = 0; j < NARROW; ++j) red[w][lane * NARROW + j] = acc[j];
    if (lane < NARROW) red[w][NK * NARROW + lane] = bacc;
    __syncthreads();
    for (int i = tid; i < NK * NARROW + NARROW; i += THREADS) {
      float s = 0.f;
      for (int v = 0; v < THREADS / 32; ++v) s += red[v][i];  // fixed order
      if (i < NK * NARROW) {
        const int kk = (item - a.items[l]) * NK + i / NARROW, j = i % NARROW;
        if (kk < K && j < N) P[(size_t)kk * N + j] = s;
      } else if (first && i - NK * NARROW < N) {
        Pb[i - NK * NARROW] = s;
      }
    }
    return;
  }

  const int nnt = cdiv(N, GN);
  const int kt = (item - a.items[l]) / nnt, nt = (item - a.items[l]) % nnt;
  const int k0 = kt * GK, n0 = nt * GN;
  const int tx = tid % TX, ty = tid / TX;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float bacc = 0.f;
  constexpr int AREG = BR * GK / THREADS, DREG = BR * GN / THREADS;
  float ar[AREG], dr[DREG];
  auto load = [&](int r0) {
#pragma unroll
    for (int s = 0; s < AREG; ++s) {
      const int i = tid + s * THREADS, r = r0 + i / GK, k = k0 + i % GK;
      ar[s] = (r < r_end && k < K) ? layer_input(a, x, l, r, k) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < DREG; ++s) {
      const int i = tid + s * THREADS, r = r0 + i / GN, n = n0 + i % GN;
      dr[s] = (r < r_end && n < N) ? __ldg(D + (size_t)r * N + n) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int s = 0; s < AREG; ++s) {
      const int i = tid + s * THREADS;
      As[i / GK][i % GK] = ar[s];
    }
#pragma unroll
    for (int s = 0; s < DREG; ++s) {
      const int i = tid + s * THREADS;
      Ds[i / GN][i % GN] = dr[s];
    }
  };
  load(r_beg);
  for (int r0 = r_beg; r0 < r_end; r0 += BR) {
    store();
    __syncthreads();
    if (r0 + BR < r_end) load(r0 + BR);  // in flight during the FMAs
#pragma unroll
    for (int rr = 0; rr < BR; ++rr) {
      float av[4], dv[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[rr][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) dv[j] = Ds[rr][tx + j * TX];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
    if (kt == 0 && tid < GN) {
#pragma unroll
      for (int rr = 0; rr < BR; ++rr) bacc += Ds[rr][tid];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + i * TY;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) P[(size_t)k * N + n] = acc[i][j];
    }
  }
  if (kt == 0 && tid < GN && n0 + tid < N) Pb[n0 + tid] = bacc;
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

int rows_smem_bytes(const int* dims, int n_layers, int* ld_out) {
  int kmax = 0;
  for (int l = 0; l <= n_layers; ++l) kmax = dims[l] > kmax ? dims[l] : kmax;
  const int ld = round_up(kmax, BK) + 1;
  if (ld_out) *ld_out = ld;
  return (2 * BM * ld + BK * WLD) * (int)sizeof(float);
}

// Fills everything but the pointers; returns the floats of scratch (Z and D).
int64_t plan(const int* dims, int n_layers, int n_rows, BwdArgs* a) {
  for (int l = 0; l <= n_layers; ++l) a->dims[l] = dims[l];
  a->n_layers = n_layers;
  a->n_rows = n_rows;
  int64_t total = 0;
  a->items[0] = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int K = dims[l], N = dims[l + 1];
    a->off[l] = total;
    total += (int64_t)K * N + N;
    const int tiles = N <= NARROW ? cdiv(K, NK) : cdiv(K, GK) * cdiv(N, GN);
    a->items[l + 1] = a->items[l] + tiles;
  }
  a->total = total;
  int splits = cdiv(kTargetBlocks, a->items[n_layers]);
  splits = splits < kMaxSplits ? splits : kMaxSplits;
  const int by_rows = n_rows / kMinRowsPerSplit;
  splits = splits < by_rows ? splits : by_rows;
  splits = splits > 1 ? splits : 1;
  a->rows_per_split = round_up(cdiv(n_rows, splits), BR);
  a->splits = cdiv(n_rows, a->rows_per_split);
  int64_t scratch = 0;
  for (int l = 0; l < n_layers; ++l) scratch += (int64_t)n_rows * dims[l + 1] * (l < n_layers - 1 ? 2 : 1);
  rows_smem_bytes(dims, n_layers, &a->ld);
  return scratch;
}

}  // namespace

extern "C" {

int sst_fused_mlp_bwd_max_layers() { return kMaxLayers; }

int sst_fused_mlp_bwd_smem_limit() { return kSmemLimit; }

// out[0] = partial splits, out[1] = floats of the flat result (dW_0, db_0,
// dW_1, db_1, ...), out[2] = floats of scratch, out[3] = shared memory of
// the rows kernel in bytes.
void sst_fused_mlp_bwd_workspace(const void* dims, int n_layers, int n_rows, int64_t* out) {
  BwdArgs a;
  const int64_t scratch = plan(static_cast<const int*>(dims), n_layers, n_rows, &a);
  out[0] = a.splits;
  out[1] = a.total;
  out[2] = scratch;
  out[3] = rows_smem_bytes(static_cast<const int*>(dims), n_layers, nullptr);
}

// x [n_rows, dims[0]], g [n_rows, dims[n_layers]], dx (may be null) like x;
// w_ptrs / b_ptrs: host arrays of device pointers to W_l and b_l; scratch,
// partial and result are device buffers of the sizes the workspace call
// gives (scratch and partial floats, result `total` floats). All f32 and
// contiguous; dims is a host int32 array. Enqueues three kernels on
// `stream` and returns the first CUDA error.
int sst_fused_mlp_bwd(const void* x, const void* g, void* dx, const void* w_ptrs,
                      const void* b_ptrs, void* scratch, void* partial, void* result,
                      const void* dims, int n_layers, int n_rows, int act, int out_act,
                      void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows < 1) return (int)cudaErrorInvalidValue;
  const int* d = static_cast<const int*>(dims);
  BwdArgs a;
  plan(d, n_layers, n_rows, &a);
  const uint64_t* wp = static_cast<const uint64_t*>(w_ptrs);
  const uint64_t* bp = static_cast<const uint64_t*>(b_ptrs);
  float* s = static_cast<float*>(scratch);
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = reinterpret_cast<const float*>(wp[l]);
    a.b[l] = reinterpret_cast<const float*>(bp[l]);
    if (l < n_layers - 1) {
      a.z[l] = s;
      s += (size_t)n_rows * d[l + 1];
    } else {
      a.z[l] = nullptr;
    }
  }
  for (int l = 0; l < n_layers; ++l) {
    a.d[l] = s;
    s += (size_t)n_rows * d[l + 1];
  }
  a.act = act;
  a.out_act = out_act;
  const int smem = rows_smem_bytes(d, n_layers, nullptr);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = 2 * (smem + kSmemPerBlockReserved) <= kSmemPerSM;
  auto rows_kernel = two ? fused_mlp_bwd_rows_kernel<2> : fused_mlp_bwd_rows_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<cdiv(n_rows, BM), THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dx), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_mlp_bwd_dw_kernel<<<dim3(a.items[n_layers], a.splits), THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(partial), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((a.total + THREADS - 1) / THREADS);
  fused_mlp_bwd_reduce_kernel<<<blocks < 1024 ? blocks : 1024, THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(result), a.splits, a.total);
  return (int)cudaGetLastError();
}

}  // extern "C"
