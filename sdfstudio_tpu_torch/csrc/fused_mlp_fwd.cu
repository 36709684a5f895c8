// Fully-fused MLP forward for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel sdfstudio_tpu/ops/pallas_mlp.py::_fwd_kernel
// (launched by _fused_mlp_padded_fwd, public entry fused_mlp):
//     y = out_act(act(...act(x @ W0 + b0)...) @ Wn + bn)
// with act in {none, relu, softplus100}, accumulated in f32 as the TPU kernel
// does at Precision.HIGHEST.
//
// What bounds it on an H100: arithmetic. At the render path's shapes (color
// net 321->256->256->3, proposal nets 39|51->128->128->1) each row costs
// 2 * sum(d_i * d_{i+1}) = 43k..297k FLOP against 4 * (d_in + d_out) bytes of
// HBM traffic, i.e. 140..900 FLOP per byte, far above the FP32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). So the design keeps every
// intermediate activation on chip and spends its effort on the FMA loop:
//   * one block owns BM = 64 rows; their activations live in shared memory
//     (two ping-pong buffers of BM x ld floats) for the whole layer chain,
//     so HBM sees one read of x and one write of y, as on the TPU;
//   * the TPU kernel holds all weights in VMEM; the color net's 580 KB of
//     f32 weights do not fit the 227 KB a block may use, so each layer's
//     weights are streamed through shared memory in BK x NC slices, with
//     the next slice prefetched into registers while the current one runs;
//   * 256 threads, each accumulating a 4 x 8 register tile (rows strided by
//     16, columns strided by 16, so shared-memory reads are conflict free);
//   * layers with at most NARROW outputs (the heads: 1 or 3 columns) take a
//     row-dot path, 4 threads per row and a warp-shuffle reduction, instead
//     of wasting a 128-column tile;
//   * only the tile is padded (K to BK, rows to BM); ragged edges are masked.
// Tensor cores (TF32/bf16 wgmma) and TMA are later work: this version is the
// plain FP32 reference point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int BM = 64;         // rows per block
constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid
constexpr int TM = 4, TN = 8;    // per-thread tile: rows ty + 16 i, cols tx + 16 j
constexpr int NC = TX * TN;      // 128 output columns per pass
constexpr int BK = 16;           // K depth of a weight slice
constexpr int WREG = BK * NC / THREADS;  // 8 prefetch registers per thread
constexpr int NARROW = 8;        // N <= NARROW -> row-dot path
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

static_assert(TY * TM == BM, "thread grid must cover the row block");
static_assert(BM * 4 == THREADS, "row-dot path uses 4 threads per row");

struct MlpArgs {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dims[kMaxLayers + 1];
  int n_layers;
  int n_rows;
  int act;
  int out_act;
  int ld;  // row stride (floats) of the activation buffers
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// 0 = none, 1 = relu, 2 = softplus(100 v) / 100 (pallas_mlp.py:70-82)
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) {
    const float t = 100.f * v;
    return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) * 0.01f;
  }
  return v;
}

__device__ __forceinline__ void load_w_slice(float (&r)[WREG], const float* __restrict__ W,
                                             int K, int N, int k0, int n0, int tid) {
#pragma unroll
  for (int s = 0; s < WREG; ++s) {
    const int i = tid + s * THREADS;
    const int k = k0 + i / NC, n = n0 + i % NC;
    r[s] = (k < K && n < N) ? __ldg(W + (size_t)k * N + n) : 0.f;
  }
}

__device__ __forceinline__ void store_w_slice(const float (&r)[WREG], float* wt, int tid) {
#pragma unroll
  for (int s = 0; s < WREG; ++s) wt[tid + s * THREADS] = r[s];
}

__global__ void __launch_bounds__(THREADS)
fused_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ y, const MlpArgs a) {
  extern __shared__ float smem[];
  const int ld = a.ld;
  float* in = smem;
  float* out = smem + BM * ld;
  float* wt = smem + 2 * BM * ld;  // [BK][NC]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, a.n_rows - row0);

  // x block -> shared memory; columns d_in .. round_up(d_in, BK) and rows
  // past the ragged edge are zero so the K loop needs no masks
  {
    const int d_in = a.dims[0];
    const int kp = round_up(d_in, BK);
    for (int i = tid; i < BM * kp; i += THREADS) {
      const int r = i / kp, c = i % kp;
      in[r * ld + c] = (r < rows && c < d_in) ? x[(size_t)(row0 + r) * d_in + c] : 0.f;
    }
  }
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  for (int l = 0; l < a.n_layers; ++l) {
    const int K = a.dims[l], N = a.dims[l + 1];
    const bool last = (l == a.n_layers - 1);
    const int act = last ? a.out_act : a.act;
    const float* __restrict__ W = a.w[l];
    const float* __restrict__ B = a.b[l];

    if (N <= NARROW) {
      // row-dot path: thread (r, part) sums k = part, part + 4, ...
      const int r = tid >> 2, part = tid & 3;
      float acc[NARROW];
#pragma unroll
      for (int j = 0; j < NARROW; ++j) acc[j] = 0.f;
      for (int k = part; k < K; k += 4) {
        const float av = in[r * ld + k];
#pragma unroll
        for (int j = 0; j < NARROW; ++j)
          if (j < N) acc[j] = fmaf(av, __ldg(W + (size_t)k * N + j), acc[j]);
      }
#pragma unroll
      for (int j = 0; j < NARROW; ++j) {
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 2);
      }
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < NARROW; ++j) {
          if (j < N) {
            const float v = apply_act(acc[j] + __ldg(B + j), act);
            if (last) {
              if (r < rows) y[(size_t)(row0 + r) * N + j] = v;
            } else {
              out[r * ld + j] = v;
            }
          }
        }
      }
    } else {
      for (int n0 = 0; n0 < N; n0 += NC) {
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

        float wr[WREG];
        load_w_slice(wr, W, K, N, 0, n0, tid);
        store_w_slice(wr, wt, tid);
        __syncthreads();
        for (int k0 = 0; k0 < K; k0 += BK) {
          const bool more = k0 + BK < K;
          if (more) load_w_slice(wr, W, K, N, k0 + BK, n0, tid);  // in flight during the FMAs
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) {
            float av[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = in[(ty + i * TY) * ld + k0 + kk];
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = wt[kk * NC + tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
          __syncthreads();
          if (more) {
            store_w_slice(wr, wt, tid);
            __syncthreads();
          }
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tx + j * TX;
          if (n < N) {
            const float bias = __ldg(B + n);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const int r = ty + i * TY;
              const float v = apply_act(acc[i][j] + bias, act);
              if (last) {
                if (r < rows) y[(size_t)(row0 + r) * N + n] = v;
              } else {
                out[r * ld + n] = v;
              }
            }
          }
        }
      }
    }

    if (!last) {
      // zero the K padding of the next layer's input
      const int pad = round_up(N, BK) - N;
      for (int i = tid; i < BM * pad; i += THREADS) out[(i / pad) * ld + N + i % pad] = 0.f;
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
}

int smem_bytes_for(const int* dims, int n_layers, int* ld_out) {
  int kmax = 0;
  for (int l = 0; l < n_layers; ++l) kmax = dims[l] > kmax ? dims[l] : kmax;
  const int ld = round_up(kmax, BK) + 1;  // odd stride: rows ty and ty+1 hit different banks
  if (ld_out) *ld_out = ld;
  return (2 * BM * ld + BK * NC) * (int)sizeof(float);
}

}  // namespace

extern "C" {

// Shared memory one launch needs for these widths, in bytes; the wrapper
// refuses widths above the card's per-block limit with it.
int sst_fused_mlp_fwd_smem_bytes(const void* dims, int n_layers) {
  return smem_bytes_for(static_cast<const int*>(dims), n_layers, nullptr);
}

int sst_fused_mlp_fwd_smem_limit() { return kSmemLimit; }

int sst_fused_mlp_fwd_max_layers() { return kMaxLayers; }

// x [n_rows, dims[0]] and y [n_rows, dims[n_layers]] are device pointers;
// w_ptrs / b_ptrs are host arrays of n_layers device pointers to W_l
// [dims[l], dims[l+1]] and b_l [dims[l+1]], all f32 and contiguous; dims is
// a host int32 array. Enqueues on `stream` and returns cudaGetLastError().
int sst_fused_mlp_fwd(const void* x, void* y, const void* w_ptrs, const void* b_ptrs,
                      const void* dims, int n_layers, int n_rows, int act, int out_act,
                      void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows < 1) return (int)cudaErrorInvalidValue;
  MlpArgs a;
  const int* d = static_cast<const int*>(dims);
  const uint64_t* wp = static_cast<const uint64_t*>(w_ptrs);
  const uint64_t* bp = static_cast<const uint64_t*>(b_ptrs);
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = reinterpret_cast<const float*>(wp[l]);
    a.b[l] = reinterpret_cast<const float*>(bp[l]);
  }
  for (int l = 0; l <= n_layers; ++l) a.dims[l] = d[l];
  a.n_layers = n_layers;
  a.n_rows = n_rows;
  a.act = act;
  a.out_act = out_act;
  const int smem = smem_bytes_for(d, n_layers, &a.ld);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + BM - 1) / BM;
  fused_mlp_fwd_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), a);
  return (int)cudaGetLastError();
}

}  // extern "C"
