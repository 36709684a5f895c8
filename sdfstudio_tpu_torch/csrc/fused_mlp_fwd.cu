// Fully-fused MLP forward for Hopper (sm_90a): 3xTF32 on the tensor cores
// (wgmma), weights staged by the TMA unit.
//
// Replaces the Pallas TPU kernel sdfstudio_tpu/ops/pallas_mlp.py::_fwd_kernel
// (launched by _fused_mlp_padded_fwd, public entry fused_mlp):
//     y = out_act(act(...act(x @ W0 + b0)...) @ Wn + bn)
// with act in {none, relu, softplus100}, at f32 accuracy as the TPU kernel's
// Precision.HIGHEST promises (3xTF32, tf32_mma.cuh).
//
// What bounds it on an H100: arithmetic. At the render path's shapes (color
// net 321->256->256->3, proposal nets 39|51->128->128->1) each row costs
// 2 * sum(d_i * d_{i+1}) = 43k..297k FLOP against 4 * (d_in + d_out) bytes of
// HBM traffic, 140..900 FLOP per byte. In 3xTF32 the tensor cores do three
// passes of 495 TFLOP/s, 165 TFLOP/s of f32-accurate products, whose ridge
// at 3.35 TB/s is ~50 FLOP per byte: still bound by operations.
//
// Design (fused_mlp_chain.cuh): one launch of split_kernel writes every
// layer's W^T once, split into tf32 hi and lo in the wgmma layout; then one
// block per 128 rows keeps its activations in shared memory for the whole
// chain (HBM sees one read of x and one write of y, as on the TPU), the
// producer warp streams the weight slices through a ring of 2-8 stages with
// bulk copies under mbarriers, and two consumer warpgroups multiply them
// with wgmma m64n64k8 tf32 (A, the activations, from registers); the bias
// rides in the product as one more k row, and the activation is applied in
// the accumulator's registers. The heads (1 or 3 columns, under 1% of the
// FLOPs) take one 64-column tile.

#include "fused_mlp_chain.cuh"

namespace {

using namespace sst;

template <int MAXT>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_fwd_kernel(const __grid_constant__ ChainArgs a) {
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
  // per tile: the accumulator already holds the bias (plan_chain's bias
  // row); apply the activation, then y, or the next layer's input in place
  auto epi = [&](const Job& jb, int T, const float(&acc)[32], int ww, int ln) {
    const int N = jb.N, col0 = (jb.t0 + T) * TILE_N;
    if (jb.kind == kFwdLast) {
      float* y = jb.out;
      with_act(out, [&](auto A) {
        tile_pairs(acc, ww, ln, col0, [&](int, int r, int c, float v0, float v1) {
          if (row0 + r >= n_rows) return;
          float* dst = y + (size_t)(row0 + r) * N + c;
          if (c < N) dst[0] = apply_act(v0, decltype(A)::value);
          if (c + 1 < N) dst[1] = apply_act(v1, decltype(A)::value);
        });
      });
    } else {
      with_act(hid, [&](auto A) {
        tile_pairs(acc, ww, ln, col0, [&](int, int r, int c, float v0, float v1) {
          const uint32_t dst = act_s + (uint32_t)(r * ld + c) * 4;
          if (c + 1 < N) {
            sts2(dst, apply_act(v0, decltype(A)::value), apply_act(v1, decltype(A)::value));
          } else if (c < N) {
            sts(dst, apply_act(v0, decltype(A)::value));
          }
        });
      });
    }
  };
  auto fix = [](const Job&, auto&, int, int) {};
  consume<MAXT>(a, act, ring, wwarp, lane, fix, epi);
}

template <int MAXT>
cudaError_t launch(const ChainPlan& p, cudaStream_t st) {
  auto kern = fused_mlp_fwd_kernel<MAXT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<cdiv(p.args.n_rows, BM), THREADS, p.smem, st>>>(p.args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sst_fused_mlp_fwd_max_layers() { return kMaxLayers; }

int sst_fused_mlp_fwd_smem_limit() { return kSmemLimit; }

int sst_fused_mlp_fwd_max_width() { return TILE_N * kMaxTiles; }

// out[0] = floats of the split scratch, out[1] = shared memory of a block in
// bytes, out[2] = status (0 ok, 1 too many layers, 2 a hidden width above
// sst_fused_mlp_fwd_max_width()).
void sst_fused_mlp_fwd_workspace(const void* dims, int n_layers, int64_t* out) {
  const ChainPlan p = plan_chain(static_cast<const int*>(dims), n_layers, false, false);
  out[0] = p.split_floats;
  out[1] = p.smem;
  out[2] = p.status;
}

// x [n_rows, dims[0]] and y [n_rows, dims[n_layers]] are device pointers;
// w_ptrs / b_ptrs are host arrays of n_layers device pointers to W_l
// [dims[l], dims[l+1]] and b_l [dims[l+1]], all f32 and contiguous; split is
// a device scratch of the floats the workspace call gives; dims is a host
// int32 array. Enqueues the split pre-pass and the chain on `stream` and
// returns the first CUDA error.
int sst_fused_mlp_fwd(const void* x, void* y, const void* w_ptrs, const void* b_ptrs, void* split,
                      const void* dims, int n_layers, int n_rows, int act, int out_act,
                      void* stream) {
  if (n_rows < 1) return (int)cudaErrorInvalidValue;
  ChainPlan p = plan_chain(static_cast<const int*>(dims), n_layers, false, false);
  if (p.status != 0 || p.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  bind_chain(p, w_ptrs, b_ptrs, static_cast<float*>(split));
  p.args.n_rows = n_rows;
  p.args.act = act;
  p.args.out_act = out_act;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split(p, st);
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < p.args.n_jobs; ++j)
    if (p.args.jobs[j].kind == kFwdLast) p.args.jobs[j].out = static_cast<float*>(y);
  p.args.init = static_cast<const float*>(x);
  p.args.init_w = p.args.dims[0];
  p.args.init_ones = 1;
  err = p.maxt == 2 ? launch<2>(p, st) : p.maxt == 4 ? launch<4>(p, st) : launch<5>(p, st);
  return (int)err;
}

}  // extern "C"
