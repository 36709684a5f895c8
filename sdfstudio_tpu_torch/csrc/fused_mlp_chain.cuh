// The layer chain shared by the fused-MLP forward kernel and the backward's
// rows kernel: a block of 128 rows walks a list of layer products ("jobs")
// whose activations stay in shared memory, with the weights streamed
// through a ring of stages by the TMA unit and multiplied on the tensor
// cores in 3xTF32 (tf32_mma.cuh).
//
// Block: warps 0-3 and 4-7 are two consumer warpgroups, each owning 64 rows;
// warp 8 is the producer. Each consumer warp only ever reads and writes its
// own 16 rows of activations: the A operand of a wgmma comes from registers
// (the warp's rows), and its accumulator holds the same rows, so a layer's
// output overwrites its input in place and no two warps share a row. The
// block's only shared resource is the weight ring.
//
// Weights. A pre-pass (split_kernel) writes each layer's matrix once per
// call, split into tf32 hi and lo, in the wgmma layout (tf32_mma.cuh): for
// k8 step s, [np / 8][2][8][4] floats, where np is the output width rounded
// up to a multiple of 64. One ring stage is one k8 step of a pass's output
// tiles, hi and lo, two contiguous bulk copies. The producer walks every
// job's k8 steps in order, so the next layer's first slices arrive while the
// current layer's epilogue runs.
//
// Products. Per k8 step each warpgroup issues 3 x nt wgmma m64n64k8 (lo*hi,
// hi*lo, hi*hi) into nt accumulators of 64 columns; the heads (1 or 3
// columns) take one tile. A job that writes its output back to shared
// memory must finish in one pass (nt <= MAXT tiles, so widths up to 64 *
// kMaxTiles); one that writes to device memory (y, dx) may take several.
// The bias rides in the product: each forward layer's split operand has one
// more k row, b, and its input one more column, 1, so the epilogue reads
// nothing from device memory but what the backward needs (g, Z).
//
// Shared memory of the color net (321 -> 256 -> 256 -> 3), per block:
//   activations 2 x 64 rows x ld 332 floats        169,984 B
//   3 ring stages x (4 tiles x 64 x 8 floats) x 2   49,152 B
//   barriers                                            128 B
//   total                                          219,264 B of 232,448
// ld = round_up(widest width, 8) + 4 keeps the A-fragment loads free of
// bank conflicts (rows g = 0..7 land 4 banks apart).
#pragma once

#include "tf32_mma.cuh"

namespace sst {

constexpr int kMaxLayers = 16;
constexpr int kMaxJobs = 40;
constexpr int kMaxOps = 2 * kMaxLayers;
constexpr int kMaxStages = 8;
constexpr int WG_ROWS = 64;                       // rows of one consumer warpgroup
constexpr int CONSUMER_WGS = 2;
constexpr int BM = WG_ROWS * CONSUMER_WGS;        // rows of a block
constexpr int CONSUMER_WARPS = 4 * CONSUMER_WGS;
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // + the producer warp
constexpr int TILE_N = 64;                        // output columns of one wgmma
constexpr int TILE_FLOATS = TILE_N * 8;           // one tile of one k8 step
constexpr int kMaxTiles = 5;                      // widest in-place output: 320 columns
constexpr int kSmemLimit = 232448;                // bytes a block may use on sm_90
constexpr int kBarBytes = 16 * kMaxStages;  // a full and an empty barrier per stage

// what a job's epilogue does (the kernels interpret it)
enum JobKind { kFwdHidden = 0, kFwdLast = 1, kDelta = 2, kDx = 3 };

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int cdiv(int v, int m) { return (v + m - 1) / m; }

struct Job {
  int hi, lo;    // float offsets of the split operand in the scratch
  int k8;        // k8 steps, i.e. ring stages
  int np;        // output width of the operand layout (a multiple of 64)
  int t0, nt;    // this pass's first 64-column tile and its tile count
  int K, N;      // contraction and output width
  int kind;      // JobKind
  int layer;
  int out_smem;  // the output replaces the activations in shared memory
  float* out;    // device memory the epilogue writes (y, Z, D or dx), if any
  const float* in;  // device memory the epilogue reads (g or Z), if any
  const float* w;     // W_l and b_l, for the backward's exact recompute
  const float* bias;
};

struct ChainArgs {
  Job jobs[kMaxJobs];
  const float* split;  // the split operands
  // the rows the chain starts from, [n_rows, init_w] (x, or the backward's
  // last delta); with init_ones a column of 1 follows them (the bias input)
  const float* init;
  int init_w, init_ones;
  int* fix_list;   // backward: rows whose forward is recomputed exactly,
  int* fix_count;  // appended in no particular order
  int dims[kMaxLayers + 1];
  int n_jobs, n_layers, n_rows, act, out_act, ld, stages;
};

// ---- the split pre-pass ----------------------------------------------------

struct SplitOp {
  const float* w;
  const float* bias;  // forward ops: row k_dim of the operand is b
  int layer;
  int wn;     // row stride of W (its output width)
  int trans;  // element (n, k) is W[n][k] (1) or W[k][n] (0)
  int k_dim, n_dim, np;
  int hi, lo, elems;
};

struct SplitArgs {
  SplitOp ops[kMaxOps];
  float* out;
  int n_ops;
};

// one op per blockIdx.y; writes hi and lo in the wgmma layout, zero outside
// the matrix (static: each source that includes this header has its own)
static __global__ void split_kernel(const __grid_constant__ SplitArgs a) {
  const SplitOp& op = a.ops[blockIdx.y];
  const int slice = op.np * 8;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < op.elems; e += gridDim.x * blockDim.x) {
    const int s = e / slice, rem = e - s * slice;
    const int w64 = rem & 63;
    const int n = (rem >> 6) * 8 + ((w64 & 31) >> 2);
    const int k = s * 8 + (w64 >> 5) * 4 + (w64 & 3);
    float v = 0.f;
    if (n < op.n_dim && k < op.k_dim)
      v = op.trans ? op.w[(size_t)n * op.wn + k] : op.w[(size_t)k * op.wn + n];
    else if (n < op.n_dim && k == op.k_dim && op.bias != nullptr)
      v = op.bias[n];
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    a.out[op.hi + e] = __uint_as_float(hi);
    a.out[op.lo + e] = __uint_as_float(lo);
  }
}

// ---- the block's roles -------------------------------------------------------

struct Ring {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int stage_floats;  // hi half, then lo half
};

// producer (one thread): every wide job's k8 steps, in order
__device__ __forceinline__ void produce(const ChainArgs& a, const Ring& ring) {
  uint32_t use = 0;
  for (int j = 0; j < a.n_jobs; ++j) {
    const Job& jb = a.jobs[j];
    const uint32_t bytes = (uint32_t)(jb.nt * TILE_FLOATS * 4);
    for (int s = 0; s < jb.k8; ++s, ++use) {
      const int slot = (int)(use % (uint32_t)ring.stages);
      const uint32_t round = use / (uint32_t)ring.stages;
      mbar_wait(&ring.empty[slot], (round & 1) ^ 1);
      mbar_arrive_expect_tx(&ring.full[slot], 2 * bytes);
      float* st = ring.buf + (size_t)slot * ring.stage_floats;
      const size_t off = ((size_t)s * jb.np + (size_t)jb.t0 * TILE_N) * 8;
      bulk_g2s(st, a.split + jb.hi + off, bytes, &ring.full[slot]);
      bulk_g2s(st + ring.stage_floats / 2, a.split + jb.lo + off, bytes, &ring.full[slot]);
    }
  }
}

// this warp's 16 rows of the chain's input [n_rows, w] into shared memory
// by cp.async (every load in flight at once). With `ones`, column w holds 1,
// the input that multiplies the bias row of W (see plan_chain); columns up
// to round_up(w + ones, 8) and rows past n_rows hold 0, so the k8 steps need
// no masks.
__device__ __forceinline__ void load_rows(const float* __restrict__ x, int w, bool ones, float* act,
                                          int ld, int row0, int n_rows, int wwarp, int lane) {
  const int kp = round_up(w + (ones ? 1 : 0), 8);
  const uint32_t base = smem_u32(act + wwarp * 16 * ld);
  for (int r = 0; r < 16; ++r) {
    const int gr = row0 + wwarp * 16 + r;
    const float* src = x + (size_t)gr * w;
    for (int c = lane; c < kp; c += 32) {
      const bool valid = gr < n_rows && c < w;
      cp_async4(base + (uint32_t)(r * ld + c) * 4, valid ? src + c : x, valid);
    }
  }
  cp_async_wait_all();
  __syncwarp();
  if (ones && lane < 16) sts(base + (uint32_t)(lane * ld + w) * 4, 1.f);
  __syncwarp();
}

// the accumulator of m64nN: element 4 j + 2 h + e holds row g + 8 h,
// column 8 j + 2 t + e of the warp's 16 x N block (g = lane / 4, t = lane %
// 4). f(p, row, col, v0, v1) gets the 16 pairs (col, col + 1) of one
// 64-column tile; rows count from the warpgroup's first row.
template <class F>
__device__ __forceinline__ void tile_pairs(const float (&acc)[32], int wwarp, int lane, int col0,
                                           F&& f) {
  const int row = wwarp * 16 + (lane >> 2), col = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f(2 * j, row, col + 8 * j, acc[4 * j], acc[4 * j + 1]);
    f(2 * j + 1, row + 8, col + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void load_frag(uint32_t r0, uint32_t r1, int s, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  // A fragment of m64nNk8 tf32: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  const uint32_t k = 32 * s;
  split_tf32(lds(r0 + k), hi[0], lo[0]);
  split_tf32(lds(r1 + k), hi[1], lo[1]);
  split_tf32(lds(r0 + k + 16), hi[2], lo[2]);
  split_tf32(lds(r1 + k + 16), hi[3], lo[3]);
}

// One pass of a job for this warp's 16 rows: the k8 steps off the ring (the
// next step's A fragment is read while the current products run), then
// fix(job, acc, wwarp, lane) on all tiles and epi(job, T, acc[T], wwarp,
// lane) for each of the pass's tiles. NT is the
// job's tile count or, for a pass of fewer tiles than a stage holds, MAXT:
// the extra products take stale stage data into accumulators that are then
// discarded, which keeps the instantiations to two per kernel.
template <int NT, class Fix, class Epi>
__device__ __forceinline__ void wide_job(const Job& job, float* act, int ld, const Ring& ring,
                                         uint32_t& use, int wwarp, int lane, Fix& fix, Epi& epi) {
  const Job jb = job;  // in registers
  constexpr bool kPromote = NT <= 2;
  float acc[NT][32];
  float part[NT][32];  // unused (and removed by the compiler) unless kPromote
#pragma unroll
  for (int T = 0; T < NT; ++T)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[T][i] = 0.f;
  const uint32_t r0 = smem_u32(act + (wwarp * 16 + (lane >> 2)) * ld + (lane & 3));
  const uint32_t r1 = r0 + 8 * ld * 4;
  uint32_t ahi[4], alo[4];
  load_frag(r0, r1, 0, ahi, alo);
  for (int s = 0; s < jb.k8; ++s, ++use) {
    const int slot = (int)(use % (uint32_t)ring.stages);
    const uint32_t parity = (use / (uint32_t)ring.stages) & 1;
    mbar_wait(&ring.full[slot], parity);
    const float* bhi = ring.buf + (size_t)slot * ring.stage_floats;
    const float* blo = bhi + ring.stage_floats / 2;
    // the tensor cores round each wgmma's sum toward zero, which biases a
    // long f32 sum by ~1e-8 K of its value (K = 320: 3e-6). Where the
    // registers allow (NT <= 2), each k8 step's products go to `part` and
    // are added to acc on the CUDA cores, rounded to nearest as f32 does.
    auto products = [&](float (&d)[NT][32], int accumulate) {
#pragma unroll
      for (int T = 0; T < NT; ++T) fence_regs(d[T]);
      wgmma_fence();
#pragma unroll
      for (int T = 0; T < NT; ++T)
        wgmma_rs_n64(d[T], alo, make_desc(bhi + T * TILE_FLOATS, kLBO, kSBO), accumulate);
#pragma unroll
      for (int T = 0; T < NT; ++T) wgmma_rs_n64(d[T], ahi, make_desc(blo + T * TILE_FLOATS, kLBO, kSBO));
#pragma unroll
      for (int T = 0; T < NT; ++T) wgmma_rs_n64(d[T], ahi, make_desc(bhi + T * TILE_FLOATS, kLBO, kSBO));
      wgmma_commit();
    };
    if constexpr (kPromote) {
      products(part, 0);
    } else {
      products(acc, 1);
    }
    uint32_t nhi[4], nlo[4];
    if (s + 1 < jb.k8) load_frag(r0, r1, s + 1, nhi, nlo);
    wgmma_wait<0>();
#pragma unroll
    for (int T = 0; T < NT; ++T) {
      fence_regs(acc[T]);
      if constexpr (kPromote) fence_regs(part[T]);
    }
    if constexpr (kPromote) {
#pragma unroll
      for (int T = 0; T < NT; ++T)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[T][i] += part[T][i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[slot]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ahi[i] = nhi[i];
      alo[i] = nlo[i];
    }
  }
  fix(jb, acc, wwarp, lane);  // before any tile overwrites the input in place
#pragma unroll
  for (int T = 0; T < NT; ++T) {
    if (T >= jb.nt) break;
    epi(jb, T, acc[T], wwarp, lane);
  }
  if (jb.out_smem) {
    // the next job's K padding: 1 in column N after a forward layer (the
    // input of the next bias row), 0 up to round_up(N + 1, 8)
    const int pad = round_up(jb.N + 1, 8) - jb.N;
    const uint32_t base = smem_u32(act + wwarp * 16 * ld + jb.N);
    for (int i = lane; i < 16 * pad; i += 32) {
      const int r = i / pad, c = i - r * pad;
      sts(base + (uint32_t)(r * ld + c) * 4, (c == 0 && jb.kind == kFwdHidden) ? 1.f : 0.f);
    }
  }
}

// a consumer warp's walk over the jobs
template <int MAXT, class Fix, class Epi>
__device__ __forceinline__ void consume(const ChainArgs& a, float* act, const Ring& ring,
                                        int wwarp, int lane, Fix& fix, Epi& epi) {
  uint32_t use = 0;
  for (int j = 0; j < a.n_jobs; ++j) {
    const Job& jb = a.jobs[j];
    if (jb.nt == 1) {
      wide_job<1>(jb, act, a.ld, ring, use, wwarp, lane, fix, epi);
    } else {
      wide_job<MAXT>(jb, act, a.ld, ring, use, wwarp, lane, fix, epi);
    }
    __syncwarp();  // this job's outputs are the next job's A operand
  }
}

// barriers, ring and the warpgroup's activations inside the dynamic shared
// memory; thread 0 initialises the barriers
template <int MAXT>
__device__ __forceinline__ Ring setup_ring(unsigned char* smem, int stages) {
  Ring ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kMaxStages;
  ring.buf = reinterpret_cast<float*>(smem + kBarBytes);
  ring.stages = stages;
  ring.stage_floats = 2 * MAXT * TILE_FLOATS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  return ring;
}

// ---- host: the plan of one call -----------------------------------------

struct ChainPlan {
  ChainArgs args;
  SplitArgs split;
  int maxt = 2;
  int smem = 0;
  int64_t split_floats = 0;
  int status = 0;  // 0 ok; 1 too many layers or jobs; 2 an in-place width above 64 * kMaxTiles
};

// The jobs of the forward (bwd = false) or of the backward's rows kernel:
// the forward layers, then the delta chain back to layer 1, then dx.
inline ChainPlan plan_chain(const int* dims, int n_layers, bool bwd, bool need_dx) {
  ChainPlan p{};
  ChainArgs& a = p.args;
  if (n_layers < 1 || n_layers > kMaxLayers) {
    p.status = 1;
    return p;
  }
  struct Prod { int layer, trans, K, N, kind, out_smem; };
  Prod prods[2 * kMaxLayers + 1];
  int n_prods = 0;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    prods[n_prods++] = {l, 0, dims[l], dims[l + 1], last ? kFwdLast : kFwdHidden, (!last || bwd) ? 1 : 0};
  }
  if (bwd) {
    for (int l = n_layers - 1; l >= 1; --l) prods[n_prods++] = {l, 1, dims[l + 1], dims[l], kDelta, 1};
    if (need_dx) prods[n_prods++] = {0, 1, dims[1], dims[0], kDx, 0};
  }
  // widths in shared memory: every input with its K padding (a forward
  // layer's one more column for the bias), every in-place output with its
  int need = 1, width = 8;
  for (int i = 0; i < n_prods; ++i) {
    const Prod& q = prods[i];
    const int k_in = round_up(q.K + (q.trans ? 0 : 1), 8);
    width = width > k_in ? width : k_in;
    if (q.out_smem) {
      width = width > round_up(q.N + 1, 8) ? width : round_up(q.N + 1, 8);
      need = need > cdiv(q.N, TILE_N) ? need : cdiv(q.N, TILE_N);
    }
  }
  if (need > kMaxTiles) {
    p.status = 2;
    return p;
  }
  p.maxt = need <= 2 ? 2 : need <= 4 ? 4 : 5;
  int op_of[2][kMaxLayers];
  for (int l = 0; l < kMaxLayers; ++l) op_of[0][l] = op_of[1][l] = -1;
  int64_t off = 0;
  p.split.n_ops = 0;
  a.n_jobs = 0;
  for (int i = 0; i < n_prods; ++i) {
    const Prod& q = prods[i];
    const int np = round_up(q.N, TILE_N), k8 = cdiv(q.K + (q.trans ? 0 : 1), 8);
    int& op = op_of[q.trans][q.layer];
    if (op < 0) {
      op = p.split.n_ops++;
      SplitOp& so = p.split.ops[op];
      so.w = so.bias = nullptr;  // set by bind_chain
      so.layer = q.layer;
      so.wn = dims[q.layer + 1];
      so.trans = q.trans;
      so.k_dim = q.K;
      so.n_dim = q.N;
      so.np = np;
      so.elems = k8 * np * 8;
      so.hi = (int)off;
      so.lo = (int)(off + so.elems);
      off += 2 * (int64_t)so.elems;
    }
    Job jb{};
    jb.hi = p.split.ops[op].hi;
    jb.lo = p.split.ops[op].lo;
    jb.k8 = k8;
    jb.np = np;
    jb.K = q.K;
    jb.N = q.N;
    jb.kind = q.kind;
    jb.layer = q.layer;
    jb.out_smem = q.out_smem;
    const int tiles = np / TILE_N;
    for (int t0 = 0; t0 < tiles; t0 += p.maxt) {
      if (a.n_jobs >= kMaxJobs) {
        p.status = 1;
        return p;
      }
      jb.t0 = t0;
      jb.nt = tiles - t0 < p.maxt ? tiles - t0 : p.maxt;
      a.jobs[a.n_jobs++] = jb;
    }
  }
  p.split_floats = off;
  a.ld = width + 4;
  const int stage_bytes = 2 * p.maxt * TILE_FLOATS * 4;
  const int act_bytes = BM * a.ld * 4;
  int stages = (kSmemLimit - kBarBytes - act_bytes) / stage_bytes;
  stages = stages < kMaxStages ? stages : kMaxStages;
  a.stages = stages > 2 ? stages : 2;
  p.smem = kBarBytes + a.stages * stage_bytes + act_bytes;
  a.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) a.dims[l] = dims[l];
  return p;
}

// fills the pointers of a plan: W_l and b_l (host arrays of device
// pointers) into the split ops, and the split scratch
inline void bind_chain(ChainPlan& p, const void* w_ptrs, const void* b_ptrs, float* split) {
  const uint64_t* wp = static_cast<const uint64_t*>(w_ptrs);
  const uint64_t* bp = static_cast<const uint64_t*>(b_ptrs);
  for (int o = 0; o < p.split.n_ops; ++o) {
    SplitOp& so = p.split.ops[o];
    so.w = reinterpret_cast<const float*>(wp[so.layer]);
    so.bias = so.trans ? nullptr : reinterpret_cast<const float*>(bp[so.layer]);
  }
  p.args.split = split;
  p.split.out = split;
}

// enqueue the split pre-pass
inline cudaError_t launch_split(const ChainPlan& p, cudaStream_t st) {
  if (p.split.n_ops == 0) return cudaSuccess;
  int most = 0;
  for (int o = 0; o < p.split.n_ops; ++o) most = most > p.split.ops[o].elems ? most : p.split.ops[o].elems;
  int blocks = cdiv(most, 256);
  blocks = blocks < 64 ? blocks : 64;
  split_kernel<<<dim3(blocks, p.split.n_ops), 256, 0, st>>>(p.split);
  return cudaGetLastError();
}

}  // namespace sst
