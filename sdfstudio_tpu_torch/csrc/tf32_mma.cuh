// Hopper (sm_90a) building blocks of the fused-MLP kernels: 3xTF32
// products on the tensor cores (wgmma), bulk copies into shared memory
// under mbarriers, and the activations of pallas_mlp.py.
//
// 3xTF32. A tensor-core product of tf32 values keeps 10 of f32's 23
// mantissa bits per operand; summed over K = 256 its error is ~1e-3 of the
// result, where the TPU kernel's Precision.HIGHEST (pallas_mlp.py:62-66)
// promises f32. Each f32 operand v is therefore split into
//     hi = tf32(v),  lo = tf32(v - hi)        (cvt.rna: nearest, ties away)
// which together carry ~21 bits, and a product is taken as
//     a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b
// into one f32 accumulator, small terms first. The dropped lo_a lo_b is
// ~2^-22 of a b. Each term is one tf32 tensor-core pass, so the product
// costs three passes: 3 x 2 K FLOP per output at 495 TFLOP/s dense tf32,
// i.e. 165 TFLOP/s of f32-accurate products, 2.5x the 67 TFLOP/s of the
// FP32 cores the kernels used before.
//
// Shared-memory operands use wgmma's layout without swizzle, K-major: a
// "core matrix" is 8 rows (M or N) x 4 tf32 (16 bytes of K) stored as 128
// contiguous bytes. The kernels store a tile of R rows by one k8 step as
// [R / 8][2][8][4] floats: the two core matrices of a row group (k 0-3,
// k 4-7) 128 bytes apart (the descriptor's leading byte offset), row
// groups 256 bytes apart (its stride byte offset).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sst {

// 0 = none, 1 = relu, 2 = softplus(100 v) / 100 (pallas_mlp.py:70-82)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// nearest tf32 (ties away from zero), as an f32 bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// ---- mbarriers and bulk copies ------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of the given parity has completed. A wait of ~10 s
// (2^34 cycles) can only be a broken protocol: trap, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// global -> shared copy by the TMA unit of `bytes` (a multiple of 16, both
// addresses 16-byte aligned); completes `bytes` of the barrier's transaction
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// volatile, without a memory clobber: the kernels touch shared memory only
// through these and other volatile asm statements, which keep their order
__device__ __forceinline__ void sts(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v));
}

__device__ __forceinline__ void sts2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a), "f"(b));
}

// calls f(std::integral_constant-like tag) with the activation as a
// compile-time constant, so a loop over elements branches once
template <int V>
struct Const {
  static constexpr int value = V;
};
template <class F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  if (act == 1) {
    f(Const<1>{});
  } else if (act == 2) {
    f(Const<2>{});
  } else {
    f(Const<0>{});
  }
}

// 4-byte global -> shared copy that does not pass through registers; with
// `valid` false it writes 0 and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// 16-byte global -> shared copy; bytes past `bytes` (0..16) are written 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// shared-memory writes of this thread become visible to the async proxy
// (wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]));
}

// shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two core matrices of a k8 step) and stride byte
// offset (between row groups of 8), all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_u32(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

constexpr uint32_t kLBO = 128;  // bytes between the k 0-3 and k 4-7 core matrices
constexpr uint32_t kSBO = 256;  // bytes between row groups of 8

// D[64 x 64] = A[64 x 8] B[8 x 64] (+ D with accumulate): A from registers
// (tf32 fragment), B by descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t bdesc,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,  "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35},  "
      "%36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(accumulate)
      : "memory");
}

// D[64 x 128] += A[64 x 8] B[8 x 128]: both operands by descriptor
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,  "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36,  "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54,  "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(1)
      : "memory");
}

}  // namespace sst
