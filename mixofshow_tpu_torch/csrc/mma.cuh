// Shared helpers for the port's hand-written Hopper kernels.
//
// The warp-level bf16 kernel (region_attn.cu) uses the tensor-core instruction
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, whose fragment
// layouts are fixed by the PTX ISA. With g = lane / 4 and t = lane % 4:
//   A (16x16, row-major)  a0:(g, 2t..2t+1)  a1:(g+8, 2t..)  a2:(g, 2t+8..)
//                         a3:(g+8, 2t+8..)          -- two bf16 per register
//   B (16x8, k x n)       b0:(k=2t..2t+1, n=g)  b1:(k=2t+8.., n=g)
//   C (16x8, fp32)        c0,c1:(g, 2t..2t+1)   c2,c3:(g+8, 2t..2t+1)
// Fragments are read from shared memory four 8x8 matrices at a time with
// ldmatrix (ldsm_x4, ldsm_x4_trans).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mos {

// SMs of the current device, asked of the runtime once a device (host)
inline int num_sms() {
  constexpr int kDevices = 64;
  static std::atomic<int> cached[kDevices];
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kDevices && (n = cached[dev].load()) > 0) return n;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = n > 0 ? n : 132;
  if (dev >= 0 && dev < kDevices) cached[dev].store(n);
  return n;
}

__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8m..8m+7 give the row
// addresses (16 B each) of matrix m, and register m receives it in the
// fragment layout (thread i holds row i/4, elements 2(i%4) and 2(i%4)+1).
// With .trans every matrix arrives transposed (thread i holds column i/4,
// rows 2(i%4) and 2(i%4)+1): the B fragment of a row-major (k x n) tile.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// 2^x on the special-function unit alone; results below 2^-126 flush to
// zero (exp2f adds the instructions that keep them, for every logit)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pack two floats as bf16 (round to nearest even); lo sits at the lower
// address, i.e. the lower k index of the pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mos

// dtype codes shared with the Python wrappers (ops/_build.py)
#define MOS_F32 0
#define MOS_BF16 1
