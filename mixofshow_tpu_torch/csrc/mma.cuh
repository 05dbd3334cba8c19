// Shared helpers for the port's hand-written Hopper kernels.
//
// The bf16 kernels use the warp-level tensor-core instruction
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, whose fragment
// layouts are fixed by the PTX ISA. With g = lane / 4 and t = lane % 4:
//   A (16x16, row-major)  a0:(g, 2t..2t+1)  a1:(g+8, 2t..)  a2:(g, 2t+8..)
//                         a3:(g+8, 2t+8..)          -- two bf16 per register
//   B (16x8, k x n)       b0:(k=2t..2t+1, n=g)  b1:(k=2t+8.., n=g)
//   C (16x8, fp32)        c0,c1:(g, 2t..2t+1)   c2,c3:(g+8, 2t..2t+1)
// Every fragment is read straight from shared memory with 32-bit loads, so
// operands are stored with the pair of k-adjacent elements contiguous.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mos {

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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Pack two floats as bf16 (round to nearest even); lo sits at the lower
// address, i.e. the lower k index of the pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace mos

// dtype codes shared with the Python wrappers (ops/_build.py)
#define MOS_F32 0
#define MOS_BF16 1
