// Hopper's tensor memory accelerator (TMA) and the shared-memory barriers
// (mbarrier) that report its copies, for the warp-specialised kernels
// (attn_fwd.cu's producer/consumer forward).
//
// A TMA load copies one box of a tensor from device memory into shared
// memory, swizzled as the tensor map says, and adds the box's bytes to an
// mbarrier's transaction count; elements outside the tensor's bounds arrive
// as zeros (so a head narrower than its shared-memory panels, or the rows
// past a sequence's end, need no masking). Boxes here are 16 bf16 columns
// with CU_TENSOR_MAP_SWIZZLE_32B: exactly one 32B-swizzled panel of
// wgmma.cuh.
//
// The tensor map is encoded on the host by libcuda's
// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point
// query (cudaGetDriverEntryPoint), so the library links against the CUDA
// runtime alone (no -lcuda). <cuda.h> is read only for its types.
#pragma once

#include <cuda.h>

#include "wgmma.cuh"

namespace mos {
namespace sm90 {

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// the inits visible to the other threads (and to the TMA unit)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- TMA load
// box at coordinates (c0, c1, c2, c3) of a rank-4 tensor map, completing
// on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------- register rebalancing
// every warp of the warpgroup executes these together
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// arrive at a named barrier of `count` threads without waiting (id 1..15)
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's encoder, asked of the runtime once a process (null where
// libcuda has none)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// True where a (B, S, H, D) bf16 tensor can be read through TMA: a 16 B
// aligned base and 16 B multiples for the head, token and batch strides
// (the batch stride is never stepped when B is 1). Strides in elements.
inline bool bshd_tma_ok(const void* base, int B, int D, long long sb,
                        long long ss) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && D % 8 == 0 &&
         ss % 8 == 0 && (B == 1 || sb % 8 == 0);
}

// Rank-4 map of the first `rows` tokens of a (B, S, H, D) bf16 tensor,
// dimensions innermost first (D, rows, H, B), boxes of 16 columns by
// `box_rows` tokens of one head, 32B swizzle; columns past D and rows past
// `rows` read as zeros. Returns false where the encoder refuses it.
inline bool bshd_map(CUtensorMap* map, const void* base, int B, int rows,
                     int H, int D, long long sb, long long ss,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)H, (cuuint64_t)B};
  // bytes; a single batch's stride is never stepped, any multiple of 16
  const cuuint64_t strides[3] = {
      (cuuint64_t)ss * 2, (cuuint64_t)D * 2,
      B == 1 ? (cuuint64_t)ss * 2 * rows : (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {16, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace mos
