// gemm_bias: Y[M, N] = X[M, K] · W[N, K]ᵀ + bias[N], fp32 accumulation.
//
// The projections of attn_block (ops/fused_attention.attention_block), which
// replaces the TPU kernel mixofshow_tpu/ops/fused_attention.py `_kernel`.
// That kernel computes its q/k/v projections (with biases) and its
// out-projection in its own body, so they are hand-written here as well,
// around the attention core (attn_fwd.cu at one 512-wide head for the VAE).
//
// W is a PyTorch weight, (out, in) row-major, so both operands are
// K-contiguous: exactly the row.col operand order of mma.sync.
//
// What bounds it on the card: at the VAE mid-block (M = B·4096, N = K =
// 512) the product is compute bound; this first version loads its tiles
// synchronously with scalar loads (no cp.async/TMA pipeline, no wgmma), so
// it runs well below the tensor-core peak.
//
// Design: bf16 — 64x64 block tile, K step 32, four warps of 32x32, each a
// 2x4 grid of m16n8k16 MMAs; fp32 — a SIMT 64x64 tile, 4x4 outputs per
// thread, for fp32 reference runs on the card.
#include "mma.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kKStep = 32;
constexpr int kGS = kKStep + 8;  // smem row stride: conflict-free 32-bit loads

__global__ void __launch_bounds__(128)
    gemm_bias_bf16_kernel(const __nv_bfloat16* __restrict__ X,
                          const __nv_bfloat16* __restrict__ W,
                          const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ Y, int M, int N, int K,
                          long long x_rs, long long y_rs) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 Xs[kTile * kGS];
  __shared__ __align__(16) bf16 Ws[kTile * kGS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const bf16 zero = __float2bfloat16_rn(0.f);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKStep) {
    __syncthreads();
    for (int i = tid; i < kTile * kKStep; i += 128) {
      const int r = i / kKStep, c = i % kKStep;
      const bool kin = k0 + c < K;
      Xs[r * kGS + c] =
          (m0 + r < M && kin) ? X[(long long)(m0 + r) * x_rs + k0 + c] : zero;
      Ws[r * kGS + c] =
          (n0 + r < N && kin) ? W[(long long)(n0 + r) * K + k0 + c] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKStep / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* ap = Xs + (wm + mi * 16 + g) * kGS + ks * 16 + 2 * t;
        a[mi][0] = mos::ld_u32(ap);
        a[mi][1] = mos::ld_u32(ap + 8 * kGS);
        a[mi][2] = mos::ld_u32(ap + 8);
        a[mi][3] = mos::ld_u32(ap + 8 * kGS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* bp = Ws + (wn + ni * 8 + g) * kGS + ks * 16 + 2 * t;
        const uint32_t b0 = mos::ld_u32(bp), b1 = mos::ld_u32(bp + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mos::mma_bf16_16x8x16(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + mi * 16 + g + (e < 2 ? 0 : 8);
        const int c = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (r < M && c < N) {
          const float bv = bias ? __bfloat162float(bias[c]) : 0.f;
          Y[(long long)r * y_rs + c] = __float2bfloat16_rn(acc[mi][ni][e] + bv);
        }
      }
}

constexpr int kF32K = 16;

__global__ void __launch_bounds__(256)
    gemm_bias_f32_kernel(const float* __restrict__ X,
                         const float* __restrict__ W,
                         const float* __restrict__ bias, float* __restrict__ Y,
                         int M, int N, int K, long long x_rs, long long y_rs) {
  __shared__ float As[kF32K][kTile + 4];
  __shared__ float Bs[kF32K][kTile + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32K) {
    __syncthreads();
    for (int i = tid; i < kTile * kF32K; i += 256) {
      const int r = i / kF32K, c = i % kF32K;
      const bool kin = k0 + c < K;
      As[c][r] = (m0 + r < M && kin) ? X[(long long)(m0 + r) * x_rs + k0 + c]
                                     : 0.f;
      Bs[c][r] = (n0 + r < N && kin) ? W[(long long)(n0 + r) * K + k0 + c]
                                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < M && c < N)
        Y[(long long)r * y_rs + c] = acc[i][j] + (bias ? bias[c] : 0.f);
    }
}

}  // namespace

// Returns a cudaError_t code (0 on success) or -1 for an unknown dtype.
// x_rs / y_rs are the row strides of X and Y in elements; W is contiguous.
extern "C" int mos_gemm_bias(const void* x, const void* w, const void* bias,
                             void* y, int M, int N, int K, long long x_rs,
                             long long y_rs, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  if (dtype == MOS_BF16) {
    gemm_bias_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(y), M, N, K, x_rs, y_rs);
  } else if (dtype == MOS_F32) {
    gemm_bias_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), M, N, K,
        x_rs, y_rs);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
