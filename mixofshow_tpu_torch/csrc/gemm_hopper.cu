// gemm_hopper: grouped Y_i[M_i, N_i] = (X_i[M_i, K_i] · W_i[N_i, K_i]ᵀ +
// bias_i) · scale_i for up to three (X, W, bias, Y) triples in one launch,
// fp32 accumulation, rounded once to the output type.
//
// The projections of ops/fused_attention.attention_block (K3), which
// replaces the TPU kernel mixofshow_tpu/ops/fused_attention.py `_kernel`.
// That kernel computes its q/k/v projections (with biases) and its
// out-projection in its own body, so they are hand-written here as well,
// around the attention core (attn_wide.cu for the VAE's 512-wide head). The
// q, k and v projections are one launch, grid z picking the triple; q over
// the B·Sq rows of x with scale 1/√D folded in after the bias and before the
// bf16 rounding (the TPU kernel's order), k and v over the B·Sk rows of ctx.
// The out-projection is one launch with a single triple.
//
// What bounds it on the card: at the VAE mid-block (M = 8192, N = K = 512)
// each projection is 4.3 GFLOP against 10 MB moved, compute bound (about
// 4.3 µs at the bf16 peak).
//
// Design (bf16): a 128×128 output tile per block, K in steps of 64 through
// a 3-stage ring of shared-memory tiles filled by cp.async 16 B copies in
// the 128B-swizzled panel layout (wgmma.cuh); two warpgroups, each running
// wgmma.m64n128k16 on its 64 rows with both operands read from shared
// memory (both K-major, as X and the PyTorch (out, in) weight are) and fp32
// accumulators in registers. Loads run STAGES-1 tiles ahead of the products.
// 96 KB of shared memory, so two blocks share an SM. Ragged M, N and K
// (down to 32) load as zeros and are not stored. The epilogue adds the
// bias, scales, rounds and stores through shared memory with 16 B writes.
// fp32: a SIMT 64×64 tile, 4×4 outputs per thread, for reference runs.
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Triple {
  const void* x;
  const void* w;
  const void* bias;  // may be null
  void* y;
  int M, N, K;
  long long x_rs, y_rs;  // row strides in elements; W is contiguous
  float scale;
};

struct GroupParams {
  Triple t[3];
};

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kTileElems = kBM * kBK;              // one operand tile
constexpr int kStageElems = 2 * kTileElems;        // X tile + W tile
constexpr int kSmem = kStages * kStageElems * 2;   // 96 KB
constexpr int kYS = kBN + 8;                       // epilogue row stride

__global__ void __launch_bounds__(256, 2)
    gemm_bf16_kernel(const __grid_constant__ GroupParams p) {
  using namespace mos::sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const Triple& T = p.t[blockIdx.z];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (m0 >= T.M || n0 >= T.N) return;
  const bf16* X = static_cast<const bf16*>(T.x);
  const bf16* W = static_cast<const bf16*>(T.w);
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int K = T.K, nk = (K + kBK - 1) / kBK;

  // 128 rows × 8 chunks of each operand: 4 + 4 copies per thread
  auto load = [&](int stage, int kt) {
    bf16* xs = sm + stage * kStageElems;
    bf16* ws = xs + kTileElems;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = tid + 256 * j, r = ci / 8, c = ci % 8;
      const int col = kt * kBK + c * 8;
      const int kv = K - col;
      load_chunk(xs + sw128(r, c), X + (long long)(m0 + r) * T.x_rs + col,
                 m0 + r < T.M ? kv : 0);
      load_chunk(ws + sw128(r, c), W + (long long)(n0 + r) * K + col,
                 n0 + r < T.N ? kv : 0);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    // the stage read in step kt-1 is free: every thread has waited on its
    // products before the barrier
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt);
    cp_async_commit();

    const bf16* xs = sm + (kt % kStages) * kStageElems + wg * 64 * kBK;
    const bf16* ws = sm + (kt % kStages) * kStageElems + kTileElems;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      Wgmma<128>::ss(acc, desc(xs + ks * 16, 16, 1024, kB128),
                     desc(ws + ks * 16, 16, 1024, kB128), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: (acc + bias) · scale -> bf16, staged row-major, 16 B stores
  const bf16* bias = static_cast<const bf16*>(T.bias);
  bf16* ys = sm;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = j * 8 + 2 * t;
    const float b0 = bias && n0 + c < T.N ? __bfloat162float(bias[n0 + c]) : 0.f;
    const float b1 =
        bias && n0 + c + 1 < T.N ? __bfloat162float(bias[n0 + c + 1]) : 0.f;
    *reinterpret_cast<uint32_t*>(ys + r0 * kYS + c) = mos::pack_bf16(
        (acc[4 * j] + b0) * T.scale, (acc[4 * j + 1] + b1) * T.scale);
    *reinterpret_cast<uint32_t*>(ys + (r0 + 8) * kYS + c) = mos::pack_bf16(
        (acc[4 * j + 2] + b0) * T.scale, (acc[4 * j + 3] + b1) * T.scale);
  }
  __syncthreads();
  bf16* Y = static_cast<bf16*>(T.y);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ci = tid + 256 * j, r = ci / 16, c = (ci % 16) * 8;
    if (m0 + r < T.M && n0 + c < T.N)
      store_chunk(Y + (long long)(m0 + r) * T.y_rs + n0 + c, ys + r * kYS + c,
                  T.N - n0 - c);
  }
}

// ------------------------------------------------------------------- fp32
constexpr int kF32Tile = 64;
constexpr int kF32K = 16;

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const __grid_constant__ GroupParams p) {
  const Triple& T = p.t[blockIdx.z];
  const float* X = static_cast<const float*>(T.x);
  const float* W = static_cast<const float*>(T.w);
  const float* bias = static_cast<const float*>(T.bias);
  float* Y = static_cast<float*>(T.y);
  const int M = T.M, N = T.N, K = T.K;
  __shared__ float As[kF32K][kF32Tile + 4];
  __shared__ float Bs[kF32K][kF32Tile + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kF32Tile, n0 = blockIdx.x * kF32Tile;
  if (m0 >= M || n0 >= N) return;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32K) {
    __syncthreads();
    for (int i = tid; i < kF32Tile * kF32K; i += 256) {
      const int r = i / kF32K, c = i % kF32K;
      const bool kin = k0 + c < K;
      As[c][r] = (m0 + r < M && kin)
                     ? X[(long long)(m0 + r) * T.x_rs + k0 + c] : 0.f;
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
        Y[(long long)r * T.y_rs + c] =
            (acc[i][j] + (bias ? bias[c] : 0.f)) * T.scale;
    }
}

}  // namespace

// Returns a cudaError_t code (0 on success) or -1 for arguments it does not
// take (n outside 1..3, an unknown dtype). Arrays hold one entry per triple.
extern "C" int mos_gemm_grouped(int n, const void* const* x,
                                const void* const* w, const void* const* bias,
                                void* const* y, const int* M, const int* N,
                                const int* K, const long long* x_rs,
                                const long long* y_rs, const float* scale,
                                int dtype, void* stream) {
  if (n < 1 || n > 3) return -1;
  GroupParams p{};
  int max_m = 0, max_n = 0;
  for (int i = 0; i < n; ++i) {
    if (M[i] < 1 || N[i] < 1 || K[i] < 1) return -1;
    p.t[i] = Triple{x[i], w[i], bias[i], y[i], M[i], N[i], K[i],
                    x_rs[i], y_rs[i], scale[i]};
    max_m = M[i] > max_m ? M[i] : max_m;
    max_n = N[i] > max_n ? N[i] : max_n;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == MOS_BF16) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((max_n + kBN - 1) / kBN, (max_m + kBM - 1) / kBM, n);
    gemm_bf16_kernel<<<grid, 256, kSmem, st>>>(p);
  } else if (dtype == MOS_F32) {
    const dim3 grid((max_n + kF32Tile - 1) / kF32Tile,
                    (max_m + kF32Tile - 1) / kF32Tile, n);
    gemm_f32_kernel<<<grid, 256, 0, st>>>(p);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
