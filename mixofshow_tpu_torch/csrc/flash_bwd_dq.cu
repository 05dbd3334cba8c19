// flash_bwd_dq: the dQ half of the FlashAttention-2 backward over the
// contiguous (B, S, H, D) layout, P recomputed from the forward's LSE.
//
// Replaces the TPU kernel mixofshow_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (K6, launched by `_flash_bwd`). With s = (q·scale)·kᵀ
// (the scale folded into q before the bf16 rounding, as on the TPU),
//   P = exp(s - lse),  dS = P ∘ (dO·Vᵀ - Dvec),  dQ = dS·K·scale,
// with Dvec = rowsum(dO ∘ O) precomputed in plain torch. Keys >= Sk get
// p = 0; query rows >= Sq are not stored.
//
// The TPU grid carried the dQ accumulator across sequential key-chunk grid
// steps in VMEM. Here one block owns (batch, head, 64 queries) and streams
// the key tiles in a loop, with dQ in registers: one writer per element, no
// atomics, so reruns are bit-identical.
//
// What bounds it on the card: three products of 2·64·BK·D flops per tile;
// this first version reads its tiles with scalar loads and no copy/compute
// overlap, so it is latency bound, not tensor-core bound.
//
// Design:
//   * bf16: 4 warps, a warp owns 16 query rows (its Q̃ and dO rows are A
//     fragments read from shared memory) and forms S = Q̃·Kᵀ and dP = dO·Vᵀ
//     (16 × 64) on mma.sync m16n8k16 with fp32 accumulators; dS leaves the
//     C layout already in the A layout of dQ += dS·K, whose B operand is a
//     transposed copy of the key tile. lse and Dvec of the warp's rows stay
//     in registers.
//   * fp32: a SIMT kernel (one warp per query row, 32 keys per tile, one
//     per lane) that computes everything in fp32, for fp32 reference runs.
#include "mma.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // (B, H, Sq)
  const float* dvec;  // (B, H, Sq)
  void* dq;
  int B, Sq, Sk, H, D;
  float scale;
};

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------- bf16
template <int DP>
__global__ void __launch_bounds__(128) dq_bf16_kernel(BwdParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int NW = 4;
  constexpr int BQ = 16 * NW;   // queries per block
  constexpr int BK = 64;        // keys per tile
  constexpr int RS = DP + 8;    // row stride of row-major tiles
  constexpr int TS = BK + 8;    // row stride of the transposed key tile
  constexpr int NT = BK / 8;    // n-tiles of S / dP (keys)
  constexpr int NO = DP / 8;    // n-tiles of dQ (head columns)
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * RS;
  bf16* Ks = dOs + BQ * RS;
  bf16* Vs = Ks + BK * RS;
  bf16* Kt = Vs + BK * RS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, H = p.H;
  const long long tok = (long long)H * D;
  const bf16 zero = __float2bfloat16_rn(0.f);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.Sq * tok + h * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.Sq * tok + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.Sk * tok + h * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.Sk * tok + h * D;

  for (int i = tid; i < BQ * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP;
    const bool ok = q0 + r < p.Sq && c < D;
    Qs[r * RS + c] = ok ? __float2bfloat16_rn(
                              __bfloat162float(qg[(q0 + r) * tok + c]) *
                              p.scale)
                        : zero;
    dOs[r * RS + c] = ok ? dog[(q0 + r) * tok + c] : zero;
  }

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float* lg = p.lse + ((long long)b * H + h) * p.Sq;
  const float* dg = p.dvec + ((long long)b * H + h) * p.Sq;
  const float l0 = row0 < p.Sq ? lg[row0] * kLog2e : 0.f;
  const float l1 = row1 < p.Sq ? lg[row1] * kLog2e : 0.f;
  const float d0 = row0 < p.Sq ? dg[row0] : 0.f;
  const float d1 = row1 < p.Sq ? dg[row1] : 0.f;

  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const bf16* qr0 = Qs + (warp * 16 + g) * RS + 2 * t;
  const bf16* qr1 = qr0 + 8 * RS;
  const bf16* or0 = dOs + (warp * 16 + g) * RS + 2 * t;
  const bf16* or1 = or0 + 8 * RS;

  const int n_tiles = (p.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = tid; i < BK * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      const bool ok = k0 + r < p.Sk && c < D;
      const bf16 kv = ok ? kg[(k0 + r) * tok + c] : zero;
      Ks[r * RS + c] = kv;
      Kt[c * TS + r] = kv;
      Vs[r * RS + c] = ok ? vg[(k0 + r) * tok + c] : zero;
    }
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t aq[4] = {mos::ld_u32(qr0 + ks * 16),
                              mos::ld_u32(qr1 + ks * 16),
                              mos::ld_u32(qr0 + ks * 16 + 8),
                              mos::ld_u32(qr1 + ks * 16 + 8)};
      const uint32_t ao[4] = {mos::ld_u32(or0 + ks * 16),
                              mos::ld_u32(or1 + ks * 16),
                              mos::ld_u32(or0 + ks * 16 + 8),
                              mos::ld_u32(or1 + ks * 16 + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kr = Ks + (nt * 8 + g) * RS + ks * 16 + 2 * t;
        const bf16* vr = Vs + (nt * 8 + g) * RS + ks * 16 + 2 * t;
        mos::mma_bf16_16x8x16(s[nt], aq, mos::ld_u32(kr), mos::ld_u32(kr + 8));
        mos::mma_bf16_16x8x16(dp[nt], ao, mos::ld_u32(vr),
                              mos::ld_u32(vr + 8));
      }
    }

    // dS in place of dP: element e of n-tile nt is (row0 or row1, key
    // k0 + nt*8 + 2t + (e & 1))
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = k0 + nt * 8 + 2 * t + (e & 1) < p.Sk;
        const float pv =
            live ? exp2f(s[nt][e] * kLog2e - (e < 2 ? l0 : l1)) : 0.f;
        dp[nt][e] = pv * (dp[nt][e] - (e < 2 ? d0 : d1));
      }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {mos::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              mos::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              mos::pack_bf16(dp[2 * kk + 1][0],
                                             dp[2 * kk + 1][1]),
                              mos::pack_bf16(dp[2 * kk + 1][2],
                                             dp[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const bf16* kr = Kt + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mos::mma_bf16_16x8x16(dq[j], da, mos::ld_u32(kr), mos::ld_u32(kr + 8));
      }
    }
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.Sq * tok + h * D;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? row0 : row1;
      if (col < D && row < p.Sq)
        dqg[row * tok + col] = __float2bfloat16_rn(dq[j][e] * p.scale);
    }
}

template <int DP>
int launch_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int BQ = 64, BK = 64;
  const size_t smem =
      (size_t)(2 * BQ * (DP + 8) + 2 * BK * (DP + 8) + DP * (BK + 8)) * 2;
  auto kern = dq_bf16_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- fp32
constexpr int kF32Rows = 4;      // query rows (warps) per block
constexpr int kF32Keys = 32;     // keys per tile: one per lane
constexpr int kF32MaxCols = 5;   // D <= 160: 5 output columns per lane

__global__ void __launch_bounds__(kF32Rows * 32) dq_f32_kernel(BwdParams p) {
  extern __shared__ float sm[];
  const int D = p.D, DS = D + 1, H = p.H;
  float* Ks = sm;                     // kF32Keys x DS
  float* Vs = Ks + kF32Keys * DS;     // kF32Keys x DS
  float* Qs = Vs + kF32Keys * DS;     // kF32Rows x D, scaled q
  float* dOs = Qs + kF32Rows * D;     // kF32Rows x D

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x * kF32Rows + warp, h = blockIdx.y,
            b = blockIdx.z;
  const long long tok = (long long)H * D;
  const float* qg = static_cast<const float*>(p.q) + b * p.Sq * tok + h * D;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.Sq * tok + h * D;
  const float* kg = static_cast<const float*>(p.k) + b * p.Sk * tok + h * D;
  const float* vg = static_cast<const float*>(p.v) + b * p.Sk * tok + h * D;

  const bool live_row = row < p.Sq;
  for (int c = lane; c < D; c += 32) {
    Qs[warp * D + c] = live_row ? qg[row * tok + c] * p.scale : 0.f;
    dOs[warp * D + c] = live_row ? dog[row * tok + c] : 0.f;
  }
  const float lse =
      live_row ? p.lse[((long long)b * H + h) * p.Sq + row] : 0.f;
  const float dvec =
      live_row ? p.dvec[((long long)b * H + h) * p.Sq + row] : 0.f;

  float dq[kF32MaxCols];
#pragma unroll
  for (int i = 0; i < kF32MaxCols; ++i) dq[i] = 0.f;

  const int n_tiles = (p.Sk + kF32Keys - 1) / kF32Keys;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Keys;
    __syncthreads();
    for (int i = tid; i < kF32Keys * D; i += kF32Rows * 32) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < p.Sk;
      Ks[r * DS + c] = ok ? kg[(k0 + r) * tok + c] : 0.f;
      Vs[r * DS + c] = ok ? vg[(k0 + r) * tok + c] : 0.f;
    }
    __syncthreads();

    float s = 0.f, dp = 0.f;
    for (int c = 0; c < D; ++c) {
      s = fmaf(Qs[warp * D + c], Ks[lane * DS + c], s);
      dp = fmaf(dOs[warp * D + c], Vs[lane * DS + c], dp);
    }
    const float pv = k0 + lane < p.Sk ? expf(s - lse) : 0.f;
    const float dsv = pv * (dp - dvec);
    for (int j = 0; j < kF32Keys; ++j) {
      const float dj = __shfl_sync(0xffffffffu, dsv, j);
#pragma unroll
      for (int i = 0; i < kF32MaxCols; ++i) {
        const int c = lane + 32 * i;
        if (c < D) dq[i] = fmaf(dj, Ks[j * DS + c], dq[i]);
      }
    }
  }
  if (live_row) {
    float* dqg = static_cast<float*>(p.dq) + b * p.Sq * tok + h * D;
#pragma unroll
    for (int i = 0; i < kF32MaxCols; ++i) {
      const int c = lane + 32 * i;
      if (c < D) dqg[row * tok + c] = dq[i] * p.scale;
    }
  }
}

int launch_f32(const BwdParams& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kF32Keys * (p.D + 1) + 2 * kF32Rows * p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + kF32Rows - 1) / kF32Rows, p.H, p.B);
  dq_f32_kernel<<<grid, kF32Rows * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success), or -1 for arguments the kernel
// does not take (D > 160). All of q, k, v, dout, dq are contiguous
// (B, S, H, D); lse and dvec contiguous (B, H, Sq) fp32.
extern "C" int mos_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* dvec, void* dq, int B, int Sq,
                                int Sk, int H, int D, float scale, int dtype,
                                void* stream) {
  BwdParams p{q, k, v, dout, lse, dvec, dq, B, Sq, Sk, H, D, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 160 || Sq < 1 || Sk < 1) return -1;
  if (dtype == MOS_F32) return launch_f32(p, st);
  if (dtype != MOS_BF16) return -1;
  if (D <= 16) return launch_bf16<16>(p, st);
  if (D <= 32) return launch_bf16<32>(p, st);
  if (D <= 48) return launch_bf16<48>(p, st);
  if (D <= 64) return launch_bf16<64>(p, st);
  if (D <= 80) return launch_bf16<80>(p, st);
  if (D <= 96) return launch_bf16<96>(p, st);
  if (D <= 128) return launch_bf16<128>(p, st);
  return launch_bf16<160>(p, st);
}
