// flash_bwd_dkv: the dK/dV half of the FlashAttention-2 backward over the
// contiguous (B, S, H, D) layout, P recomputed from the forward's LSE.
//
// Replaces the TPU kernel mixofshow_tpu/ops/flash_attention.py
// `_bwd_dkv_kernel` (K5, launched by `_flash_bwd`). With s = (q·scale)·kᵀ
// (the scale folded into q before the bf16 rounding, as on the TPU),
//   P  = exp(s - lse),  dP = dO·Vᵀ,  dS = P ∘ (dP - Dvec),
//   dV = Pᵀ·dO,         dK = dSᵀ·(q·scale),
// where Dvec = rowsum(dO ∘ O) comes in precomputed (plain torch, as the TPU
// package kept it outside Pallas). Keys >= Sk get p = 0 and are not stored;
// query rows >= Sq load as zeros with lse = +inf, so they add nothing.
//
// The TPU grid carried dK/dV accumulators across sequential query-chunk grid
// steps in VMEM. Here one block owns (batch, head, 64 keys) and streams the
// query tiles in a loop, with its accumulators in registers: every output
// element has exactly one writer, no atomics, so reruns are bit-identical.
//
// What bounds it on the card: four products of 2·BQ·64·D flops per tile;
// this first version reads its tiles with scalar loads and no copy/compute
// overlap, so it is latency bound, not tensor-core bound.
//
// Design:
//   * bf16: 4 warps, a warp owns 16 keys and forms Sᵀ = K·Q̃ᵀ and
//     dPᵀ = V·dOᵀ (16 × BQ) on mma.sync m16n8k16 with fp32 accumulators.
//     Their C-fragment layout is already the A-fragment layout of
//     dV += Pᵀ·dO and dK += dSᵀ·Q̃, so P and dS never leave registers (K1's
//     trick for P). K and V rows are read as A fragments from shared memory;
//     the query tile is held twice, row-major (B operand of the first two
//     products) and transposed (B operand of the last two).
//   * fp32: a SIMT kernel (one warp per key, 32 queries per tile, one per
//     lane) that computes everything in fp32, for fp32 reference runs.
#include "mma.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // (B, H, Sq)
  const float* dvec;  // (B, H, Sq)
  void* dk;
  void* dv;
  int B, Sq, Sk, H, D;
  float scale;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kBig = 1e30f;  // lse of a padded query row: exp2(-kBig) == 0

// ------------------------------------------------------------------- bf16
template <int DP, int BQ>
__global__ void __launch_bounds__(128) dkv_bf16_kernel(BwdParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int NW = 4;
  constexpr int BK = 16 * NW;      // keys per block
  constexpr int RS = DP + 8;       // row stride of row-major tiles
  constexpr int TS = BQ + 8;       // row stride of transposed tiles
  constexpr int NT = BQ / 8;       // n-tiles of Sᵀ / dPᵀ (queries)
  constexpr int NO = DP / 8;       // n-tiles of dK / dV (head columns)
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * RS;
  bf16* Qs = Vs + BK * RS;
  bf16* dOs = Qs + BQ * RS;
  bf16* Qt = dOs + BQ * RS;
  bf16* dOt = Qt + DP * TS;
  float* lse2 = reinterpret_cast<float*>(dOt + DP * TS);
  float* dvs = lse2 + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, H = p.H;
  const long long tok = (long long)H * D;  // token stride
  const bf16 zero = __float2bfloat16_rn(0.f);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.Sq * tok + h * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.Sq * tok + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.Sk * tok + h * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.Sk * tok + h * D;
  const float* lg = p.lse + ((long long)b * H + h) * p.Sq;
  const float* dg = p.dvec + ((long long)b * H + h) * p.Sq;

  for (int i = tid; i < BK * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP;
    const bool ok = k0 + r < p.Sk && c < D;
    Ks[r * RS + c] = ok ? kg[(k0 + r) * tok + c] : zero;
    Vs[r * RS + c] = ok ? vg[(k0 + r) * tok + c] : zero;
  }

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const bf16* kr0 = Ks + (warp * 16 + g) * RS + 2 * t;
  const bf16* kr1 = kr0 + 8 * RS;
  const bf16* vr0 = Vs + (warp * 16 + g) * RS + 2 * t;
  const bf16* vr1 = vr0 + 8 * RS;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;

  const int n_tiles = (p.Sq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    for (int i = tid; i < BQ * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      const bool ok = q0 + r < p.Sq && c < D;
      const bf16 qv = ok ? __float2bfloat16_rn(
                               __bfloat162float(qg[(q0 + r) * tok + c]) *
                               p.scale)
                         : zero;
      const bf16 dov = ok ? dog[(q0 + r) * tok + c] : zero;
      Qs[r * RS + c] = qv;
      Qt[c * TS + r] = qv;
      dOs[r * RS + c] = dov;
      dOt[c * TS + r] = dov;
    }
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool ok = q0 + i < p.Sq;
      lse2[i] = ok ? lg[q0 + i] * kLog2e : kBig;
      dvs[i] = ok ? dg[q0 + i] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K Q̃ᵀ and dPᵀ = V dOᵀ, 16 keys × BQ queries per warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t ak[4] = {mos::ld_u32(kr0 + ks * 16),
                              mos::ld_u32(kr1 + ks * 16),
                              mos::ld_u32(kr0 + ks * 16 + 8),
                              mos::ld_u32(kr1 + ks * 16 + 8)};
      const uint32_t av[4] = {mos::ld_u32(vr0 + ks * 16),
                              mos::ld_u32(vr1 + ks * 16),
                              mos::ld_u32(vr0 + ks * 16 + 8),
                              mos::ld_u32(vr1 + ks * 16 + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* qr = Qs + (nt * 8 + g) * RS + ks * 16 + 2 * t;
        const bf16* dr = dOs + (nt * 8 + g) * RS + ks * 16 + 2 * t;
        mos::mma_bf16_16x8x16(st[nt], ak, mos::ld_u32(qr),
                              mos::ld_u32(qr + 8));
        mos::mma_bf16_16x8x16(dpt[nt], av, mos::ld_u32(dr),
                              mos::ld_u32(dr + 8));
      }
    }

    // P and dS in place: element e of n-tile nt is (key0 or key1, query
    // nt*8 + 2t + (e & 1))
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const bool live = (e < 2 ? key0 : key1) < p.Sk;
        const float pv = live ? exp2f(st[nt][e] * kLog2e - lse2[qc]) : 0.f;
        st[nt][e] = pv;
        dpt[nt][e] = pv * (dpt[nt][e] - dvs[qc]);
      }

    // the C layout of two adjacent n-tiles is the A layout of 16 queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {mos::pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              mos::pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              mos::pack_bf16(st[2 * kk + 1][0],
                                             st[2 * kk + 1][1]),
                              mos::pack_bf16(st[2 * kk + 1][2],
                                             st[2 * kk + 1][3])};
      const uint32_t da[4] = {mos::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              mos::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              mos::pack_bf16(dpt[2 * kk + 1][0],
                                             dpt[2 * kk + 1][1]),
                              mos::pack_bf16(dpt[2 * kk + 1][2],
                                             dpt[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const bf16* dr = dOt + (j * 8 + g) * TS + kk * 16 + 2 * t;
        const bf16* qr = Qt + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mos::mma_bf16_16x8x16(dv[j], pa, mos::ld_u32(dr),
                              mos::ld_u32(dr + 8));
        mos::mma_bf16_16x8x16(dk[j], da, mos::ld_u32(qr),
                              mos::ld_u32(qr + 8));
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.Sk * tok + h * D;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.Sk * tok + h * D;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      const int key = e < 2 ? key0 : key1;
      if (col < D && key < p.Sk) {
        dkg[key * tok + col] = __float2bfloat16_rn(dk[j][e]);
        dvg[key * tok + col] = __float2bfloat16_rn(dv[j][e]);
      }
    }
}

template <int DP, int BQ>
int launch_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int BK = 64;
  const size_t smem = (size_t)(2 * BK * (DP + 8) + 2 * BQ * (DP + 8) +
                               2 * DP * (BQ + 8)) * 2 +
                      (size_t)2 * BQ * sizeof(float);
  auto kern = dkv_bf16_kernel<DP, BQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sk + BK - 1) / BK, p.H, p.B);
  kern<<<grid, 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- fp32
constexpr int kF32Keys = 4;      // keys (warps) per block
constexpr int kF32Rows = 32;     // queries per tile: one per lane
constexpr int kF32MaxCols = 5;   // D <= 160: 5 output columns per lane

__global__ void __launch_bounds__(kF32Keys * 32) dkv_f32_kernel(BwdParams p) {
  extern __shared__ float sm[];
  const int D = p.D, DS = D + 1, H = p.H;
  float* Qs = sm;                       // kF32Rows x DS, scaled q
  float* dOs = Qs + kF32Rows * DS;      // kF32Rows x DS
  float* Ks = dOs + kF32Rows * DS;      // kF32Keys x D
  float* Vs = Ks + kF32Keys * D;        // kF32Keys x D
  float* ls = Vs + kF32Keys * D;        // kF32Rows
  float* ds = ls + kF32Rows;            // kF32Rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int key = blockIdx.x * kF32Keys + warp, h = blockIdx.y, b = blockIdx.z;
  const long long tok = (long long)H * D;
  const float* qg = static_cast<const float*>(p.q) + b * p.Sq * tok + h * D;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.Sq * tok + h * D;
  const float* kg = static_cast<const float*>(p.k) + b * p.Sk * tok + h * D;
  const float* vg = static_cast<const float*>(p.v) + b * p.Sk * tok + h * D;
  const float* lg = p.lse + ((long long)b * H + h) * p.Sq;
  const float* dg = p.dvec + ((long long)b * H + h) * p.Sq;

  for (int c = lane; c < D; c += 32) {
    Ks[warp * D + c] = key < p.Sk ? kg[key * tok + c] : 0.f;
    Vs[warp * D + c] = key < p.Sk ? vg[key * tok + c] : 0.f;
  }
  float dk[kF32MaxCols], dv[kF32MaxCols];
#pragma unroll
  for (int i = 0; i < kF32MaxCols; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (p.Sq + kF32Rows - 1) / kF32Rows;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kF32Rows;
    __syncthreads();
    for (int i = tid; i < kF32Rows * D; i += kF32Keys * 32) {
      const int r = i / D, c = i % D;
      const bool ok = q0 + r < p.Sq;
      Qs[r * DS + c] = ok ? qg[(q0 + r) * tok + c] * p.scale : 0.f;
      dOs[r * DS + c] = ok ? dog[(q0 + r) * tok + c] : 0.f;
    }
    for (int i = tid; i < kF32Rows; i += kF32Keys * 32) {
      ls[i] = q0 + i < p.Sq ? lg[q0 + i] : 0.f;
      ds[i] = q0 + i < p.Sq ? dg[q0 + i] : 0.f;
    }
    __syncthreads();

    float s = 0.f, dp = 0.f;
    for (int c = 0; c < D; ++c) {
      s = fmaf(Qs[lane * DS + c], Ks[warp * D + c], s);
      dp = fmaf(dOs[lane * DS + c], Vs[warp * D + c], dp);
    }
    const bool live = key < p.Sk && q0 + lane < p.Sq;
    const float pv = live ? expf(s - ls[lane]) : 0.f;
    const float dsv = pv * (dp - ds[lane]);
    for (int j = 0; j < kF32Rows; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pv, j);
      const float dj = __shfl_sync(0xffffffffu, dsv, j);
#pragma unroll
      for (int i = 0; i < kF32MaxCols; ++i) {
        const int c = lane + 32 * i;
        if (c < D) {
          dv[i] = fmaf(pj, dOs[j * DS + c], dv[i]);
          dk[i] = fmaf(dj, Qs[j * DS + c], dk[i]);
        }
      }
    }
  }
  if (key < p.Sk) {
    float* dkg = static_cast<float*>(p.dk) + b * p.Sk * tok + h * D;
    float* dvg = static_cast<float*>(p.dv) + b * p.Sk * tok + h * D;
#pragma unroll
    for (int i = 0; i < kF32MaxCols; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        dkg[key * tok + c] = dk[i];
        dvg[key * tok + c] = dv[i];
      }
    }
  }
}

int launch_f32(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kF32Rows * (p.D + 1) + 2 * kF32Keys * p.D +
                               2 * kF32Rows) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sk + kF32Keys - 1) / kF32Keys, p.H, p.B);
  dkv_f32_kernel<<<grid, kF32Keys * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success), or -1 for arguments the kernel
// does not take (D > 160). All of q, k, v, dout, dk, dv are contiguous
// (B, S, H, D); lse and dvec contiguous (B, H, Sq) fp32.
extern "C" int mos_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* dvec, void* dk, void* dv, int B,
                                 int Sq, int Sk, int H, int D, float scale,
                                 int dtype, void* stream) {
  BwdParams p{q, k, v, dout, lse, dvec, dk, dv, B, Sq, Sk, H, D, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 160 || Sq < 1 || Sk < 1) return -1;
  if (dtype == MOS_F32) return launch_f32(p, st);
  if (dtype != MOS_BF16) return -1;
  if (D <= 16) return launch_bf16<16, 64>(p, st);
  if (D <= 32) return launch_bf16<32, 64>(p, st);
  if (D <= 48) return launch_bf16<48, 64>(p, st);
  if (D <= 64) return launch_bf16<64, 64>(p, st);
  if (D <= 80) return launch_bf16<80, 64>(p, st);
  if (D <= 96) return launch_bf16<96, 32>(p, st);
  if (D <= 128) return launch_bf16<128, 32>(p, st);
  return launch_bf16<160, 32>(p, st);
}
