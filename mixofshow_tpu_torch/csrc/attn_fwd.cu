// attn_fwd: attention forward, softmax(q kᵀ · scale) v, over the natural
// (B, S, H, D) layout, with key columns >= kv_len masked.
//
// Replaces two TPU kernels:
//   * mixofshow_tpu/ops/fused_attention.py `_packed_fwd_kernel` (K1,
//     launched by `_packed_flash`, wrapped by `attention_packed`):
//     entry point mos_attn_fwd, the FLASH = false instantiations;
//   * mixofshow_tpu/ops/flash_attention.py `_fwd_kernel` (K4, the forward
//     of the differentiable `flash_attention`): entry point mos_flash_fwd,
//     the FLASH = true instantiations. They fold the softmax scale into q
//     before the bf16 rounding, as the TPU kernel did, and also store the
//     per-row log-sum-exp (B, H, Sq) in fp32 that the backward kernels
//     (flash_bwd_dkv.cu, flash_bwd_dq.cu) recompute P from. The TPU
//     kernel's 8-lane LSE replication was a VMEM tiling artifact and is
//     not copied.
//
// The TPU K1 zero-padded every head from D to 128 lanes in HBM and held one
// head's whole K/V in VMEM (K4 likewise held K/V resident); here the head width is
// padded only inside shared-memory tiles (to the MMA's multiple of 16), and K
// and V stream through in tiles with an online softmax (FlashAttention-2
// style), so nothing padded ever reaches device memory.
//
// What bounds it on the card: at the UNet's shapes (D = 40/80, 1024-4096
// keys) the work is the two products (4·Sq·Sk·D flops per head), so it is
// tensor-core bound in principle; this first version reads its tiles with
// scalar loads and no copy/compute overlap, so it is latency bound instead.
//
// Design:
//   * bf16: one block per (q-block of 16·NW rows, head, batch); each warp
//     owns 16 query rows. S = Q Kᵀ and O += P V run on mma.sync m16n8k16
//     with fp32 accumulators; the row max/sum live in registers (fp32) and
//     P is rounded to bf16 only as the A operand of the value product.
//     O stays in registers for D <= 128; for wider heads (the VAE's single
//     512-wide head) it lives in shared memory in fragment order.
//   * fp32: a SIMT kernel (one warp per query row, 32 keys per tile) that
//     computes everything in fp32, for fp32 reference runs on the card.
#include "mma.cuh"

namespace {

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, D, kv_len;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale;
  float* lse;  // (B, H, Sq) fp32, written by the FLASH instantiations only
};

constexpr float kNeg = -1e30f;  // masked logit, as the TPU kernel's NEG_INF

// ------------------------------------------------------------------- bf16
template <int DP, int NW, int BK, bool OSMEM, bool FLASH>
__global__ void __launch_bounds__(NW * 32)
    attn_fwd_bf16_kernel(AttnParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = NW * 16;
  constexpr int QS = DP + 8;  // row stride (elements) of Q and K tiles
  constexpr int VS = BK + 8;  // row stride of the transposed V tile
  constexpr int NT_S = BK / 8;
  constexpr int NT_O = DP / 8;
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * QS;
  bf16* Vt = Ks + BK * QS;
  float* Os = reinterpret_cast<float*>(Vt + DP * VS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D;
  const bf16 zero = __float2bfloat16_rn(0.f);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * D;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * D;

  for (int i = tid; i < BQ * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP;
    const bool ok = q0 + r < p.Sq && c < D;
    if constexpr (FLASH) {
      // scale folded into q, then rounded to bf16 (the TPU kernel's order)
      Qs[r * QS + c] =
          ok ? __float2bfloat16_rn(
                   __bfloat162float(qg[(long long)(q0 + r) * p.q_ss + c]) *
                   p.scale)
             : zero;
    } else {
      Qs[r * QS + c] = ok ? qg[(long long)(q0 + r) * p.q_ss + c] : zero;
    }
  }

  float o_reg[OSMEM ? 1 : NT_O][4];
  float* ow = Os + warp * NT_O * 128;  // this warp's O, fragment order
  if constexpr (OSMEM) {
    for (int i = lane; i < NT_O * 128; i += 32) ow[i] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_reg[j][e] = 0.f;
  }

  // rows g and g+8 of this warp's 16; log2-domain running max, and this
  // thread's partial row sums (the 4 threads of a row are summed at the end)
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const float sl2 = (FLASH ? 1.f : p.scale) * 1.4426950408889634f;
  const int n_tiles = (p.kv_len + BK - 1) / BK;
  const bf16* qr0 = Qs + (warp * 16 + g) * QS + 2 * t;
  const bf16* qr1 = qr0 + 8 * QS;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = tid; i < BK * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      const bool ok = (k0 + r < p.kv_len) && (c < D);
      Ks[r * QS + c] = ok ? kg[(long long)(k0 + r) * p.k_ss + c] : zero;
      Vt[c * VS + r] = ok ? vg[(long long)(k0 + r) * p.v_ss + c] : zero;
    }
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t a[4] = {mos::ld_u32(qr0 + ks * 16), mos::ld_u32(qr1 + ks * 16),
                             mos::ld_u32(qr0 + ks * 16 + 8),
                             mos::ld_u32(qr1 + ks * 16 + 8)};
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const bf16* kr = Ks + (nt * 8 + g) * QS + ks * 16 + 2 * t;
        mos::mma_bf16_16x8x16(s[nt], a, mos::ld_u32(kr), mos::ld_u32(kr + 8));
      }
    }

    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < p.kv_len ? s[nt][e] * sl2 : kNeg;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // tile 0 always holds key 0 < kv_len, so m is finite from then on and
    // every masked logit below gives exp2(-1e30 - m) == 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;

    // the C layout of two adjacent S tiles is the A layout of P (16 keys)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = mos::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = mos::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = mos::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = mos::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      float c[4];
      if constexpr (OSMEM) {
        const float4 v = reinterpret_cast<float4*>(ow)[j * 32 + lane];
        c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
      } else {
        c[0] = o_reg[j][0]; c[1] = o_reg[j][1];
        c[2] = o_reg[j][2]; c[3] = o_reg[j][3];
      }
      c[0] *= al0; c[1] *= al0; c[2] *= al1; c[3] *= al1;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const bf16* vr = Vt + (j * 8 + g) * VS + kk * 16 + 2 * t;
        mos::mma_bf16_16x8x16(c, pa[kk], mos::ld_u32(vr), mos::ld_u32(vr + 8));
      }
      if constexpr (OSMEM) {
        reinterpret_cast<float4*>(ow)[j * 32 + lane] =
            make_float4(c[0], c[1], c[2], c[3]);
      } else {
        o_reg[j][0] = c[0]; o_reg[j][1] = c[1];
        o_reg[j][2] = c[2]; o_reg[j][3] = c[3];
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  if constexpr (FLASH) {
    // natural-log LSE from the log2-domain max and the row sum
    float* lrow = p.lse + ((long long)b * p.H + h) * p.Sq;
    if (t == 0 && r0 < p.Sq) lrow[r0] = (m0 + log2f(l0)) * 0.6931471805599453f;
    if (t == 0 && r1 < p.Sq) lrow[r1] = (m1 + log2f(l1)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    float c[4];
    if constexpr (OSMEM) {
      const float4 v = reinterpret_cast<float4*>(ow)[j * 32 + lane];
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
      c[0] = o_reg[j][0]; c[1] = o_reg[j][1];
      c[2] = o_reg[j][2]; c[3] = o_reg[j][3];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? r0 : r1;
      if (col < D && row < p.Sq)
        og[(long long)row * p.o_ss + col] =
            __float2bfloat16_rn(c[e] * (e < 2 ? inv0 : inv1));
    }
  }
}

template <int DP, int NW, int BK, bool OSMEM, bool FLASH>
int launch_bf16(const AttnParams& p, cudaStream_t stream) {
  constexpr int BQ = NW * 16;
  const size_t smem =
      (size_t)(BQ * (DP + 8) + BK * (DP + 8) + DP * (BK + 8)) * 2 +
      (OSMEM ? (size_t)BQ * DP * 4 : 0);
  auto kern = attn_fwd_bf16_kernel<DP, NW, BK, OSMEM, FLASH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, NW * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- fp32
constexpr int kF32Rows = 4;   // query rows (warps) per block
constexpr int kF32Keys = 32;  // keys per tile: one per lane
constexpr int kF32MaxCols = 16;  // D <= 512: 16 output columns per lane

template <bool FLASH>
__global__ void __launch_bounds__(kF32Rows * 32)
    attn_fwd_f32_kernel(AttnParams p) {
  extern __shared__ float sm[];
  const int D = p.D, DS = D + 1;
  float* Ks = sm;
  float* Vs = Ks + kF32Keys * DS;
  float* Qs = Vs + kF32Keys * DS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x * kF32Rows + warp, h = blockIdx.y,
            b = blockIdx.z;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * D;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * D;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * D;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * D;

  for (int c = lane; c < D; c += 32)
    Qs[warp * D + c] = row < p.Sq
        ? qg[(long long)row * p.q_ss + c] * (FLASH ? p.scale : 1.f) : 0.f;

  float o[kF32MaxCols];
#pragma unroll
  for (int i = 0; i < kF32MaxCols; ++i) o[i] = 0.f;
  float m = kNeg, l = 0.f;
  const int n_tiles = (p.kv_len + kF32Keys - 1) / kF32Keys;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Keys;
    __syncthreads();
    for (int i = tid; i < kF32Keys * D; i += kF32Rows * 32) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < p.kv_len;
      Ks[r * DS + c] = ok ? kg[(long long)(k0 + r) * p.k_ss + c] : 0.f;
      Vs[r * DS + c] = ok ? vg[(long long)(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float sc = 0.f;
    for (int c = 0; c < D; ++c) sc = fmaf(Qs[warp * D + c], Ks[lane * DS + c], sc);
    sc = (k0 + lane < p.kv_len) ? (FLASH ? sc : sc * p.scale) : kNeg;
    float mx = sc;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    const float pj = expf(sc - mn);
    float sum = pj;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * al + sum;
    m = mn;
#pragma unroll
    for (int i = 0; i < kF32MaxCols; ++i) o[i] *= al;
    for (int j = 0; j < kF32Keys; ++j) {
      const float pb = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
      for (int i = 0; i < kF32MaxCols; ++i) {
        const int c = lane + 32 * i;
        if (c < D) o[i] = fmaf(pb, Vs[j * DS + c], o[i]);
      }
    }
  }
  if (row < p.Sq) {
#pragma unroll
    for (int i = 0; i < kF32MaxCols; ++i) {
      const int c = lane + 32 * i;
      if (c < D) og[(long long)row * p.o_ss + c] = o[i] / l;
    }
    if (FLASH && lane == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] = m + logf(l);
  }
}

template <bool FLASH>
int launch_f32(const AttnParams& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kF32Keys * (p.D + 1) + kF32Rows * p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_f32_kernel<FLASH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + kF32Rows - 1) / kF32Rows, p.H, p.B);
  attn_fwd_f32_kernel<FLASH><<<grid, kF32Rows * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16 tiles by head width; the flash route stops at D = 160 (SD1.x's
// widest head), K1 goes on to the VAE's single 512-wide head
template <bool FLASH>
int dispatch(const AttnParams& p, int dtype, cudaStream_t st) {
  const int D = p.D;
  if (dtype == MOS_F32) return launch_f32<FLASH>(p, st);
  if (dtype != MOS_BF16) return -1;
  if (D <= 16) return launch_bf16<16, 4, 64, false, FLASH>(p, st);
  if (D <= 32) return launch_bf16<32, 4, 64, false, FLASH>(p, st);
  if (D <= 48) return launch_bf16<48, 4, 64, false, FLASH>(p, st);
  if (D <= 64) return launch_bf16<64, 4, 64, false, FLASH>(p, st);
  if (D <= 80) return launch_bf16<80, 4, 64, false, FLASH>(p, st);
  if (D <= 96) return launch_bf16<96, 4, 64, false, FLASH>(p, st);
  if (D <= 128) return launch_bf16<128, 4, 64, false, FLASH>(p, st);
  if (D <= 160) return launch_bf16<160, 4, 32, true, FLASH>(p, st);
  if constexpr (FLASH) {
    return -1;
  } else {
    if (D <= 256) return launch_bf16<256, 4, 32, true, false>(p, st);
    return launch_bf16<512, 2, 32, true, false>(p, st);
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success), or -1 for a head width the
// kernel does not take (D > 512). Strides are in elements; within a token
// the heads are contiguous (head stride D, element stride 1).
extern "C" int mos_attn_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int Sq, int Sk, int H, int D,
                            int kv_len, long long q_sb, long long q_ss,
                            long long k_sb, long long k_ss, long long v_sb,
                            long long v_ss, long long o_sb, long long o_ss,
                            float scale, int dtype, void* stream) {
  AttnParams p{q, k, v, o, B, Sq, Sk, H, D, kv_len,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale, nullptr};
  if (D < 1 || D > 512 || kv_len < 1 || kv_len > Sk) return -1;
  return dispatch<false>(p, dtype, static_cast<cudaStream_t>(stream));
}

// K4: the same over all Sk keys, scale folded into q, and the LSE stored
// to `lse`, contiguous (B, H, Sq) fp32. Returns -1 for D > 160.
extern "C" int mos_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int Sq, int Sk,
                             int H, int D, long long q_sb, long long q_ss,
                             long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long o_sb, long long o_ss,
                             float scale, int dtype, void* stream) {
  AttnParams p{q, k, v, o, B, Sq, Sk, H, D, Sk,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale, lse};
  if (D < 1 || D > 160 || Sk < 1) return -1;
  return dispatch<true>(p, dtype, static_cast<cudaStream_t>(stream));
}
