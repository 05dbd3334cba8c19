// region_attn: region-masked cross-attention of regionally controlled
// sampling. Every pixel attends to the global text context; a pixel inside
// one or more region boxes takes instead the mean, over those boxes, of its
// attention against each box's own text context.
//
// Replaces the TPU kernel mixofshow_tpu/ops/region_attention.py `_kernel`
// (launched by `region_cross_attention`). The TPU kernel tiled the latent
// grid into 64x16 column strips sized for VMEM and computed the global
// attend on every tile; here a warp owns 16 consecutive pixels of one
// (batch, head), so the per-warp box test is as fine as the TPU's strips.
//
// What bounds it on the card: with 77 keys and D <= 160 an attend is
// ~2·77·D flops per pixel against 2·D bytes of q and out, so it reads and
// writes far more than it computes (bandwidth- and latency-bound). The
// design keeps traffic to one read of q, one write of out and L2-resident
// K/V tiles:
//   * one block = 4 warps = 64 pixels of one (batch, head); each attend's
//     whole K/V (<= 128 keys x D) sits in shared memory in one tile, so one
//     max/sum pass per attend and no online softmax;
//   * S = Q Kᵀ and O = P V on mma.sync m16n8k16 (bf16 in, fp32 out), softmax
//     and blend in fp32; padded keys are zero rows in K and V and -1e30
//     logits, as the TPU kernel's NEG_INF;
//   * regions first: a warp attends to a region only when one of its 16
//     pixels lies in the box (warp-uniform, the counterpart of `@pl.when`),
//     and folds each output tile into an fp32 accumulator the moment it is
//     formed, so no whole O is ever held (D = 160 fits in registers);
//   * the global attend last, and only by warps with a pixel outside every
//     box: inside a box the global output is discarded anyway;
//   * a block loads a K/V tile only when one of its warps needs it.
// fp32 inputs take a SIMT kernel (one warp per pixel) that stays fp32
// throughout, for fp32 reference runs on the card.
#include "mma.cuh"

namespace {

constexpr int kMaxRegions = 16;
constexpr int kMaxHeadDim = 160;
constexpr int kMaxKeys = 128;
constexpr float kNeg = -1e30f;  // masked logit, as the TPU kernel's NEG_INF

// q and o (B, N, H, D); gk, gv (B, Sk, H, D); rk, rv (R, B, Sk, H, D); all
// contiguous. N = grid rows x W, pixels in row-major order.
struct RegionParams {
  const void* q;
  const void* gk;
  const void* gv;
  const void* rk;
  const void* rv;
  void* o;
  int B, N, H, D, W, Sk, R;
  float scale;
  int box[kMaxRegions][4];  // (sh, sw, eh, ew) pixel bounds, end exclusive
};

__device__ __forceinline__ bool in_box(const RegionParams& p, int r, int n) {
  const int y = n / p.W, x = n - y * p.W;
  return y >= p.box[r][0] && y < p.box[r][2] && x >= p.box[r][1] &&
         x < p.box[r][3];
}

// offset of (batch b, key 0, head h) in a (.., Sk, H, D) K/V of region r
// (r = -1: the global context)
__device__ __forceinline__ long long kv_offset(const RegionParams& p, int r,
                                               int b, int h) {
  const long long rb = r < 0 ? b : (long long)r * p.B + b;
  return rb * p.Sk * p.H * p.D + (long long)h * p.D;
}

// ------------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;

// One warp's 16 rows against the K tile in shared memory: S = Q Kᵀ, fp32
// softmax per row, P packed as bf16 A fragments; inv0/inv1 are 1 / row sum
// for rows g and g+8.
template <int DP, int KP>
__device__ __forceinline__ void attend_probs(const bf16* qr0, const bf16* Ks,
                                             int Sk, float sl2, int g, int t,
                                             uint32_t (&pa)[KP / 16][4],
                                             float& inv0, float& inv1) {
  constexpr int QS = DP + 8;
  constexpr int NT_S = KP / 8;
  const bf16* qr1 = qr0 + 8 * QS;
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
  float m0 = kNeg, m1 = kNeg;
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * t + (e & 1);
      const float x = col < Sk ? s[nt][e] * sl2 : kNeg;
      s[nt][e] = x;
      if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
    }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  // key 0 is always real, so m is finite and every masked logit gives 0
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt) {
    s[nt][0] = exp2f(s[nt][0] - m0);
    s[nt][1] = exp2f(s[nt][1] - m0);
    s[nt][2] = exp2f(s[nt][2] - m1);
    s[nt][3] = exp2f(s[nt][3] - m1);
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  inv0 = 1.f / l0;
  inv1 = 1.f / l1;
  // the C layout of two adjacent S tiles is the A layout of P (16 keys)
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    pa[kk][0] = mos::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = mos::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = mos::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = mos::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// Unnormalised output tile j (8 columns) of P V; vr = Vt + (j*8+g)*VS + 2t.
template <int KP>
__device__ __forceinline__ void pv_tile(const uint32_t (&pa)[KP / 16][4],
                                        const bf16* vr, float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk)
    mos::mma_bf16_16x8x16(c, pa[kk], mos::ld_u32(vr + kk * 16),
                          mos::ld_u32(vr + kk * 16 + 8));
}

template <int DP, int KP, int NW>
__global__ void __launch_bounds__(NW * 32)
    region_attn_bf16_kernel(RegionParams p) {
  constexpr int BQ = NW * 16;
  constexpr int QS = DP + 8;  // row stride (elements) of Q and K tiles
  constexpr int VS = KP + 8;  // row stride of the transposed V tile
  constexpr int NT_O = DP / 8;
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * QS;
  bf16* Vt = Ks + KP * QS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D;
  const long long HD = (long long)p.H * D;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const float sl2 = p.scale * 1.4426950408889634f;

  const long long row0 = (long long)b * p.N * HD + (long long)h * D;
  const bf16* qg = static_cast<const bf16*>(p.q) + row0;
  bf16* og = static_cast<bf16*>(p.o) + row0;
  for (int i = tid; i < BQ * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP;
    Qs[r * QS + c] =
        (q0 + r < p.N && c < D) ? qg[(q0 + r) * HD + c] : zero;
  }

  // K and V rows past Sk and columns past D are zero: stale shared memory
  // times a zero probability could still be NaN
  auto load_kv = [&](const bf16* kg, const bf16* vg) {
    for (int i = tid; i < KP * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      const bool ok = r < p.Sk && c < D;
      Ks[r * QS + c] = ok ? kg[r * HD + c] : zero;
      Vt[c * VS + r] = ok ? vg[r * HD + c] : zero;
    }
  };

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool valid0 = r0 < p.N, valid1 = r1 < p.N;
  const bf16* qr0 = Qs + (warp * 16 + g) * QS + 2 * t;
  const bf16* vbase = Vt + g * VS + 2 * t;

  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float cnt0 = 0.f, cnt1 = 0.f;

  const bf16* rk = static_cast<const bf16*>(p.rk);
  const bf16* rv = static_cast<const bf16*>(p.rv);
  for (int r = 0; r < p.R; ++r) {
    const bool in0 = valid0 && in_box(p, r, r0);
    const bool in1 = valid1 && in_box(p, r, r1);
    const bool need = __any_sync(0xffffffffu, in0 || in1);
    // also the barrier before the tile is overwritten
    if (!__syncthreads_or(need)) continue;
    const long long off = kv_offset(p, r, b, h);
    load_kv(rk + off, rv + off);
    __syncthreads();
    if (!need) continue;
    uint32_t pa[KP / 16][4];
    float inv0, inv1;
    attend_probs<DP, KP>(qr0, Ks, p.Sk, sl2, g, t, pa, inv0, inv1);
    const float w0 = in0 ? inv0 : 0.f, w1 = in1 ? inv1 : 0.f;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      float c[4];
      pv_tile<KP>(pa, vbase + j * 8 * VS, c);
      acc[j][0] += c[0] * w0;
      acc[j][1] += c[1] * w0;
      acc[j][2] += c[2] * w1;
      acc[j][3] += c[3] * w1;
    }
    cnt0 += in0 ? 1.f : 0.f;
    cnt1 += in1 ? 1.f : 0.f;
  }

  const bool gneed = __any_sync(0xffffffffu, (valid0 && cnt0 == 0.f) ||
                                                 (valid1 && cnt1 == 0.f));
  if (__syncthreads_or(gneed)) {
    const long long off = kv_offset(p, -1, b, h);
    load_kv(static_cast<const bf16*>(p.gk) + off,
            static_cast<const bf16*>(p.gv) + off);
    __syncthreads();
  }
  const float d0 = cnt0 > 0.f ? 1.f / cnt0 : 0.f;
  const float d1 = cnt1 > 0.f ? 1.f / cnt1 : 0.f;
  uint32_t pa[KP / 16][4];
  float inv0 = 0.f, inv1 = 0.f;
  if (gneed) attend_probs<DP, KP>(qr0, Ks, p.Sk, sl2, g, t, pa, inv0, inv1);
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if (gneed) pv_tile<KP>(pa, vbase + j * 8 * VS, c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      const bool top = e < 2;
      const int row = top ? r0 : r1;
      const float cnt = top ? cnt0 : cnt1;
      const float v = cnt > 0.f ? acc[j][e] * (top ? d0 : d1)
                                : c[e] * (top ? inv0 : inv1);
      if (col < D && row < p.N)
        og[row * HD + col] = __float2bfloat16_rn(v);
    }
  }
}

template <int DP, int KP>
int launch_bf16(const RegionParams& p, cudaStream_t stream) {
  constexpr int NW = 4, BQ = NW * 16;
  const size_t smem =
      (size_t)(BQ * (DP + 8) + KP * (DP + 8) + DP * (KP + 8)) * sizeof(bf16);
  auto kern = region_attn_bf16_kernel<DP, KP, NW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.N + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, NW * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KP>
int dispatch_bf16(const RegionParams& p, cudaStream_t stream) {
  if (p.D <= 16) return launch_bf16<16, KP>(p, stream);
  if (p.D <= 32) return launch_bf16<32, KP>(p, stream);
  if (p.D <= 48) return launch_bf16<48, KP>(p, stream);
  if (p.D <= 64) return launch_bf16<64, KP>(p, stream);
  if (p.D <= 80) return launch_bf16<80, KP>(p, stream);
  if (p.D <= 128) return launch_bf16<128, KP>(p, stream);
  return launch_bf16<160, KP>(p, stream);
}

// ------------------------------------------------------------------- fp32
constexpr int kF32Warps = 8;                   // one pixel per warp
constexpr int kF32KeySlots = kMaxKeys / 32;    // keys per lane
constexpr int kF32Cols = (kMaxHeadDim + 31) / 32;  // output columns per lane

// One pixel (a warp) against the K/V tile in shared memory (row stride
// D + 1): the normalised attention output, lane owning columns lane + 32 i.
__device__ __forceinline__ void attend_f32(const float* qrow, const float* Ks,
                                           const float* Vs, int Sk, int D,
                                           float scale, int lane,
                                           float (&o)[kF32Cols]) {
  const int DS = D + 1;
  float s[kF32KeySlots];
  float mx = kNeg;
#pragma unroll
  for (int i = 0; i < kF32KeySlots; ++i) {
    const int key = lane + 32 * i;
    float dot = 0.f;
    if (key < Sk)
      for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], Ks[key * DS + c], dot);
    s[i] = key < Sk ? dot * scale : kNeg;
    mx = fmaxf(mx, s[i]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kF32KeySlots; ++i) {
    s[i] = lane + 32 * i < Sk ? expf(s[i] - mx) : 0.f;
    sum += s[i];
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int ci = 0; ci < kF32Cols; ++ci) o[ci] = 0.f;
#pragma unroll
  for (int i = 0; i < kF32KeySlots; ++i) {
    for (int jj = 0; jj < 32; ++jj) {
      const int key = 32 * i + jj;
      if (key >= Sk) break;  // warp-uniform
      const float pb = __shfl_sync(0xffffffffu, s[i], jj);
#pragma unroll
      for (int ci = 0; ci < kF32Cols; ++ci) {
        const int c = lane + 32 * ci;
        if (c < D) o[ci] = fmaf(pb, Vs[key * DS + c], o[ci]);
      }
    }
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int ci = 0; ci < kF32Cols; ++ci) o[ci] *= inv;
}

__global__ void __launch_bounds__(kF32Warps * 32)
    region_attn_f32_kernel(RegionParams p) {
  extern __shared__ float sm[];
  const int D = p.D, DS = D + 1;
  const long long HD = (long long)p.H * D;
  float* Ks = sm;
  float* Vs = Ks + p.Sk * DS;
  float* qrow = Vs + p.Sk * DS + (threadIdx.x / 32) * D;

  const int tid = threadIdx.x, lane = tid % 32;
  const int n = blockIdx.x * kF32Warps + tid / 32, h = blockIdx.y,
            b = blockIdx.z;
  const bool valid = n < p.N;
  const long long row = ((long long)b * p.N + n) * HD + (long long)h * D;
  for (int c = lane; c < D; c += 32)
    qrow[c] = valid ? static_cast<const float*>(p.q)[row + c] : 0.f;

  auto load_kv = [&](const float* kg, const float* vg) {
    for (int i = tid; i < p.Sk * D; i += kF32Warps * 32) {
      const int r = i / D, c = i % D;
      Ks[r * DS + c] = kg[r * HD + c];
      Vs[r * DS + c] = vg[r * HD + c];
    }
  };

  float acc[kF32Cols], o[kF32Cols];
#pragma unroll
  for (int ci = 0; ci < kF32Cols; ++ci) acc[ci] = 0.f;
  float cnt = 0.f;
  const float* rk = static_cast<const float*>(p.rk);
  const float* rv = static_cast<const float*>(p.rv);
  for (int r = 0; r < p.R; ++r) {
    const bool need = valid && in_box(p, r, n);
    if (!__syncthreads_or(need)) continue;
    const long long off = kv_offset(p, r, b, h);
    load_kv(rk + off, rv + off);
    __syncthreads();
    if (!need) continue;
    attend_f32(qrow, Ks, Vs, p.Sk, D, p.scale, lane, o);
#pragma unroll
    for (int ci = 0; ci < kF32Cols; ++ci) acc[ci] += o[ci];
    cnt += 1.f;
  }
  const bool gneed = valid && cnt == 0.f;
  if (__syncthreads_or(gneed)) {
    const long long off = kv_offset(p, -1, b, h);
    load_kv(static_cast<const float*>(p.gk) + off,
            static_cast<const float*>(p.gv) + off);
    __syncthreads();
  }
  if (!valid) return;
  if (gneed) {
    attend_f32(qrow, Ks, Vs, p.Sk, D, p.scale, lane, o);
  } else {
    const float inv = 1.f / cnt;
#pragma unroll
    for (int ci = 0; ci < kF32Cols; ++ci) o[ci] = acc[ci] * inv;
  }
  float* og = static_cast<float*>(p.o) + row;
#pragma unroll
  for (int ci = 0; ci < kF32Cols; ++ci) {
    const int c = lane + 32 * ci;
    if (c < D) og[c] = o[ci];
  }
}

int launch_f32(const RegionParams& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * p.Sk * (p.D + 1) + kF32Warps * p.D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      region_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.N + kF32Warps - 1) / kF32Warps, p.H, p.B);
  region_attn_f32_kernel<<<grid, kF32Warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success), or -1 for arguments the kernel
// does not take. All tensors contiguous: q and o (B, N, H, D) with N = rows
// x W; gk, gv (B, Sk, H, D); rk, rv (R, B, Sk, H, D). `boxes` is a host
// array of R (sh, sw, eh, ew) pixel bounds, copied into the launch.
extern "C" int mos_region_attn(const void* q, const void* gk, const void* gv,
                               const void* rk, const void* rv, void* o, int B,
                               int N, int H, int D, int W, int Sk, int R,
                               const int* boxes, float scale, int dtype,
                               void* stream) {
  if (B < 1 || N < 1 || H < 1 || D < 1 || D > kMaxHeadDim || W < 1 ||
      N % W != 0 || Sk < 1 || Sk > kMaxKeys || R < 1 || R > kMaxRegions)
    return -1;
  RegionParams p{q, gk, gv, rk, rv, o, B, N, H, D, W, Sk, R, scale, {}};
  for (int r = 0; r < R; ++r)
    for (int k = 0; k < 4; ++k) p.box[r][k] = boxes[4 * r + k];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == MOS_F32) return launch_f32(p, st);
  if (dtype != MOS_BF16) return -1;
  return p.Sk <= 80 ? dispatch_bf16<80>(p, st) : dispatch_bf16<128>(p, st);
}
