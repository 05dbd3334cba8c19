// attn_fwd: attention forward, softmax(q kᵀ · scale) v, over the natural
// (B, S, H, D) layout, with key columns >= kv_len masked.
//
// Replaces two TPU kernels:
//   * mixofshow_tpu/ops/fused_attention.py `_packed_fwd_kernel` (K1,
//     launched by `_packed_flash`, wrapped by `attention_packed`):
//     entry point mos_attn_fwd;
//   * mixofshow_tpu/ops/flash_attention.py `_fwd_kernel` (K4, the forward
//     of the differentiable `flash_attention`): entry point mos_flash_fwd,
//     which also stores the per-row log-sum-exp (B, H, Sq) in fp32 that the
//     backward kernels (flash_bwd_dkv.cu, flash_bwd_dq.cu) recompute P from.
//     The TPU kernel's 8-lane LSE replication was a VMEM tiling artifact and
//     is not copied.
// Both fold the softmax scale into q before the bf16 rounding,
// q̃ = bf16(q · scale), as both TPU kernels do; K3's core passes scale 1.
//
// The TPU K1 zero-padded every head from D to 128 lanes in HBM and held one
// head's whole K/V in VMEM (K4 likewise held K/V resident); here the head
// width is padded only inside shared-memory tiles (to a multiple of 16),
// and K and V stream through in tiles with an online softmax
// (FlashAttention-2 style), so nothing padded ever reaches device memory.
//
// What bounds it on the card: the two products, 4·Sq·Sk·D flops per head,
// make it tensor-core bound on paper (85.9 GFLOP at the sampling path's
// (4, 4096, 8, 40): 87 µs at the bf16 peak). At D = 40 each logit costs
// 80 flops of products but one exp2 on the SMs' 16-lane special-function
// units (145 µs for that shape's 537M logits) and a handful of fp32
// instructions, so the softmax, not the tensor cores, sets the pace; the
// design keeps the products in flight while it runs.
//
// Design (bf16, D <= 160): a block owns BQ = 64 · NWG query rows of one
// (batch, head); each of its NWG warpgroups owns 64 rows, and all of them
// share every K/V tile (four up to D 80 where the grid fills the SMs, else
// two: see launch_tiles). Q̃ is loaded once by cp.async into 32B-swizzled
// panels of 16 columns (wgmma.cuh), the head padded to DP only there, and
// scaled in place after it lands. K and V stream through a ring of STAGES
// cp.async stages of BK keys (two tiles in flight), each tile held once;
// ragged rows are zero-filled, the pad columns zeroed once. S = Q̃·Kᵀ is
// wgmma.m64nBKk16 with K read K-major; P, packed to bf16 from S's
// accumulator (whose layout is the A fragment layout), is the register A
// operand of O += P·V, wgmma.m64nDPk16 with V read MN-major through the
// descriptor: no transposed copy. The online softmax runs in registers in
// the accumulator layout (log2 domain, quad shuffles for the row max and
// sum, exp2 on the special-function unit alone). The next tile's S is
// issued before this tile's P·V, and its softmax runs while P·V is in
// flight. The normalised O goes out through shared memory with 16 B
// stores; the LSE only where the caller passes a buffer for it (K4). Heads
// wider than 160 (to 512: the VAE's single head) go to attn_wide.cu's
// wgmma core (K1 only).
//   * fp32: a SIMT kernel (one warp per query row, 32 keys per tile) that
//     computes everything in fp32, for fp32 reference runs on the card.
#include "wgmma.cuh"

// the wgmma core for D in (160, 512], bf16 (attn_wide.cu)
extern "C" int mos_attn_wide(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int D,
                             int kv_len, long long q_sb, long long q_ss,
                             long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long o_sb, long long o_ss,
                             float scale, void* stream);

namespace {

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, D, kv_len;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale;
  float* lse;  // (B, H, Sq) fp32, or null: written by K4 only
};

constexpr float kNeg = -1e30f;  // masked logit, as the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using mos::exp2_ftz;

// ------------------------------------------------------------------- bf16
constexpr int BK = 64;  // keys a K/V tile

template <int DP, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128)
    attn_fwd_bf16_kernel(const __grid_constant__ AttnParams p) {
  using namespace mos::sm90;
  using bf16 = __nv_bfloat16;
  static_assert(DP % 16 == 0, "panels of 16 columns");
  static_assert(STAGES >= 3, "two tiles in flight and one being read");
  constexpr int BQ = NWG * 64;      // query rows a block
  constexpr int NT = NWG * 128;     // threads
  constexpr int NP = DP / 16;       // panels of 16 columns
  constexpr int CH = DP / 8;        // 16 B chunks a row
  constexpr int T_ELEMS = BK * DP;  // one K (or V) tile
  constexpr int YS = DP + 8;        // epilogue row stride

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + BQ * DP;  // stage s: K at ring + 2s·T_ELEMS, V after it

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, kv_len = p.kv_len;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * D;

  // chunk cc of row r: panel cc / 2, chunk cc % 2 in it
  for (int ci = tid; ci < BQ * CH; ci += NT) {
    const int r = ci / CH, cc = ci % CH;
    load_chunk(Qs + (cc / 2) * BQ * 16 + sw32(r, cc % 2),
               qg + (long long)(q0 + r) * p.q_ss + cc * 8,
               q0 + r < p.Sq ? D - cc * 8 : 0);
  }
  // the columns past D of every K and V tile are zeroed once, here; no
  // tile load writes them
  for (int ci = tid; ci < 2 * STAGES * BK * CH; ci += NT) {
    const int tile = ci / (BK * CH), r = (ci / CH) % BK, cc = ci % CH;
    if (cc * 8 >= D)
      *reinterpret_cast<uint4*>(ring + tile * T_ELEMS + (cc / 2) * BK * 16 +
                                sw32(r, cc % 2)) = make_uint4(0, 0, 0, 0);
  }
  auto load_kv = [&](int s, int kt) {
    bf16* ks = ring + 2 * s * T_ELEMS;
    bf16* vs = ks + T_ELEMS;
    const int k0 = kt * BK;
    for (int ci = tid; ci < BK * CH; ci += NT) {
      const int r = ci / CH, cc = ci % CH;
      if (cc * 8 >= D) continue;
      const int off = (cc / 2) * BK * 16 + sw32(r, cc % 2);
      const int valid = k0 + r < kv_len ? D - cc * 8 : 0;
      load_chunk(ks + off, kg + (long long)(k0 + r) * p.k_ss + cc * 8, valid);
      load_chunk(vs + off, vg + (long long)(k0 + r) * p.v_ss + cc * 8, valid);
    }
  };
  // q̃ = bf16(q · scale), in place, on the chunks this thread copied
  auto scale_q = [&]() {
    for (int ci = tid; ci < BQ * CH; ci += NT) {
      const int r = ci / CH, cc = ci % CH;
      uint4* c = reinterpret_cast<uint4*>(Qs + (cc / 2) * BQ * 16 +
                                          sw32(r, cc % 2));
      uint4 v = *c;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(e[i]);
        e[i] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
      }
      *c = v;
    }
  };

  // Q with the first tile in the first group, then one group a tile
  const int n_tiles = (kv_len + BK - 1) / BK;
  load_kv(0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  const bf16* qa = Qs + wg * 64 * 16;  // this warpgroup's 64 rows
  float s[BK / 2], o[DP / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  uint32_t pa[BK / 16][4];
  // rows g and g+8 of this warp's 16: log2-domain running max and this
  // thread's partial row sums (the quad's four are summed at the end)
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  // S = Q̃ Kᵀ of the tile in `stage`: one k16 step a panel
  auto issue_s = [&](int stage) {
    const bf16* ks = ring + 2 * stage * T_ELEMS;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      Wgmma<BK>::ss(s, desc(qa + pn * BQ * 16, 16, 256, kB32),
                    desc(ks + pn * BK * 16, 16, 256, kB32), pn > 0);
  };
  // O += P V: 16 keys a step, V read transposed (DP columns over the panels)
  auto issue_pv = [&](int stage) {
    const bf16* vs = ring + (2 * stage + 1) * T_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::rs_t(o, pa[kk], desc(vs + kk * 256, BK * 32, 256, kB32), 1);
  };
  // s -> P in place (fp32), the running max and sums updated; returns the
  // factors that rescale O. Element i of s is (row g or g+8, key k0 +
  // 8(i/4) + 2t + (i & 1)).
  auto softmax = [&](int k0, float& al0, float& al1) {
    if (k0 + BK > kv_len) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + (i / 4) * 8 + 2 * t + (i & 1) >= kv_len) s[i] = kNeg;
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i & 3) < 2) mx0 = fmaxf(mx0, s[i]); else mx1 = fmaxf(mx1, s[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // tile 0 always holds key 0 < kv_len, so m is finite from then on and
    // every masked logit below gives exp2(-1e30·log2e - m) == 0
    const float mn0 = fmaxf(m0, mx0 * kLog2e), mn1 = fmaxf(m1, mx1 * kLog2e);
    al0 = exp2_ftz(m0 - mn0);
    al1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i & 3) < 2) {
        s[i] = exp2_ftz(fmaf(s[i], kLog2e, -m0));
        rs0 += s[i];
      } else {
        s[i] = exp2_ftz(fmaf(s[i], kLog2e, -m1));
        rs1 += s[i];
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
  };
  // two adjacent 8-key accumulator slices are the A fragment of 16 keys
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = mos::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  auto rescale_o = [&](float al0, float al1) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
  };

  // tile 0's logits first; then each step issues the next tile's S
  // before this tile's P·V and runs the next softmax under the P·V
  cp_async_wait<STAGES - 2>();
  if (p.scale != 1.f) scale_q();
  fence_proxy_async();
  __syncthreads();
  wg_fence();
  issue_s(0);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  float al0, al1;
  softmax(0, al0, al1);  // O is zero: nothing to rescale
  pack_p();
  for (int j = 0; j + 1 < n_tiles; ++j) {
    cp_async_wait<STAGES - 3>();  // tile j + 1 has landed
    fence_proxy_async();
    __syncthreads();
    // the stage of tile j - 1 is free: every thread has waited on both
    // of its products before the barrier
    if (j + STAGES - 1 < n_tiles)
      load_kv((j + STAGES - 1) % STAGES, j + STAGES - 1);
    cp_async_commit();
    wg_fence();
    issue_s((j + 1) % STAGES);
    wg_commit();
    issue_pv(j % STAGES);
    wg_commit();
    wg_wait<1>();
    fence_regs(s);
    softmax((j + 1) * BK, al0, al1);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    rescale_o(al0, al1);
    pack_p();
  }
  wg_fence();
  issue_pv((n_tiles - 1) % STAGES);
  wg_commit();
  wg_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = wg * 64 + warp * 16 + g;  // row in the block
  if (p.lse != nullptr && t == 0) {
    // natural-log LSE from the log2-domain max and the row sum
    float* lrow = p.lse + ((long long)b * p.H + h) * p.Sq + q0;
    if (q0 + r0 < p.Sq) lrow[r0] = (m0 + log2f(l0)) * kLn2;
    if (q0 + r0 + 8 < p.Sq) lrow[r0 + 8] = (m1 + log2f(l1)) * kLn2;
  }

  // O through shared memory (row-major, stride YS, in the ring: every
  // warpgroup is done with it after the barrier), then 16 B stores
  cp_async_wait<0>();
  __syncthreads();
  bf16* ys = ring;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ys + r0 * YS + c) =
        mos::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(ys + (r0 + 8) * YS + c) =
        mos::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  __syncthreads();
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * D;
  for (int ci = tid; ci < BQ * CH; ci += NT) {
    const int r = ci / CH, c = (ci % CH) * 8;
    if (q0 + r < p.Sq && c < D)
      store_chunk(og + (long long)(q0 + r) * p.o_ss + c, ys + r * YS + c,
                  D - c);
  }
}

template <int DP, int NWG, int STAGES>
int launch_bf16(const AttnParams& p, cudaStream_t stream) {
  constexpr int smem = (NWG * 64 * DP + STAGES * 2 * BK * DP) * 2;
  static_assert(smem <= 232448, "shared memory");
  auto kern = attn_fwd_bf16_kernel<DP, NWG, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + NWG * 64 - 1) / (NWG * 64), p.H, p.B);
  kern<<<grid, NWG * 128, smem, stream>>>(p);
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

// bf16 tiles by head width, chosen on the card (tools/port_attn_tiles.py):
// 64-key tiles, the next S issued before this P·V. Up to DP 80 (what fits
// 128 registers a thread), four warpgroups share each K/V tile where the
// grid still fills three quarters of the SMs with them (on an H100 SXM:
// 0.36 against 0.38 ms for two at (4,4096,8,40), 0.035 against 0.038 at
// (4,1024,8,80), where the grid is 128 blocks), else two, which also take
// the wider heads. The flash route stops at D = 160 (SD1.x's widest head),
// K1 hands wider heads (to 512) to attn_wide.cu's core.
template <int DP>
int launch_tiles(const AttnParams& p, cudaStream_t st) {
  if constexpr (DP <= 80) {
    const long long blocks = (long long)((p.Sq + 255) / 256) * p.H * p.B;
    if (4 * blocks >= 3LL * mos::num_sms())
      return launch_bf16<DP, 4, 3>(p, st);
  }
  return launch_bf16<DP, 2, 4>(p, st);
}

template <bool FLASH>
int dispatch(const AttnParams& p, int dtype, cudaStream_t st) {
  const int D = p.D;
  if (dtype == MOS_F32) return launch_f32<FLASH>(p, st);
  if (dtype != MOS_BF16) return -1;
  if (D <= 16) return launch_tiles<16>(p, st);
  if (D <= 32) return launch_tiles<32>(p, st);
  if (D <= 48) return launch_tiles<48>(p, st);
  if (D <= 64) return launch_tiles<64>(p, st);
  if (D <= 80) return launch_tiles<80>(p, st);
  if (D <= 96) return launch_tiles<96>(p, st);
  if (D <= 128) return launch_tiles<128>(p, st);
  if (D <= 160) return launch_tiles<160>(p, st);
  if constexpr (FLASH) {
    return -1;
  } else {
    return mos_attn_wide(p.q, p.k, p.v, p.o, p.B, p.Sq, p.Sk, p.H, D,
                         p.kv_len, p.q_sb, p.q_ss, p.k_sb, p.k_ss, p.v_sb,
                         p.v_ss, p.o_sb, p.o_ss, p.scale, st);
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
