// flash_bwd_dq: the dQ half of the FlashAttention-2 backward over the
// contiguous (B, S, H, D) layout, P recomputed from the forward's LSE.
//
// Replaces the TPU kernel mixofshow_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (K6, launched by `_flash_bwd`). With s = (q·scale)·kᵀ
// (the scale folded into q before the bf16 rounding, as on the TPU),
//   P = exp(s - lse),  dS = P ∘ (dO·Vᵀ - Dvec),  dQ = dS·K·scale,
// with Dvec = rowsum(dO ∘ O) precomputed in plain torch. Keys >= Sk get
// p = 0; query rows >= Sq load as zeros and are not stored.
//
// The TPU grid carried the dQ accumulator across sequential key-chunk grid
// steps in VMEM. Here one block owns (batch, head, 64·NWG queries) and
// streams the key tiles in a loop, with dQ in registers: one writer per
// element, no atomics, so reruns are bit-identical.
//
// What bounds it on the card: three products of 2·Sq·Sk·D flops a head,
// 64.4 GFLOP at the training path's (2, 4096, 8, 40) (65 µs at the bf16
// peak), and one exp2 a logit on the SMs' 16-lane special-function units
// (268M at that shape, ≈ 70 µs): at D 40 the exp2s, not the tensor cores,
// set the floor, as for the forward (attn_fwd.cu).
//
// Design (bf16, the shape of flash_bwd_dkv.cu with the roles of keys and
// queries swapped): each of the block's two warpgroups owns 64 query rows
// (NWG is 2 in the dispatch; tools/port_dq_tiles.cu instantiates 1 to time
// the one-warpgroup variant against it); their Q and dO tiles stay
// resident in 32B-swizzled panels of 16 columns (wgmma.cuh), the head
// padded to DP only there, and the scale is folded
// into the landed Q tile in place, q̃ = bf16(q·scale) as on the TPU. K and
// V stream through a 3-stage ring of cp.async 16 B copies in 64-key tiles,
// each held once and shared by the warpgroups; ragged rows are zero-filled,
// pad columns zeroed once. Per tile, S = Q̃·Kᵀ and dP = dO·Vᵀ are
// wgmma.m64n64k16 with K and V read K-major; P = exp2(S·log2e - lse·log2e)
// (ex2.approx.ftz), masked to 0 past Sk, and dS = P ∘ (dP - Dvec) in fp32
// registers, the warpgroup's rows' lse and Dvec held in registers; dS,
// packed to bf16 from its accumulator (whose layout is the A fragment
// layout), is the register A operand of dQ += dS·K, wgmma.m64nDPk16 with
// the same K tile read MN-major through the descriptor: no transposed copy.
// The next tile's S and dP are issued before this tile's dQ product, and
// its dS is formed while that product is in flight. dQ·scale goes out
// through shared memory with 16 B stores.
//   * fp32: a SIMT kernel (one warp per query row, 32 keys per tile, one
//     per lane) that computes everything in fp32, for fp32 reference runs.
#include "wgmma.cuh"

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
constexpr int kBK = 64;      // keys a K/V tile
constexpr int kStages = 3;   // K/V tiles in the ring: two in flight

template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128)
    dq_bf16_kernel(const __grid_constant__ BwdParams p) {
  using namespace mos::sm90;
  using bf16 = __nv_bfloat16;
  static_assert(DP % 16 == 0, "panels of 16 columns");
  constexpr int BQ = NWG * 64;       // query rows a block
  constexpr int NT = NWG * 128;      // threads
  constexpr int NP = DP / 16;        // panels of 16 columns
  constexpr int CH = DP / 8;         // 16 B chunks a row
  constexpr int T_ELEMS = kBK * DP;  // one K (or V) tile
  constexpr int YS = DP + 8;         // epilogue row stride
  static_assert(BQ * YS <= 2 * kStages * T_ELEMS, "epilogue fits the ring");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // q̃, BQ rows
  bf16* dOs = Qs + BQ * DP;                      // dO, BQ rows
  bf16* ring = dOs + BQ * DP;  // stage s: K at ring + 2s·T_ELEMS, V after it

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, H = p.H;
  const long long tok = (long long)H * D;  // token stride
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.Sq * tok + h * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.Sq * tok + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.Sk * tok + h * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.Sk * tok + h * D;

  // chunk cc of row r: panel cc / 2, chunk cc % 2 in it
  for (int ci = tid; ci < BQ * CH; ci += NT) {
    const int r = ci / CH, cc = ci % CH;
    const int off = (cc / 2) * BQ * 16 + sw32(r, cc % 2);
    const int valid = q0 + r < p.Sq ? D - cc * 8 : 0;
    load_chunk(Qs + off, qg + (q0 + r) * tok + cc * 8, valid);
    load_chunk(dOs + off, dog + (q0 + r) * tok + cc * 8, valid);
  }
  // the columns past D of every K and V tile are zeroed once, here; no
  // tile load writes them
  for (int ci = tid; ci < 2 * kStages * kBK * CH; ci += NT) {
    const int tile = ci / (kBK * CH), r = (ci / CH) % kBK, cc = ci % CH;
    if (cc * 8 >= D)
      *reinterpret_cast<uint4*>(ring + tile * T_ELEMS + (cc / 2) * kBK * 16 +
                                sw32(r, cc % 2)) = make_uint4(0, 0, 0, 0);
  }
  auto load_kv = [&](int s, int kt) {
    bf16* ks = ring + 2 * s * T_ELEMS;
    bf16* vs = ks + T_ELEMS;
    const int k0 = kt * kBK;
    for (int ci = tid; ci < kBK * CH; ci += NT) {
      const int r = ci / CH, cc = ci % CH;
      if (cc * 8 >= D) continue;
      const int off = (cc / 2) * kBK * 16 + sw32(r, cc % 2);
      const int valid = k0 + r < p.Sk ? D - cc * 8 : 0;
      load_chunk(ks + off, kg + (k0 + r) * tok + cc * 8, valid);
      load_chunk(vs + off, vg + (k0 + r) * tok + cc * 8, valid);
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

  // Q and dO with the first tile in the first group, then one group a tile
  const int n_tiles = (p.Sk + kBK - 1) / kBK;
  load_kv(0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  // rows g and g+8 of this warp's 16: lse (log2 domain) and Dvec; rows
  // past Sq get 0 and 0, so their P is finite and their dS zero
  const int r0 = wg * 64 + warp * 16 + g;  // row in the block
  const float* lg = p.lse + ((long long)b * H + h) * p.Sq + q0;
  const float* dg = p.dvec + ((long long)b * H + h) * p.Sq + q0;
  const bool live0 = q0 + r0 < p.Sq, live1 = q0 + r0 + 8 < p.Sq;
  const float l0 = live0 ? lg[r0] * kLog2e : 0.f;
  const float l1 = live1 ? lg[r0 + 8] * kLog2e : 0.f;
  const float d0 = live0 ? dg[r0] : 0.f;
  const float d1 = live1 ? dg[r0 + 8] : 0.f;

  const bf16* qa = Qs + wg * 64 * 16;   // this warpgroup's 64 rows
  const bf16* oa = dOs + wg * 64 * 16;
  float s[kBK / 2], dp[kBK / 2], dq[DP / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  uint32_t dsa[kBK / 16][4];

  // S = Q̃ Kᵀ and dP = dO Vᵀ of the tile in `stage`: one k16 step a panel
  auto issue_sdp = [&](int stage) {
    const bf16* ks = ring + 2 * stage * T_ELEMS;
    const bf16* vs = ks + T_ELEMS;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      Wgmma<kBK>::ss(s, desc(qa + pn * BQ * 16, 16, 256, kB32),
                     desc(ks + pn * kBK * 16, 16, 256, kB32), pn > 0);
      Wgmma<kBK>::ss(dp, desc(oa + pn * BQ * 16, 16, 256, kB32),
                     desc(vs + pn * kBK * 16, 16, 256, kB32), pn > 0);
    }
  };
  // dQ += dS K: 16 keys a step, K read transposed (DP columns over the
  // panels)
  auto issue_dq = [&](int stage) {
    const bf16* ks = ring + 2 * stage * T_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<DP>::rs_t(dq, dsa[kk], desc(ks + kk * 256, kBK * 32, 256, kB32),
                      1);
  };
  // dS in place of dP (fp32). Element i is (row g or g+8, key k0 +
  // 8(i/4) + 2t + (i & 1)).
  auto form_ds = [&](int k0) {
    const bool ragged = k0 + kBK > p.Sk;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const bool top = (i & 3) < 2;
      float pv = mos::exp2_ftz(fmaf(s[i], kLog2e, top ? -l0 : -l1));
      if (ragged && k0 + (i / 4) * 8 + 2 * t + (i & 1) >= p.Sk) pv = 0.f;
      dp[i] = pv * (dp[i] - (top ? d0 : d1));
    }
  };
  // two adjacent 8-key accumulator slices are the A fragment of 16 keys
  auto pack_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dsa[kk][r] =
            mos::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
  };

  // tile 0's S and dP first; then each step issues the next tile's S and
  // dP before this tile's dQ product and forms the next dS under it
  cp_async_wait<kStages - 2>();
  scale_q();
  fence_proxy_async();
  __syncthreads();
  wg_fence();
  issue_sdp(0);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  form_ds(0);
  pack_ds();
  for (int j = 0; j + 1 < n_tiles; ++j) {
    cp_async_wait<kStages - 3>();  // tile j + 1 has landed
    fence_proxy_async();
    __syncthreads();
    // the stage of tile j - 1 is free: every thread has waited on its
    // products before the barrier
    if (j + kStages - 1 < n_tiles)
      load_kv((j + kStages - 1) % kStages, j + kStages - 1);
    cp_async_commit();
    wg_fence();
    issue_sdp((j + 1) % kStages);
    wg_commit();
    issue_dq(j % kStages);
    wg_commit();
    wg_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    form_ds((j + 1) * kBK);
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(dsa);
    pack_ds();
  }
  wg_fence();
  issue_dq((n_tiles - 1) % kStages);
  wg_commit();
  wg_wait<0>();
  fence_regs(dq);

  // dQ · scale through shared memory (row-major, stride YS, in the ring:
  // every warpgroup is done with it after the barrier), then 16 B stores
  cp_async_wait<0>();
  __syncthreads();
  bf16* ys = ring;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ys + r0 * YS + c) =
        mos::pack_bf16(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
    *reinterpret_cast<uint32_t*>(ys + (r0 + 8) * YS + c) =
        mos::pack_bf16(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
  }
  __syncthreads();
  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.Sq * tok + h * D;
  for (int ci = tid; ci < BQ * CH; ci += NT) {
    const int r = ci / CH, c = (ci % CH) * 8;
    if (q0 + r < p.Sq && c < D)
      store_chunk(dqg + (q0 + r) * tok + c, ys + r * YS + c, D - c);
  }
}

template <int DP, int NWG>
int launch_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = (2 * NWG * 64 * DP + kStages * 2 * kBK * DP) * 2;
  static_assert(smem <= 232448, "shared memory");
  auto kern = dq_bf16_kernel<DP, NWG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + NWG * 64 - 1) / (NWG * 64), p.H, p.B);
  kern<<<grid, NWG * 128, smem, stream>>>(p);
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
//
// Two warpgroups (128 queries) share each K/V tile at every bf16 width: on
// an H100 SXM at 700 W, 0.253 against 0.301 ms for one at (2,4096,8,40)
// and 0.025 against 0.032 at (2,1024,8,80), the training path's shapes
// (tools/port_dq_tiles.py).
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
  if (D <= 16) return launch_bf16<16, 2>(p, st);
  if (D <= 32) return launch_bf16<32, 2>(p, st);
  if (D <= 48) return launch_bf16<48, 2>(p, st);
  if (D <= 64) return launch_bf16<64, 2>(p, st);
  if (D <= 80) return launch_bf16<80, 2>(p, st);
  if (D <= 96) return launch_bf16<96, 2>(p, st);
  if (D <= 128) return launch_bf16<128, 2>(p, st);
  return launch_bf16<160, 2>(p, st);
}
