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
// steps in VMEM. Here one block owns (batch, head, 128 keys) and streams the
// query tiles in a loop, with its accumulators in registers: every output
// element has exactly one writer, no atomics, so reruns are bit-identical.
//
// What bounds it on the card: four products of 2·Sq·Sk·D flops a head, 85.9
// GFLOP at the training path's (2, 4096, 8, 40) (87 µs at the bf16 peak),
// tensor-core bound; at D = 40 every product is thin (depth or width 40),
// so the loads and the softmax-like elementwise work between the products
// weigh as much as the products themselves.
//
// Design (bf16): two warpgroups, 64 keys each; K and V of the block's 128
// keys stay resident in shared memory, the head padded to DP (a multiple of
// 16) only there. Q and dO tiles of BQ queries (32 for D <= 48 and D > 96,
// else 64) and their LSE and Dvec stream through a 3-stage ring of cp.async
// 16 B copies, two tiles in flight. Every tile is held once, in
// 32B-swizzled panels of 16 columns (wgmma.cuh): Sᵀ = K·Q̃ᵀ and dPᵀ = V·dOᵀ
// read the Q̃ and dO tiles K-major (wgmma.m64nBQk16, K and V as the A
// operand from shared memory), and dV += Pᵀ·dO and dK += dSᵀ·Q̃ read the
// same tiles transposed through the descriptor, with Pᵀ and dSᵀ in
// registers as the A operand (their accumulator layout is the A fragment
// layout), N = DP. The scale is folded into each landed Q tile in place,
// q̃ = bf16(q·scale) as on the TPU, before a proxy fence hands the tile to
// wgmma. dK and dV go out through shared memory with 16 B stores.
//   * fp32: a SIMT kernel (one warp per key, 32 queries per tile, one per
//     lane) that computes everything in fp32, for fp32 reference runs.
#include "wgmma.cuh"

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
constexpr int kBK = 128;     // keys per block: 64 per warpgroup
constexpr int kStages = 3;   // query tiles in flight

// One 16 B chunk (4 floats) of a per-query row (lse, Dvec): the first
// `valid` from `src`, `fill` after them.
__device__ __forceinline__ void load_f4(float* dst, const float* src,
                                        int valid, float fill) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    mos::sm90::cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = e < valid ? src[e] : fill;
}

template <int DP, int BQ, int MINB>
__global__ void __launch_bounds__(256, MINB) dkv_bf16_kernel(BwdParams p) {
  using namespace mos::sm90;
  using bf16 = __nv_bfloat16;
  constexpr int NP = DP / 16;          // 32B-swizzled panels of 16 columns
  constexpr int CH = DP / 8;           // 16 B chunks a row
  constexpr int KV_ELEMS = kBK * DP;   // K (and V), resident
  constexpr int T_ELEMS = BQ * DP;     // one Q̃ (or dO) tile
  constexpr int STAGE = 2 * T_ELEMS * 2 + 2 * BQ * 4;  // bytes a stage
  constexpr int YS = DP + 8;           // epilogue row stride

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + KV_ELEMS;
  unsigned char* stages = smem_raw + 2 * KV_ELEMS * 2;
  auto q_tile = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * STAGE);
  };
  auto lse_row = [&](int s) {
    return reinterpret_cast<float*>(stages + s * STAGE + 2 * T_ELEMS * 2);
  };

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, H = p.H;
  const long long tok = (long long)H * D;  // token stride
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.Sq * tok + h * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.Sq * tok + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.Sk * tok + h * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.Sk * tok + h * D;
  const float* lg = p.lse + ((long long)b * H + h) * p.Sq;
  const float* dg = p.dvec + ((long long)b * H + h) * p.Sq;

  // chunk cc of row r: panel cc / 2, chunk cc % 2 in it
  for (int ci = tid; ci < kBK * CH; ci += 256) {
    const int r = ci / CH, cc = ci % CH;
    const int off = (cc / 2) * kBK * 16 + sw32(r, cc % 2);
    const int valid = k0 + r < p.Sk ? D - cc * 8 : 0;
    load_chunk(Ks + off, kg + (k0 + r) * tok + cc * 8, valid);
    load_chunk(Vs + off, vg + (k0 + r) * tok + cc * 8, valid);
  }
  auto load_q = [&](int s, int qt) {
    const int q0 = qt * BQ;
    bf16* qs = q_tile(s);
    bf16* ds = qs + T_ELEMS;
    for (int ci = tid; ci < BQ * CH; ci += 256) {
      const int r = ci / CH, cc = ci % CH;
      const int off = (cc / 2) * BQ * 16 + sw32(r, cc % 2);
      const int valid = q0 + r < p.Sq ? D - cc * 8 : 0;
      load_chunk(qs + off, qg + (q0 + r) * tok + cc * 8, valid);
      load_chunk(ds + off, dog + (q0 + r) * tok + cc * 8, valid);
    }
    float* ls = lse_row(s);
    for (int ci = tid; ci < BQ / 2; ci += 256) {  // lse, then Dvec
      const int i = (ci % (BQ / 4)) * 4;
      if (ci < BQ / 4)
        load_f4(ls + i, lg + q0 + i, p.Sq - q0 - i, kBig);
      else
        load_f4(ls + BQ + i, dg + q0 + i, p.Sq - q0 - i, 0.f);
    }
  };
  // q̃ = bf16(q · scale), in place, on the chunks this thread copied
  auto scale_q = [&](int s) {
    bf16* qs = q_tile(s);
    for (int ci = tid; ci < BQ * CH; ci += 256) {
      const int r = ci / CH, cc = ci % CH;
      uint4* c = reinterpret_cast<uint4*>(qs + (cc / 2) * BQ * 16 +
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

  const int n_tiles = (p.Sq + BQ - 1) / BQ;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_q(s, s);
    cp_async_commit();
  }

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  const bf16* ka = Ks + wg * 64 * 16;  // this warpgroup's 64 keys
  const bf16* va = Vs + wg * 64 * 16;
  const int key0 = k0 + wg * 64 + warp * 16 + g, key1 = key0 + 8;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int s = qt % kStages;
    cp_async_wait<kStages - 2>();
    scale_q(s);
    fence_proxy_async();
    __syncthreads();
    // the stage read in step qt-1 is free: every thread has waited on its
    // products before the barrier
    if (qt + kStages - 1 < n_tiles)
      load_q((qt + kStages - 1) % kStages, qt + kStages - 1);
    cp_async_commit();

    const bf16* qs = q_tile(s);
    const bf16* ds = qs + T_ELEMS;
    const float* ls = lse_row(s);
    // Sᵀ = K Q̃ᵀ and dPᵀ = V dOᵀ: 64 keys × BQ queries, depth DP
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      Wgmma<BQ>::ss(st, desc(ka + pn * kBK * 16, 16, 256, kB32),
                    desc(qs + pn * BQ * 16, 16, 256, kB32), 1);
      Wgmma<BQ>::ss(dpt, desc(va + pn * kBK * 16, 16, 256, kB32),
                    desc(ds + pn * BQ * 16, 16, 256, kB32), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P and dS in place: element i is (key0 or key1, query 8(i/4) + 2t +
    // (i & 1))
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int qc = (i / 4) * 8 + 2 * t + (i & 1);
      const bool live = ((i & 3) < 2 ? key0 : key1) < p.Sk;
      const float pv =
          live ? exp2f(st[i] * kLog2e - ls[qc] * kLog2e) : 0.f;
      st[i] = pv;
      dpt[i] = pv * (dpt[i] - ls[BQ + qc]);
    }
    // two adjacent 8-query slices are the A fragment of 16 queries
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = mos::pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] =
            mos::pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    // dV += Pᵀ dO and dK += dSᵀ Q̃: B is the same tiles, read transposed
    // (16 queries a step, DP columns over NP panels)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Wgmma<DP>::rs_t(dv, pa[kk], desc(ds + kk * 256, BQ * 32, 256, kB32), 1);
      Wgmma<DP>::rs_t(dk, da[kk], desc(qs + kk * 256, BQ * 32, 256, kB32), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK and dV through shared memory (row-major, stride YS), 16 B stores
  bf16* yk = reinterpret_cast<bf16*>(smem_raw);
  bf16* yv = yk + kBK * YS;
  const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(yk + r0 * YS + c) =
        mos::pack_bf16(dk[4 * j], dk[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(yk + (r0 + 8) * YS + c) =
        mos::pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(yv + r0 * YS + c) =
        mos::pack_bf16(dv[4 * j], dv[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(yv + (r0 + 8) * YS + c) =
        mos::pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
  }
  __syncthreads();
  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.Sk * tok + h * D;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.Sk * tok + h * D;
  for (int ci = tid; ci < kBK * CH; ci += 256) {
    const int r = ci / CH, c = (ci % CH) * 8;
    if (k0 + r < p.Sk && c < D) {
      store_chunk(dkg + (k0 + r) * tok + c, yk + r * YS + c, D - c);
      store_chunk(dvg + (k0 + r) * tok + c, yv + r * YS + c, D - c);
    }
  }
}

template <int DP, int BQ, int MINB = 1>
int launch_bf16(const BwdParams& p, cudaStream_t stream) {
  const int smem = 2 * kBK * DP * 2 + kStages * (2 * BQ * DP * 2 + 2 * BQ * 4);
  auto kern = dkv_bf16_kernel<DP, BQ, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sk + kBK - 1) / kBK, p.H, p.B);
  kern<<<grid, 256, smem, stream>>>(p);
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
  // 32-query tiles and two blocks an SM at the narrow heads (on an H100
  // SXM at 700 W: 0.44 against 0.58 ms for 64-query tiles at (2,4096,8,40)),
  // 64-query tiles from D 64 (0.044 against 0.050 ms at (2,1024,8,80));
  // register room caps the wider heads at 32
  if (D <= 16) return launch_bf16<16, 32, 2>(p, st);
  if (D <= 32) return launch_bf16<32, 32, 2>(p, st);
  if (D <= 48) return launch_bf16<48, 32, 2>(p, st);
  if (D <= 64) return launch_bf16<64, 64>(p, st);
  if (D <= 80) return launch_bf16<80, 64>(p, st);
  if (D <= 96) return launch_bf16<96, 64>(p, st);
  if (D <= 128) return launch_bf16<128, 32>(p, st);
  return launch_bf16<160, 32>(p, st);
}
