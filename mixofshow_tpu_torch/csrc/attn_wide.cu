// attn_wide: the attention core for one wide head, softmax(q kᵀ · scale) v
// with an online softmax, bf16 in and out, head width D in (160, 512], keys
// >= kv_len masked; over the (B, S, H, D) layout (heads contiguous within a
// token, any token and batch strides).
//
// The core of K3 (ops/fused_attention.attention_block), which replaces the
// TPU kernel mixofshow_tpu/ops/fused_attention.py `_kernel`: the VAE
// mid-block's attention, one 512-wide head over 4096 tokens a sample. It is
// also the bf16 route of `attn_fwd` (K1's entry point, mos_attn_fwd) for D
// in (160, 512]. The TPU kernel materialised a whole row of logits per query
// block in VMEM; here keys stream through in tiles with a running max and
// sum, so no logit matrix ever exists and the length of S is not limited
// (a 1024×2048 canvas decodes 32,768 VAE tokens).
//
// What bounds it on the card: 4·Sq·Sk·D flops per head (68.7 GFLOP at
// (2, 4096, 512), 69 µs at the bf16 peak) against 16 MB moved: tensor-core
// bound. The 512-wide head is what makes it awkward: a 64×512 fp32 output
// tile is 128 KB, more registers than one warpgroup has.
//
// Design: a block owns 64 query rows and has two warpgroups; warpgroup i
// owns output columns [256i, 256i+256) of O in registers (128 fp32 a
// thread). The logits are split over D: each warpgroup computes its partial
// S = Q[:, half]·K[:, half]ᵀ (64 × 32 keys, depth 256) with wgmma from
// shared memory, writes it to shared memory in fp32 (double-buffered, one
// named barrier a tile) and adds the other half. Both then run the same
// fp32 online softmax on the same sums (a + b == b + a, so bit for bit), and
// P stays in registers as the A operand of O_half += P·V[:, half]
// (wgmma.m64n256k16, V read transposed from its row-major tile through the
// descriptor). No warpgroup idles and no product runs twice. Q stays
// resident (64 KB, 128B-swizzled panels); K and V stream in 32-key tiles
// through two stages of cp.async 16 B copies (2 × 64 KB), the next tile in
// flight while the current one is multiplied; 224 KB of shared memory, one
// block an SM, B·⌈Sq/64⌉·H blocks (128 at the VAE's shape: one wave).
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct WideParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, Sq, Sk, H, D, kv_len;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale;
};

constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 32;      // keys per tile
constexpr int kDP = 512;     // padded head width: 8 panels of 64
constexpr int kPanels = kDP / 64;
constexpr int kQElems = kBQ * kDP;           // 64 KB
constexpr int kKVElems = kBK * kDP;          // 32 KB each of K and V
constexpr int kXFloats = 2 * 2 * 16 * 128;   // 2 buffers × 2 warpgroups
constexpr int kSmem = (kQElems + 4 * kKVElems) * 2 + kXFloats * 4;
constexpr float kNeg = -1e30f;  // masked logit, as the TPU kernel's NEG_INF

__global__ void __launch_bounds__(256, 1)
    attn_wide_kernel(const __grid_constant__ WideParams p) {
  using namespace mos::sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + kQElems;  // stage s: K at KV + 2s·kKVElems, V after it
  float* Xs = reinterpret_cast<float*>(KV + 4 * kKVElems);

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D;
  const bf16* qg = p.q + b * p.q_sb + (long long)h * D;
  const bf16* kg = p.k + b * p.k_sb + (long long)h * D;
  const bf16* vg = p.v + b * p.v_sb + (long long)h * D;

  // chunk cc (8 columns) of row r: panel cc / 8, chunk cc % 8 in it
  for (int ci = tid; ci < kBQ * kDP / 8; ci += 256) {
    const int r = ci / (kDP / 8), cc = ci % (kDP / 8);
    load_chunk(Qs + (cc / 8) * kBQ * 64 + sw128(r, cc % 8),
               qg + (long long)(q0 + r) * p.q_ss + cc * 8,
               q0 + r < p.Sq ? D - cc * 8 : 0);
  }
  auto load_kv = [&](int stage, int kt) {
    bf16* ks = KV + 2 * stage * kKVElems;
    bf16* vs = ks + kKVElems;
    const int k0 = kt * kBK;
    for (int ci = tid; ci < kBK * kDP / 8; ci += 256) {
      const int r = ci / (kDP / 8), cc = ci % (kDP / 8);
      const int off = (cc / 8) * kBK * 64 + sw128(r, cc % 8);
      const int valid = k0 + r < p.kv_len ? D - cc * 8 : 0;
      load_chunk(ks + off, kg + (long long)(k0 + r) * p.k_ss + cc * 8, valid);
      load_chunk(vs + off, vg + (long long)(k0 + r) * p.v_ss + cc * 8, valid);
    }
  };

  const int n_tiles = (p.kv_len + kBK - 1) / kBK;
  load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  // rows g and g+8 of this warp's 16: log2-domain running max and this
  // thread's partial row sums
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * 1.4426950408889634f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1, k0 = kt * kBK;
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const bf16* ks = KV + 2 * stage * kKVElems;
    const bf16* vs = ks + kKVElems;

    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int pp = 0; pp < kPanels / 2; ++pp) {
      const int pn = wg * (kPanels / 2) + pp;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<32>::ss(s, desc(Qs + pn * kBQ * 64 + kk * 16, 16, 1024, kB128),
                      desc(ks + pn * kBK * 64 + kk * 16, 16, 1024, kB128), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // exchange the partial logits: this thread's 16 at the same index in
    // both warpgroups (the same rows and keys)
    float4* mine = reinterpret_cast<float4*>(Xs + ((kt & 1) * 2 + wg) * 2048);
    const float4* other =
        reinterpret_cast<const float4*>(Xs + ((kt & 1) * 2 + 1 - wg) * 2048);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mine[i * 128 + lt] =
          make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    named_sync(1, 256);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = other[i * 128 + lt];
      s[4 * i] += x.x;
      s[4 * i + 1] += x.y;
      s[4 * i + 2] += x.z;
      s[4 * i + 3] += x.w;
    }

    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      const float x = col < p.kv_len ? s[i] * sl2 : kNeg;
      s[i] = x;
      if ((i & 3) < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
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
    for (int i = 0; i < 16; ++i) {
      s[i] = exp2f(s[i] - ((i & 3) < 2 ? m0 : m1));
      if ((i & 3) < 2) rs0 += s[i]; else rs1 += s[i];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
    // two adjacent 8-key accumulator slices are the A fragment of 16 keys
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = mos::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = mos::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = mos::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = mos::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      Wgmma<256>::rs_t(o, pa[kk],
                       desc(vs + wg * (kPanels / 2) * kBK * 64 + kk * 16 * 64,
                            kBK * 64 * 2, 1024, kB128),
                       1);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);

    __syncthreads();  // both warpgroups are done with this stage
    if (kt + 2 < n_tiles) load_kv(stage, kt + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  bf16* og = p.o + b * p.o_sb + (long long)h * D;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = wg * 256 + j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r1;
      if (col + (e & 1) < D && row < p.Sq)
        og[(long long)row * p.o_ss + col + (e & 1)] =
            __float2bfloat16_rn(o[4 * j + e] * (e < 2 ? inv0 : inv1));
    }
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success) or -1 for arguments it does not
// take (D outside (160, 512], kv_len outside [1, Sk]). Strides in elements.
extern "C" int mos_attn_wide(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int D,
                             int kv_len, long long q_sb, long long q_ss,
                             long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long o_sb, long long o_ss,
                             float scale, void* stream) {
  if (D <= 160 || D > kDP || kv_len < 1 || kv_len > Sk) return -1;
  WideParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o),
               B, Sq, Sk, H, D, kv_len,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale};
  cudaError_t e = cudaFuncSetAttribute(
      attn_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  attn_wide_kernel<<<grid, 256, kSmem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
