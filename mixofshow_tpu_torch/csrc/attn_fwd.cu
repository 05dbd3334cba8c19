// attn_fwd: attention forward, softmax(q kᵀ · scale) v, over the natural
// (B, S, H, D) layout, with key columns >= kv_len masked.
//
// Replaces two TPU kernels, both through the one entry point mos_attn_fwd
// (at the end of this file):
//   * mixofshow_tpu/ops/fused_attention.py `_packed_fwd_kernel` (K1,
//     launched by `_packed_flash`, wrapped by `attention_packed`);
//   * mixofshow_tpu/ops/flash_attention.py `_fwd_kernel` (K4, the forward
//     of the differentiable `flash_attention`), given an LSE buffer: it also
//     stores the per-row log-sum-exp (B, H, Sq) in fp32 that the backward
//     kernels (flash_bwd_dkv.cu, flash_bwd_dq.cu) recompute P from. The TPU
//     kernel's 8-lane LSE replication was a VMEM tiling artifact and is not
//     copied.
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
// make it tensor-core bound on paper (2.78 ms at the 2x canvas's
// (2, 32768, 8, 40) at the bf16 peak). But each logit costs one exp2 on the
// SMs' special-function units, 16 a clock an SM (3.7e12 a second on an
// H100 SXM), and at D 40 only 160 flops of products: that shape's 1.72e10
// logits need 4.6 ms of exponentials alone, so the softmax sets the pace,
// and the design keeps the tensor cores and the special-function units busy
// at the same time. ex2.approx.ftz, whose denormal results flush to zero,
// is one instruction a logit; exp2f adds more to keep them.
//
// Designs (bf16, D <= 160; fwd_route in ops/flash_attention.py picks one
// per launch and passes it to the entry point as a Route, which it
// refuses where the arguments do not allow it):
//   * ping-pong (attn_fwd_bf16_kernel_ws), heads up to 80 wide that TMA can
//     read (16 B aligned bases, 16 B multiples for the strides): a block
//     owns BQ = 64·NC query rows of one (batch, head) and has NC consumer
//     warpgroups and a producer warpgroup, which gives its registers back
//     (setmaxnreg) for the consumers' accumulators. One producer thread
//     loads Q once and keeps a ring of STAGES K/V stages of BK keys full by
//     TMA (tma.cuh): the tensor maps cover the first kv_len keys and D
//     columns, so the head's pad columns and the rows past kv_len arrive as
//     zeros and nothing is masked on the load; each stage completes on an
//     mbarrier and is refilled once every consumer warp has released it.
//     The consumers issue no load and meet only at those mbarriers and at
//     named barriers that hand the tensor cores round (consumer c waits on
//     barrier 1 + c, issues the next tile's S and this tile's P·V, and
//     passes the turn on): while one consumer's products run, the others
//     run their softmax, and no __syncthreads is left in the loop.
//   * lock-step (attn_fwd_bf16_kernel), heads 81 to 160 wide and those TMA
//     cannot read (at 96-wide tiles): two warpgroups of 64 rows share each
//     K/V tile of a 4-stage cp.async ring of 64 keys, every thread loading
//     (ragged rows zero-filled, pad columns zeroed once) and both passing
//     one __syncthreads a tile.
//   * fp32: a SIMT kernel (one warp per query row, 32 keys per tile) that
//     computes everything in fp32, for fp32 reference runs on the card.
// Heads wider than 160 (to 512: the VAE's single head) go to attn_wide.cu's
// wgmma core (K1 only).
// In both bf16 designs, Q̃ sits in 32B-swizzled panels of 16 columns
// (wgmma.cuh), scaled in place after it lands; S = Q̃·Kᵀ is wgmma.m64nBKk16
// with K read K-major; P, packed to bf16 from S's accumulator (whose layout is
// the A fragment layout), is the register A operand of O += P·V,
// wgmma.m64nDPk16 with V read MN-major through the descriptor: no transposed
// copy. The online softmax (Rows) runs in registers in the accumulator layout
// (log2 domain, quad shuffles for the row max and sum). The next tile's S is
// issued before this tile's P·V. The normalised O goes out through shared
// memory with 16 B stores; the LSE only where the caller passes a buffer for it
// (K4).
//
// The ping-pong tiles, chosen on an H100 SXM at 700 W
// (tools/port_attn_tiles.py): 128-key tiles (at (2, 32768, 8, 40) 7.37 ms,
// 64-key 7.66 with four consumers, 96-key 7.76): half the barriers and O
// rescales a key. Three consumers up to DP 48, at 160 registers each (7.37
// against 8.93 ms for two); at DP 80 three spill and two are faster (0.62
// against 0.93 ms at (2, 8192, 8, 80)). Three ring stages: two starve the
// consumers (11.05 ms), four gain nothing (7.43). The grid is one block a query
// tile: a persistent grid was not built, since the clocks inside the kernel put
// all that a block spends outside its key loop at about 1 % of the 2x canvas's
// time. Tried and not kept, each slower at that shape: a quarter or an eighth
// of the exponentials as a degree-5 polynomial on the FMA pipe (8.02, 7.47
// against 7.09 ms), four max and sum chains a row (7.29), a rescale of O
// skipped where no row's max moved (7.34), and the wait for P·V moved past the
// ring's wait (ptxas places it above the softmax in one basic block; moved, the
// registers run out and ptxas serialises the products). With the
// special-function units about 70 % busy, the rest of the time goes to the
// consumers' waits for the tensor cores to take their products.
#include "tma.cuh"

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
// One warpgroup's 64 query rows of the online softmax, held in registers in
// the wgmma accumulator layout: S of a BK-key tile, P packed to bf16 (two
// adjacent 8-key accumulator slices are the A fragment of 16 keys), O, and
// for rows g and g+8 of the warp's 16 the log2-domain running max and this
// thread's partial row sums (the quad's four are summed at the end).
// Element i of s is (row g or g+8, key k0 + 8(i/4) + 2t + (i & 1)). Both
// designs below run it.
template <int BK, int DP>
struct Rows {
  float s[BK / 2], o[DP / 2];
  uint32_t pa[BK / 16][4];
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const int t;

  __device__ __forceinline__ explicit Rows(int lane) : t(lane % 4) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  }
  // S = Q̃ Kᵀ, one k16 step a panel: dq describes the warpgroup's first
  // row of Q̃ in panels of Q_ROWS rows, dk the K tile's first panel (a
  // descriptor plus a byte offset / 16 describes the address that far on)
  template <int Q_ROWS>
  __device__ __forceinline__ void issue_s(uint64_t dq, uint64_t dk) {
#pragma unroll
    for (int pn = 0; pn < DP / 16; ++pn)
      mos::sm90::Wgmma<BK>::ss(s, dq + pn * (Q_ROWS * 32 / 16),
                               dk + pn * (BK * 32 / 16), pn > 0);
  }
  // O += P V: 16 keys a step, V read transposed (DP columns over the
  // panels) from the tile dv describes (LBO BK·32, SBO 256)
  __device__ __forceinline__ void issue_pv(uint64_t dv) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mos::sm90::Wgmma<DP>::rs_t(o, pa[kk], dv + kk * (512 / 16), 1);
  }
  // s -> P in place (fp32), the running max and sums updated; returns the
  // factors that rescale O
  __device__ __forceinline__ void softmax(int k0, int kv_len, float& al0,
                                          float& al1) {
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
  }
  __device__ __forceinline__ void pack_p() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = mos::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
  __device__ __forceinline__ void rescale_o(float al0, float al1) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
  }
  // after the last P·V: the quad's row sums, the natural-log LSE of rows
  // g and g+8 into lse (rows of the (B, H, Sq) row starting at row 0 of the
  // block; t == 0 writes) where a buffer is given, and O / l as bf16 pairs
  // into a row-major tile at row r (and r + 8), stride ys_stride
  __device__ __forceinline__ void finish(float* lse, int r, int rows_left,
                                         __nv_bfloat16* ys, int ys_stride,
                                         int yr) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    if (lse != nullptr && t == 0) {
      if (r < rows_left) lse[r] = (m0 + log2f(l0)) * kLn2;
      if (r + 8 < rows_left) lse[r + 8] = (m1 + log2f(l1)) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ys + yr * ys_stride + c) =
          mos::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(ys + (yr + 8) * ys_stride + c) =
          mos::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
};

// q̃ = bf16(q · scale), in place, on 16 B chunks [c_begin, c_end) (stepping
// c_step) of the rows of a Q tile in panels of q_rows rows; chunk ci is row
// row0 + ci / CH, column chunk ci % CH
template <int CH>
__device__ __forceinline__ void scale_q_chunks(__nv_bfloat16* Qs, int q_rows,
                                               int row0, int c_begin,
                                               int c_end, int c_step,
                                               float scale) {
  for (int ci = c_begin; ci < c_end; ci += c_step) {
    const int r = row0 + ci / CH, cc = ci % CH;
    uint4* c = reinterpret_cast<uint4*>(Qs + (cc / 2) * q_rows * 16 +
                                        mos::sm90::sw32(r, cc % 2));
    uint4 v = *c;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      e[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *c = v;
  }
}

// O from a row-major shared tile (stride YS) to rows [q0, q0 + rows) of
// the output, 16 B stores, threads lt..rows·CH stepping nt
template <int CH, int YS>
__device__ __forceinline__ void store_o(const AttnParams& p,
                                        const __nv_bfloat16* ys, int q0,
                                        int rows, int h, int b, int lt,
                                        int nt) {
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.D;
  for (int ci = lt; ci < rows * CH; ci += nt) {
    const int r = ci / CH, c = (ci % CH) * 8;
    if (q0 + r < p.Sq && c < p.D)
      mos::sm90::store_chunk(og + (long long)(q0 + r) * p.o_ss + c,
                             ys + r * YS + c, p.D - c);
  }
}

// ---- the lock-step design: small grids, unaligned strides, D 96 to 160
constexpr int kLockKeys = 64;  // keys a K/V tile

template <int DP, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128)
    attn_fwd_bf16_kernel(const __grid_constant__ AttnParams p) {
  using namespace mos::sm90;
  using bf16 = __nv_bfloat16;
  static_assert(DP % 16 == 0, "panels of 16 columns");
  static_assert(STAGES >= 3, "two tiles in flight and one being read");
  constexpr int BK = kLockKeys;
  constexpr int BQ = NWG * 64;      // query rows a block
  constexpr int NT = NWG * 128;     // threads
  constexpr int CH = DP / 8;        // 16 B chunks a row
  constexpr int T_ELEMS = BK * DP;  // one K (or V) tile
  constexpr int YS = DP + 8;        // epilogue row stride

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + BQ * DP;  // stage s: K at ring + 2s·T_ELEMS, V after it

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4;
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

  // Q with the first tile in the first group, then one group a tile
  const int n_tiles = (kv_len + BK - 1) / BK;
  load_kv(0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  // this warpgroup's 64 rows
  const uint64_t dq = desc(Qs + wg * 64 * 16, 16, 256, kB32);
  Rows<BK, DP> rw(lane);
  auto dk = [&](int stage) {
    return desc(ring + 2 * stage * T_ELEMS, 16, 256, kB32);
  };
  auto dv = [&](int stage) {
    return desc(ring + (2 * stage + 1) * T_ELEMS, BK * 32, 256, kB32);
  };

  // tile 0's logits first; then each step issues the next tile's S
  // before this tile's P·V and runs the next softmax under the P·V
  cp_async_wait<STAGES - 2>();
  // q̃ = bf16(q · scale), in place, on the chunks this thread copied
  if (p.scale != 1.f)
    scale_q_chunks<CH>(Qs, BQ, 0, tid, BQ * CH, NT, p.scale);
  fence_proxy_async();
  __syncthreads();
  wg_fence();
  rw.template issue_s<BQ>(dq, dk(0));
  wg_commit();
  wg_wait<0>();
  fence_regs(rw.s);
  float al0, al1;
  rw.softmax(0, kv_len, al0, al1);  // O is zero: nothing to rescale
  rw.pack_p();
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
    rw.template issue_s<BQ>(dq, dk((j + 1) % STAGES));
    wg_commit();
    rw.issue_pv(dv(j % STAGES));
    wg_commit();
    wg_wait<1>();
    fence_regs(rw.s);
    rw.softmax((j + 1) * BK, kv_len, al0, al1);
    wg_wait<0>();
    fence_regs(rw.o);
    fence_regs(rw.pa);
    rw.rescale_o(al0, al1);
    rw.pack_p();
  }
  wg_fence();
  rw.issue_pv(dv((n_tiles - 1) % STAGES));
  wg_commit();
  wg_wait<0>();
  fence_regs(rw.o);

  // O through shared memory (row-major, stride YS, in the ring: every
  // warpgroup is done with it after the barrier), then 16 B stores
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = wg * 64 + warp * 16 + g;  // row in the block
  rw.finish(p.lse == nullptr ? nullptr
                             : p.lse + ((long long)b * p.H + h) * p.Sq + q0,
            r0, p.Sq - q0, ring, YS, r0);
  __syncthreads();
  store_o<CH, YS>(p, ring, q0, BQ, h, b, tid, NT);
}

template <int DP, int NWG, int STAGES>
int launch_bf16(const AttnParams& p, cudaStream_t stream) {
  constexpr int smem =
      (NWG * 64 * DP + STAGES * 2 * kLockKeys * DP) * 2;
  static_assert(smem <= 232448, "shared memory");
  auto kern = attn_fwd_bf16_kernel<DP, NWG, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + NWG * 64 - 1) / (NWG * 64), p.H, p.B);
  kern<<<grid, NWG * 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- the warp-specialised design (ping-pong), D <= 80
struct Maps {
  CUtensorMap q, k, v;
};

// warpgroup NC is the producer; consumer c takes its turn at the tensor
// cores on named barrier 1 + c, and syncs its own 128 threads on NC + 1 + c
template <int DP, int BK, int NC, int STAGES>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
    attn_fwd_bf16_kernel_ws(const __grid_constant__ Maps maps,
                            const __grid_constant__ AttnParams p) {
  using namespace mos::sm90;
  using bf16 = __nv_bfloat16;
  static_assert(DP % 16 == 0 && DP <= 80, "panels of 16 columns");
  static_assert(NC >= 2 && STAGES >= 2, "ping-pong over a ring");
  constexpr int BQ = NC * 64;       // query rows a block
  constexpr int NP = DP / 16;       // panels of 16 columns
  constexpr int CH = DP / 8;        // 16 B chunks a row
  constexpr int T_ELEMS = BK * DP;  // one K (or V) tile
  constexpr int YS = DP + 8;        // epilogue row stride
  // registers a thread: the producer gives back what the consumers take
  constexpr int R_ALL = 65536 / ((NC + 1) * 128) / 8 * 8;
  constexpr int R_PRODUCER = 24;
  constexpr int R_CONSUMER = ((NC + 1) * R_ALL - R_PRODUCER) / NC / 8 * 8;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + BQ * DP;  // stage s: K at ring + 2s·T_ELEMS, V after it
  bf16* ostage = ring + STAGES * 2 * T_ELEMS;  // 64 x YS a consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(ostage + BQ * YS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kv_len = p.kv_len;
  const int n_tiles = (kv_len + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // the producer: one thread keeps the ring full by TMA; a stage is
    // refilled once every consumer warp has released it
    regs_dec<R_PRODUCER>();
    if (lt == 0) {
      mbar_expect_tx(q_full, BQ * DP * 2);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        tma_load_4d(Qs + pn * BQ * 16, &maps.q, q_full, pn * 16, q0, h, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * T_ELEMS * 2);
        bf16* ks = ring + 2 * s * T_ELEMS;
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          tma_load_4d(ks + pn * BK * 16, &maps.k, &full[s], pn * 16, kt * BK,
                      h, b);
          tma_load_4d(ks + T_ELEMS + pn * BK * 16, &maps.v, &full[s],
                      pn * 16, kt * BK, h, b);
        }
      }
    }
    return;
  }

  // a consumer: 64 query rows; it issues no load and meets the others only
  // at the turn barriers and the ring's mbarriers
  regs_inc<R_CONSUMER>();
  const int warp = lt / 32, lane = lt % 32, g = lane / 4;
  const int next = (wg + 1) % NC;
  Rows<BK, DP> rw(lane);
  auto turn = [&]() { named_sync(1 + wg, 256); };
  auto pass = [&]() { named_arrive(1 + next, 256); };
  auto release = [&](int stage) {
    if (lane == 0) mbar_arrive(&empty[stage]);
  };

  mbar_wait(q_full, 0);
  if (p.scale != 1.f) {
    scale_q_chunks<CH>(Qs, BQ, wg * 64, lt, 64 * CH, 128, p.scale);
    fence_proxy_async();
    named_sync(NC + 1 + wg, 128);
  }
  if (wg == NC - 1) pass();  // consumer 0 takes the first turn

  // descriptors of Q̃ and of stage 0's K and V (P·V reads V transposed);
  // a stage's are these plus its offset, a panel's plus the panel's
  const uint64_t dq = desc(Qs + wg * 64 * 16, 16, 256, kB32);
  const uint64_t dk = desc(ring, 16, 256, kB32);
  const uint64_t dv = desc(ring + T_ELEMS, BK * 32, 256, kB32);
  constexpr uint32_t kStageDesc = 2 * T_ELEMS * 2 / 16;

  mbar_wait(&full[0], 0);
  turn();
  wg_fence();
  rw.template issue_s<BQ>(dq, dk);
  wg_commit();
  pass();
  wg_wait<0>();
  fence_regs(rw.s);
  float al0, al1;
  rw.softmax(0, kv_len, al0, al1);  // O is zero: nothing to rescale
  rw.pack_p();
  // stage and phase of tile j (`cur`) and of tile j + 1 (`nxt`)
  int cur = 0, nxt = 1, nxt_phase = 0;
  for (int j = 0; j + 1 < n_tiles; ++j) {
    mbar_wait(&full[nxt], nxt_phase);
    // the next tile's S and this tile's P·V go out in this consumer's
    // turn; its softmax runs under the other consumers' products
    turn();
    wg_fence();
    rw.template issue_s<BQ>(dq, dk + nxt * kStageDesc);
    wg_commit();
    rw.issue_pv(dv + cur * kStageDesc);
    wg_commit();
    pass();
    wg_wait<1>();
    fence_regs(rw.s);
    rw.softmax((j + 1) * BK, kv_len, al0, al1);
    wg_wait<0>();
    fence_regs(rw.o);
    fence_regs(rw.pa);
    release(cur);
    rw.rescale_o(al0, al1);
    rw.pack_p();
    cur = nxt;
    if (++nxt == STAGES) {
      nxt = 0;
      nxt_phase ^= 1;
    }
  }
  turn();
  wg_fence();
  rw.issue_pv(dv + cur * kStageDesc);
  wg_commit();
  // every turn barrier ends with as many arrivals as waits: the last
  // consumer made its first arrival before its first turn
  if (wg != NC - 1) pass();
  wg_wait<0>();
  fence_regs(rw.o);

  // O through this consumer's own staging tile, then 16 B stores
  const int r0 = warp * 16 + g;  // row in this consumer's 64
  bf16* ys = ostage + wg * 64 * YS;
  rw.finish(p.lse == nullptr
                ? nullptr
                : p.lse + ((long long)b * p.H + h) * p.Sq + q0 + wg * 64,
            r0, p.Sq - q0 - wg * 64, ys, YS, r0);
  named_sync(NC + 1 + wg, 128);
  store_o<CH, YS>(p, ys, q0 + wg * 64, 64, h, b, lt, 128);
}

template <int DP, int BK, int NC, int STAGES>
int launch_ws(const AttnParams& p, cudaStream_t stream) {
  using namespace mos::sm90;
  constexpr int BQ = NC * 64;
  constexpr int smem = (BQ * DP + STAGES * 2 * BK * DP + BQ * (DP + 8)) * 2 +
                       (2 * STAGES + 1) * 8;
  static_assert(smem <= 232448, "shared memory");
  Maps maps;
  if (!bshd_map(&maps.q, p.q, p.B, p.Sq, p.H, p.D, p.q_sb, p.q_ss, BQ) ||
      !bshd_map(&maps.k, p.k, p.B, p.kv_len, p.H, p.D, p.k_sb, p.k_ss, BK) ||
      !bshd_map(&maps.v, p.v, p.B, p.kv_len, p.H, p.D, p.v_sb, p.v_ss, BK))
    return -1;
  auto kern = attn_fwd_bf16_kernel_ws<DP, BK, NC, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, (NC + 1) * 128, smem, stream>>>(maps, p);
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

// The ping-pong tiles by head width, chosen on the card
// (tools/port_attn_tiles.py; see the note at the top): 128-key tiles in a
// ring of three stages, three consumer warpgroups up to DP 48 and two
// above, where three would spill the accumulators.
template <int DP>
int launch_pingpong(const AttnParams& p, cudaStream_t st) {
  if constexpr (DP <= 48) return launch_ws<DP, 128, 3, 3>(p, st);
  else return launch_ws<DP, 128, 2, 3>(p, st);
}

// The designs a launch can take, as the wrappers name them
// (ops/flash_attention.py ROUTES, chosen by fwd_route); a launch whose
// arguments its route does not take returns -1.
enum Route { kRouteF32 = 0, kRouteLockstep = 1, kRoutePingpong = 2,
             kRouteWide = 3 };

template <bool FLASH>
int dispatch(const AttnParams& p, int dtype, int route, cudaStream_t st) {
  const int D = p.D;
  if (route == kRouteF32)
    return dtype == MOS_F32 ? launch_f32<FLASH>(p, st) : -1;
  if (dtype != MOS_BF16) return -1;
  if (route == kRoutePingpong) {
    if (!mos::sm90::bshd_tma_ok(p.q, p.B, D, p.q_sb, p.q_ss) ||
        !mos::sm90::bshd_tma_ok(p.k, p.B, D, p.k_sb, p.k_ss) ||
        !mos::sm90::bshd_tma_ok(p.v, p.B, D, p.v_sb, p.v_ss))
      return -1;
    if (D <= 16) return launch_pingpong<16>(p, st);
    if (D <= 32) return launch_pingpong<32>(p, st);
    if (D <= 48) return launch_pingpong<48>(p, st);
    if (D <= 64) return launch_pingpong<64>(p, st);
    if (D <= 80) return launch_pingpong<80>(p, st);
    return -1;
  }
  if (route == kRouteLockstep) {
    // two warpgroups, a 4-stage ring; heads up to 80 wide (those TMA
    // cannot read) take the 96-wide tiles
    if (D <= 96) return launch_bf16<96, 2, 4>(p, st);
    if (D <= 128) return launch_bf16<128, 2, 4>(p, st);
    if (D <= 160) return launch_bf16<160, 2, 4>(p, st);
    return -1;
  }
  if constexpr (!FLASH) {
    if (route == kRouteWide && D > 160)
      return mos_attn_wide(p.q, p.k, p.v, p.o, p.B, p.Sq, p.Sk, p.H, D,
                           p.kv_len, p.q_sb, p.q_ss, p.k_sb, p.k_ss, p.v_sb,
                           p.v_ss, p.o_sb, p.o_ss, p.scale, st);
  }
  return -1;
}

}  // namespace

// The one entry point of K1, K3's core and K4. Returns a cudaError_t code
// (0 on success), or -1 for arguments the kernel does not take: without an
// LSE (K1, K3's core) heads up to 512 wide and the keys >= kv_len masked,
// 1 <= kv_len <= Sk; with one (K4) heads up to 160 wide, every key read
// (kv_len == Sk), and the per-row log-sum-exp stored to `lse`, contiguous
// (B, H, Sq) fp32; and -1 for a route the arguments do not allow (see
// Route). Strides are in elements; within a token the heads are contiguous
// (head stride D, element stride 1).
extern "C" int mos_attn_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int B, int Sq, int Sk,
                            int H, int D, int kv_len, long long q_sb,
                            long long q_ss, long long k_sb, long long k_ss,
                            long long v_sb, long long v_ss, long long o_sb,
                            long long o_ss, float scale, int dtype,
                            int route, void* stream) {
  AttnParams p{q, k, v, o, B, Sq, Sk, H, D, kv_len,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale, lse};
  if (D < 1 || kv_len < 1 || kv_len > Sk) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lse == nullptr)
    return D > 512 ? -1 : dispatch<false>(p, dtype, route, st);
  if (D > 160 || kv_len != Sk) return -1;
  return dispatch<true>(p, dtype, route, st);
}
