// region_attn: region-masked cross-attention of regionally controlled
// sampling. Every pixel attends to the global text context; a pixel inside
// one or more region boxes takes instead the mean, over those boxes, of its
// attention against each box's own text context.
//
// Replaces the TPU kernel mixofshow_tpu/ops/region_attention.py `_kernel`
// (launched by `region_cross_attention`). The TPU kernel tiled the latent
// grid into 64x16 column strips sized for VMEM and computed the global
// attend on every tile; here a warp's box test covers a tile of 16 pixels
// of one (batch, head), as fine as the TPU's strips.
//
// What bounds it on the card: with 77 keys and D <= 160 an attend is
// ~4·77·D flops per pixel against 4·D bytes of q and out, so it reads and
// writes far more than it computes: the least time is q + out over the
// memory rate (21 MB, 6.7 µs, at the SD1.5 path's (4, 64x64, 8, 40)). The
// K/V contexts are small (77 x D each) and stay in L2; what costs is how
// often a block fetches them, the attends a 16-pixel tile repeats where it
// straddles a box's edge, and the latency of each attend's dependent
// chain of mma.sync, ldmatrix and shuffles.
//
// Design (bf16):
//   * tiles of 16 pixels are patches of up to 16 rows by 1 column
//     (tile_grid): the box test stays warp-uniform at 16 pixels (the
//     counterpart of `@pl.when`), and a column of a tall box needs one
//     context where a row of 16 pixels crossing its sides needs two or
//     three; tiles gather their pixels, which costs nothing, since every
//     pixel's D values are one contiguous run in (B, N, H, D) anyway;
//   * a block owns one (batch, head) and NW / S · T tiles; a warp owns T
//     tiles and its fp32 accumulators in registers. The block reads every
//     context its pixels need once, all of them resident in shared memory
//     at a time where they fit (else in chunks, in order), each K and V
//     (<= 128 keys x D) landed by cp.async 16 B copies with Q; padded key
//     rows and head columns are zeroed once. After one barrier each warp
//     attends to the contexts its tiles need, regions in order and the
//     global one last (only where a pixel lies in no box: inside a box its
//     output is discarded), with no barrier a context;
//   * an attend is one max/sum pass (no online softmax): S = Q Kᵀ and
//     O = P V on mma.sync m16n8k16 (bf16 in, fp32 out), every operand
//     fragment read by ldmatrix (V transposed by ldmatrix.trans, not by a
//     copy) from rows padded to DP + 8 elements, so the reads hit distinct
//     banks; P stays in registers as the A operand; padded keys are zero
//     K/V rows and -1e30 logits, as the TPU kernel's NEG_INF; each output
//     tile is folded into the accumulator as it is formed, weighted by
//     1 / row sum where the pixel takes that context;
//   * on grids too small to fill the SMs, S warps share a tile, each
//     taking every S-th context, and their sums are added in a fixed order
//     through shared memory;
//   * the finished rows (the mean over the pixel's boxes, or the global
//     attend) go through the tile's Q rows and out with 16 B stores.
// No atomics touch the output: reruns are bit-identical.
// fp32 inputs take a SIMT kernel (one warp per pixel) that stays fp32
// throughout, for fp32 reference runs on the card.
#include "wgmma.cuh"

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

constexpr int kGlobal = kMaxRegions;  // context bit of the global context

__device__ __forceinline__ bool in_box_yx(const RegionParams& p, int r,
                                          int y, int x) {
  return y >= p.box[r][0] && y < p.box[r][2] && x >= p.box[r][1] &&
         x < p.box[r][3];
}

__device__ __forceinline__ bool in_box(const RegionParams& p, int r, int n) {
  const int y = n / p.W;
  return in_box_yx(p, r, y, n - y * p.W);
}

// The bf16 kernel's tiles of 16 pixels are patches of TH rows x 16 / TH
// columns, TH the largest power of two <= min(16, grid rows): columns of
// 16 pixels lie inside a tall box where rows of 16 would cross its sides.
// Tiles are numbered row-major over the grid of patches.
struct TileGrid {
  int th, tw, tiles_x, tiles;
};

__host__ __device__ __forceinline__ TileGrid tile_grid(int rows, int w) {
  int th = 16;
  while (th > rows) th >>= 1;
  const int tw = 16 / th, tiles_x = (w + tw - 1) / tw;
  return {th, tw, tiles_x, (rows + th - 1) / th * tiles_x};
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

template <int DP, int KP, int NW, int T, int S, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
    region_attn_bf16_kernel(const __grid_constant__ RegionParams p,
                            int slots) {
  using namespace mos::sm90;
  static_assert(DP % 16 == 0 && KP % 16 == 0, "16-wide fragments");
  static_assert(NW % S == 0, "S warps share a group of tiles");
  constexpr int TB = NW / S * T;   // tiles of 16 pixels a block
  constexpr int RUN = TB * 16;     // pixels a block
  constexpr int RS = DP + 8;       // row stride of the Q, K and V tiles
  constexpr int CH = DP / 8;       // 16 B chunks a row
  constexpr int KV = KP * RS;      // one K (or V) tile
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned need_mask;  // contexts the block's pixels need
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kvs = Qs + RUN * RS;  // slot j: K at kvs + 2j·KV, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this warp's share of the contexts and its first tile
  const int split = warp % S, wt = warp / S * T;
  const int tile0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int D = p.D, Sk = p.Sk;
  const long long HD = (long long)p.H * D;
  const float sl2 = p.scale * 1.4426950408889634f;
  const int rows = p.N / p.W;
  const TileGrid tg = tile_grid(rows, p.W);
  // pixel (y, x) of row m of the block's tile i, y = -1 off the grid
  auto pixel = [&](int i, int m, int& y, int& x) {
    const int tile = tile0 + i;
    y = tile / tg.tiles_x * tg.th + m % tg.th;
    x = tile % tg.tiles_x * tg.tw + m / tg.th;
    if (tile >= tg.tiles || y >= rows || x >= p.W) y = -1;
  };
  const bf16* qg =
      static_cast<const bf16*>(p.q) + (long long)b * p.N * HD + h * D;
  bf16* og = static_cast<bf16*>(p.o) + (long long)b * p.N * HD + h * D;

  if (tid == 0) need_mask = 0u;
  // key rows past Sk and head columns past D of every slot are zeroed
  // once: stale shared memory times a zero probability could be NaN
  for (int ci = tid; ci < 2 * slots * KP * CH; ci += NTHREADS) {
    const int r = (ci / CH) % KP, cc = ci % CH;
    if (r >= Sk || cc * 8 >= D)
      *reinterpret_cast<uint4*>(kvs + (ci / (KP * CH)) * KV + r * RS +
                                cc * 8) = make_uint4(0, 0, 0, 0);
  }
  for (int ci = tid; ci < RUN * CH; ci += NTHREADS) {
    const int r = ci / CH, cc = ci % CH;
    int y, x;
    pixel(r / 16, r % 16, y, x);
    load_chunk(Qs + r * RS + cc * 8,
               qg + ((long long)y * p.W + x) * HD + cc * 8,
               y >= 0 ? D - cc * 8 : 0);
  }

  // the pixels of this thread's rows g and g+8 of each of its warp's
  // tiles, their overlap counts, and the contexts the warp needs
  int py[T][2], px[T][2];
  float cnt[T][2];
  unsigned need = 0u;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pixel(wt + i, g + 8 * e, py[i][e], px[i][e]);
      cnt[i][e] = 0.f;
      if (py[i][e] < 0) continue;
      for (int r = 0; r < p.R; ++r)
        if (in_box_yx(p, r, py[i][e], px[i][e])) {
          cnt[i][e] += 1.f;
          need |= 1u << r;
        }
      if (cnt[i][e] == 0.f) need |= 1u << kGlobal;
    }
  need = __reduce_or_sync(0xffffffffu, need);
  __syncthreads();  // need_mask is zero
  if (lane == 0) atomicOr(&need_mask, need);
  __syncthreads();
  const unsigned mask = need_mask;

  auto load_ctx = [&](int c, int slot) {
    const long long off = kv_offset(p, c == kGlobal ? -1 : c, b, h);
    const bf16* kg = static_cast<const bf16*>(c == kGlobal ? p.gk : p.rk) + off;
    const bf16* vg = static_cast<const bf16*>(c == kGlobal ? p.gv : p.rv) + off;
    bf16* ks = kvs + 2 * slot * KV;
    for (int ci = tid; ci < Sk * CH; ci += NTHREADS) {
      const int r = ci / CH, cc = ci % CH;
      if (cc * 8 >= D) continue;
      load_chunk(ks + r * RS + cc * 8, kg + r * HD + cc * 8, D - cc * 8);
      load_chunk(ks + KV + r * RS + cc * 8, vg + r * HD + cc * 8,
                 D - cc * 8);
    }
  };

  float acc[T][DP / 8][4];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses of this lane: A (16 rows x 16 columns of Q) row
  // lane % 16, column 8·(lane / 16); B of S (16 keys x 16 columns of K)
  // key 8·(lane / 16) + lane % 8, column 8·((lane / 8) % 2); B of O (16
  // keys x 16 columns of V, transposed) key 8·((lane / 8) % 2) + lane % 8,
  // column 8·(lane / 16)
  const int a_off = (lane % 16) * RS + (lane / 16) * 8;
  const int k_off = ((lane / 16) * 8 + lane % 8) * RS + ((lane / 8) % 2) * 8;
  const int v_off = (((lane / 8) % 2) * 8 + lane % 8) * RS + (lane / 16) * 8;

  // One tile of 16 rows against the context in `ks` (K, V after it), its
  // output folded into `ac` with weights w0 (row g) and w1 (row g+8) times
  // 1 / row sum
  auto attend = [&](const bf16* qs, const bf16* ks, float w0, float w1,
                    float (&ac)[DP / 8][4]) {
    float s[KP / 8][4];
#pragma unroll
    for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks16 = 0; ks16 < DP / 16; ++ks16) {
      uint32_t a[4];
      mos::ldsm_x4(a, qs + a_off + ks16 * 16);
#pragma unroll
      for (int np = 0; np < KP / 16; ++np) {
        uint32_t kb[4];
        mos::ldsm_x4(kb, ks + k_off + np * 16 * RS + ks16 * 16);
        mos::mma_bf16_16x8x16(s[2 * np], a, kb[0], kb[1]);
        mos::mma_bf16_16x8x16(s[2 * np + 1], a, kb[2], kb[3]);
      }
    }
    float m0 = kNeg, m1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = nt * 8 + 2 * t + (e & 1) < Sk ? s[nt][e] * sl2 : kNeg;
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
    for (int nt = 0; nt < KP / 8; ++nt) {
      s[nt][0] = mos::exp2_ftz(s[nt][0] - m0);
      s[nt][1] = mos::exp2_ftz(s[nt][1] - m0);
      s[nt][2] = mos::exp2_ftz(s[nt][2] - m1);
      s[nt][3] = mos::exp2_ftz(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    w0 /= l0;
    w1 /= l1;
    // the C layout of two adjacent S tiles is the A layout of P (16 keys)
    uint32_t pa[KP / 16][4];
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      pa[kk][0] = mos::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = mos::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = mos::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = mos::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    const bf16* vs = ks + KV + v_off;
#pragma unroll
    for (int jp = 0; jp < DP / 16; ++jp) {
      float c[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        uint32_t vb[4];
        mos::ldsm_x4_trans(vb, vs + kk * 16 * RS + jp * 16);
        mos::mma_bf16_16x8x16(c[0], pa[kk], vb[0], vb[1]);
        mos::mma_bf16_16x8x16(c[1], pa[kk], vb[2], vb[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        ac[2 * jp + x][0] += c[x][0] * w0;
        ac[2 * jp + x][1] += c[x][1] * w0;
        ac[2 * jp + x][2] += c[x][2] * w1;
        ac[2 * jp + x][3] += c[x][3] * w1;
      }
    }
  };

  // The contexts in order (regions, then the global one), `slots` of them
  // resident at a time (all of them where they fit): one barrier a chunk,
  // none a context. Context number k of the order goes to the warps whose
  // split is k % S.
  int k = 0;
  for (unsigned todo = mask; todo;) {
    unsigned chunk = 0u;
    for (int n = 0; todo && n < slots; ++n) {
      chunk |= todo & (0u - todo);  // the lowest context left
      todo &= todo - 1;
    }
    if (k > 0) __syncthreads();  // every warp is done with the slots
    int j = 0;
    for (unsigned m = chunk; m; m &= m - 1) load_ctx(__ffs(m) - 1, j++);
    cp_async_commit();  // with Q in the first chunk
    cp_async_wait<0>();
    __syncthreads();
    j = 0;
    for (unsigned m = chunk; m; m &= m - 1, ++j, ++k) {
      if (k % S != split) continue;
      const int c = __ffs(m) - 1;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        bool inb[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          inb[e] = py[i][e] >= 0 &&
                   (c == kGlobal ? cnt[i][e] == 0.f
                                 : in_box_yx(p, c, py[i][e], px[i][e]));
        if (__any_sync(0xffffffffu, inb[0] || inb[1]))  // warp-uniform
          attend(Qs + (wt + i) * 16 * RS, kvs + 2 * j * KV,
                 inb[0] ? 1.f : 0.f, inb[1] ? 1.f : 0.f, acc[i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with Q and the slots

  if constexpr (S > 1) {
    // the other splits' sums, in order, into split 0's (fp32, through the
    // slots: lane-major, T·DP/2 floats a lane)
    float* part = reinterpret_cast<float*>(kvs);
    constexpr int PW = T * (DP / 2) * 32;  // floats a warp
    if (split != 0) {
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            part[warp * PW + ((i * (DP / 8) + j) * 4 + e) * 32 + lane] =
                acc[i][j][e];
    }
    __syncthreads();
    if (split != 0) return;
    for (int s2 = 1; s2 < S; ++s2)
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] +=
                part[(warp + s2) * PW + ((i * (DP / 8) + j) * 4 + e) * 32 +
                     lane];
  }

  // the mean over the boxes (the global attend has weight 1 where the
  // count is 0) into this warp's tiles' Q rows, then 16 B stores
#pragma unroll
  for (int i = 0; i < T; ++i) {
    bf16* ys = Qs + (wt + i) * 16 * RS;
    const float d0 = cnt[i][0] > 0.f ? 1.f / cnt[i][0] : 1.f;
    const float d1 = cnt[i][1] > 0.f ? 1.f / cnt[i][1] : 1.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ys + g * RS + col) =
          mos::pack_bf16(acc[i][j][0] * d0, acc[i][j][1] * d0);
      *reinterpret_cast<uint32_t*>(ys + (g + 8) * RS + col) =
          mos::pack_bf16(acc[i][j][2] * d1, acc[i][j][3] * d1);
    }
  }
  __syncwarp();
  for (int ci = lane; ci < T * 16 * CH; ci += 32) {
    const int r = wt * 16 + ci / CH, cc = (ci % CH) * 8;
    int y, x;
    pixel(r / 16, r % 16, y, x);
    if (y >= 0 && cc < D)
      store_chunk(og + ((long long)y * p.W + x) * HD + cc, Qs + r * RS + cc,
                  D - cc);
  }
}

constexpr int kSmemBlock = 232448 - 16;  // a block's, less need_mask
constexpr int kSmemHalf = 233472 / 2 - 1024 - 16;  // two blocks an SM

template <int DP, int KP, int NW, int T, int S, int MINB = 1>
int launch_bf16(const RegionParams& p, cudaStream_t stream) {
  constexpr int TB = NW / S * T;
  constexpr int q_bytes = TB * 16 * (DP + 8) * 2;
  constexpr int ctx_bytes = 2 * KP * (DP + 8) * 2;
  constexpr int part_bytes = S > 1 ? NW * T * DP * 64 : 0;
  static_assert(q_bytes + ctx_bytes <= kSmemBlock &&
                q_bytes + part_bytes <= kSmemBlock, "shared memory");
  const int tiles = tile_grid(p.N / p.W, p.W).tiles;
  const long long blocks = (long long)((tiles + TB - 1) / TB) * p.H * p.B;
  // every context resident where they fit beside a second block on the
  // SM, or, on a grid that leaves SMs idle, in the whole of one
  const int budget = blocks > mos::num_sms() ? kSmemHalf : kSmemBlock;
  int slots = (budget - q_bytes) / ctx_bytes;
  if (slots < 1) slots = (kSmemBlock - q_bytes) / ctx_bytes;
  slots = slots < p.R + 1 ? slots : p.R + 1;
  const int ctx = slots * ctx_bytes;
  const int smem = q_bytes + (ctx > part_bytes ? ctx : part_bytes);
  auto kern = region_attn_bf16_kernel<DP, KP, NW, T, S, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tiles + TB - 1) / TB, p.H, p.B);
  kern<<<grid, NW * 32, smem, stream>>>(p, slots);
  return (int)cudaGetLastError();
}

// Blocks by head width and grid, chosen on an H100 SXM at 700 W
// (tools/port_region_tiles.py; ms at the regional path's 77 keys and
// three boxes): on grids that fill three quarters of the SMs, 16 tiles a
// block, as 8 warps of two tiles with two blocks an SM asked of the
// register allocator up to D 64 (0.0425 against 0.047 for 16 warps of one
// at (4,64x64,8,40)) and 16 warps of one at D 80 (0.0172 against 0.0238
// for 8 of one at (4,32x32,8,80)); below that, and past D 80 (where 16
// warps spill), the contexts of a tile split over 2 warps at 4 tiles a
// block (0.0170 against 0.0188 unsplit at (4,16x16,8,160)). A split over
// 4 warps (0.0158 against 0.0189 at the 8x8 layer, 50 launches a request)
// is left to the tool: it would add 14 instantiations to the 24.
template <int DP, int KP>
int launch_runs(const RegionParams& p, cudaStream_t st) {
  const long long heads = (long long)p.B * p.H, fill = 3 * mos::num_sms() / 4;
  const int tiles = tile_grid(p.N / p.W, p.W).tiles;
  const bool full = (tiles + 15) / 16 * heads >= fill;
  if constexpr (DP <= 64) {
    if (full) return launch_bf16<DP, KP, 8, 2, 1, 2>(p, st);
  } else if constexpr (DP <= 80) {
    if (full) return launch_bf16<DP, KP, 16, 1, 1>(p, st);
  }
  return launch_bf16<DP, KP, 8, 1, 2>(p, st);
}

template <int KP>
int dispatch_bf16(const RegionParams& p, cudaStream_t stream) {
  if (p.D <= 16) return launch_runs<16, KP>(p, stream);
  if (p.D <= 32) return launch_runs<32, KP>(p, stream);
  if (p.D <= 48) return launch_runs<48, KP>(p, stream);
  if (p.D <= 64) return launch_runs<64, KP>(p, stream);
  if (p.D <= 80) return launch_runs<80, KP>(p, stream);
  if (p.D <= 128) return launch_runs<128, KP>(p, stream);
  return launch_runs<160, KP>(p, stream);
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
