// K7 variants (NW warps a block, T tiles of 16 pixels a warp, the contexts
// of a tile split over S warps), timed against each other on the card by
// tools/port_region_tiles.py at the regional path's head widths (D 40, 80,
// 160; 77 keys). Variant: (NW, T, S)
//   0: (8, 1, 1)   1: (8, 2, 1), D <= 80 only   2: (4, 1, 1)
//   3: (4, 1, 2)   4: (4, 1, 4)   5: (8, 1, 2)   6: (8, 1, 4)
//   7: (16, 1, 1)
// and with MINB blocks an SM asked of the register allocator:
//   8: (8, 2, 1) x 2, D <= 80   9: (4, 2, 1) x 4, D <= 80
//   10: (8, 1, 1) x 2   11: (4, 1, 1) x 4   12: (8, 1, 2) x 2
// Shipped (launch_runs): 8 up to D 64 and 7 at D 80 where 16 tiles a
// block fill three quarters of the SMs, 5 everywhere else.
#include "../mixofshow_tpu_torch/csrc/region_attn.cu"

template <int DP>
int region_variant_dp(int which, const RegionParams& p, cudaStream_t st) {
  switch (which) {
    case 0: return launch_bf16<DP, 80, 8, 1, 1>(p, st);
    case 2: return launch_bf16<DP, 80, 4, 1, 1>(p, st);
    case 3: return launch_bf16<DP, 80, 4, 1, 2>(p, st);
    case 4: return launch_bf16<DP, 80, 4, 1, 4>(p, st);
    case 5: return launch_bf16<DP, 80, 8, 1, 2>(p, st);
    case 6: return launch_bf16<DP, 80, 8, 1, 4>(p, st);
    case 7: return launch_bf16<DP, 80, 16, 1, 1>(p, st);
    case 10: return launch_bf16<DP, 80, 8, 1, 1, 2>(p, st);
    case 11: return launch_bf16<DP, 80, 4, 1, 1, 4>(p, st);
    case 12: return launch_bf16<DP, 80, 8, 1, 2, 2>(p, st);
  }
  if constexpr (DP <= 80) {
    if (which == 1) return launch_bf16<DP, 80, 8, 2, 1>(p, st);
    if (which == 8) return launch_bf16<DP, 80, 8, 2, 1, 2>(p, st);
    if (which == 9) return launch_bf16<DP, 80, 4, 2, 1, 4>(p, st);
  }
  return -1;
}

extern "C" int region_variant(int which, const void* q, const void* gk,
                              const void* gv, const void* rk, const void* rv,
                              void* o, int B, int N, int H, int D, int W,
                              int Sk, int R, const int* boxes, float scale,
                              void* stream) {
  if (Sk > 80 || R > kMaxRegions) return -1;
  RegionParams p{q, gk, gv, rk, rv, o, B, N, H, D, W, Sk, R, scale, {}};
  for (int r = 0; r < R; ++r)
    for (int k = 0; k < 4; ++k) p.box[r][k] = boxes[4 * r + k];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 40) return region_variant_dp<48>(which, p, st);
  if (D == 80) return region_variant_dp<80>(which, p, st);
  if (D == 160) return region_variant_dp<160>(which, p, st);
  return -1;
}
