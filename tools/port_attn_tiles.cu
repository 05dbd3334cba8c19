// K1/K4 (csrc/attn_fwd.cu) design and tile variants, timed against each
// other on the card by tools/port_attn_tiles.py. Variant:
//   0 the lock-step design at 96-wide tiles (the route of heads up to 80
//     that TMA cannot read)
//   ping-pong (keys a tile, consumer warpgroups, ring stages):
//   1 (128, 3, 3), shipped up to DP 48      2 (128, 2, 3), shipped above
//   3 (96, 3, 3)    4 (64, 4, 4)    5 (64, 3, 4)    6 (128, 3, 4)
//   7 (128, 2, 2)
// at D 40 (DP 48) and D 80 (DP 80). Build with csrc/attn_wide.cu, which
// attn_fwd.cu's dispatch calls for wide heads.
#include "../mixofshow_tpu_torch/csrc/attn_fwd.cu"

namespace {

template <int DP>
int variant(int which, const AttnParams& p, cudaStream_t st) {
  switch (which) {
    case 0: return launch_bf16<96, 2, 4>(p, st);
    case 1: return launch_ws<DP, 128, 3, 3>(p, st);
    case 2: return launch_ws<DP, 128, 2, 3>(p, st);
    case 3: return launch_ws<DP, 96, 3, 3>(p, st);
    case 4: return launch_ws<DP, 64, 4, 4>(p, st);
    case 5: return launch_ws<DP, 64, 3, 4>(p, st);
    case 6: return launch_ws<DP, 128, 3, 4>(p, st);
    case 7: return launch_ws<DP, 128, 2, 2>(p, st);
  }
  return -1;
}

}  // namespace

// bf16 only; lse may be null (K1) or a (B, H, Sq) fp32 buffer (K4)
extern "C" int attn_variant(int which, const void* q, const void* k,
                            const void* v, void* o, float* lse, int B,
                            int Sq, int Sk, int H, int D, int kv_len,
                            long long q_sb, long long q_ss, long long k_sb,
                            long long k_ss, long long v_sb, long long v_ss,
                            long long o_sb, long long o_ss, float scale,
                            void* stream) {
  AttnParams p{q, k, v, o, B, Sq, Sk, H, D, kv_len,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale, lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 40) return variant<48>(which, p, st);
  if (D == 80) return variant<80>(which, p, st);
  return -1;
}
