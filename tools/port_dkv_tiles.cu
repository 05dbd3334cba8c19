// K5 variants (query tile, blocks an SM), timed against each other on the
// card by tools/port_dkv_tiles.py: variant 0 is (64 queries, 1 block an
// SM), 1 (32, 2), 2 (64, 2), 3 (32, 1), at D 40 and at D 80.
#include "../mixofshow_tpu_torch/csrc/flash_bwd_dkv.cu"

extern "C" int dkv_variant(int which, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* dvec, void* dk, void* dv, int B,
                           int Sq, int Sk, int H, int D, float scale,
                           void* stream) {
  BwdParams p{q, k, v, dout, lse, dvec, dk, dv, B, Sq, Sk, H, D, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 40) {
    switch (which) {
      case 0: return launch_bf16<48, 64, 1>(p, st);
      case 1: return launch_bf16<48, 32, 2>(p, st);
      case 2: return launch_bf16<48, 64, 2>(p, st);
      case 3: return launch_bf16<48, 32, 1>(p, st);
    }
  } else if (D == 80) {
    switch (which) {
      case 0: return launch_bf16<80, 64, 1>(p, st);
      case 1: return launch_bf16<80, 32, 2>(p, st);
      case 2: return launch_bf16<80, 64, 2>(p, st);
      case 3: return launch_bf16<80, 32, 1>(p, st);
    }
  }
  return -1;
}
