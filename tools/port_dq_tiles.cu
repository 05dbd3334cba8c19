// K6 variants (warpgroups a block, i.e. 64 or 128 queries a block), timed
// against each other on the card by tools/port_dq_tiles.py, at D 40 and at
// D 80: variant 0 is one warpgroup, 1 two (shipped).
#include "../mixofshow_tpu_torch/csrc/flash_bwd_dq.cu"

extern "C" int dq_variant(int which, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* dvec, void* dq, int B, int Sq, int Sk,
                          int H, int D, float scale, void* stream) {
  BwdParams p{q, k, v, dout, lse, dvec, dq, B, Sq, Sk, H, D, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 40) {
    switch (which) {
      case 0: return launch_bf16<48, 1>(p, st);
      case 1: return launch_bf16<48, 2>(p, st);
    }
  } else if (D == 80) {
    switch (which) {
      case 0: return launch_bf16<80, 1>(p, st);
      case 1: return launch_bf16<80, 2>(p, st);
    }
  }
  return -1;
}
