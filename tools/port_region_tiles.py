"""K7 (csrc/region_attn.cu) at other runs of pixels a block (warps a block,
tiles of 16 pixels a warp), against its bf16 twin and timed on the card, at
the regional path's four cross-attention shapes (2 images x CFG, 8 heads,
77 keys, chip_smoke.py's three boxes): builds tools/port_region_tiles.cu
(which includes the kernel source) with nvcc, prints what ptxas says of
every instantiation (registers, spills), then calls the thirteen variants (see
the .cu) and the shipped dispatch.

    python tools/port_region_tiles.py

Device milliseconds per call: CUDA events around 20 calls queued behind a
sleep kernel, after 3 warm-up calls.
"""
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
from mixofshow_tpu_torch.ops import region_attention as ra  # noqa: E402
from port_dq_tiles import build, ms, rel_err  # noqa: E402

import chip_smoke as cs  # noqa: E402

VARIANTS = 13
SHAPES = [(64, 40), (32, 80), (16, 160), (8, 160)]


def main():
    lib = build('port_region_tiles')
    c = ctypes
    lib.region_variant.argtypes = ([c.c_int] + [c.c_void_p] * 6
                                   + [c.c_int] * 7
                                   + [c.POINTER(c.c_int), c.c_float,
                                      c.c_void_p])
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    boxes = [box for _, _, box in cs.REGIONS]
    for hw, d in SHAPES:
        b, h, sk = 4, 8, 77

        def rn(*s):
            return torch.randn(*s, generator=g, device=dev).bfloat16()
        q, gk, gv = rn(b, hw * hw, h, d), rn(b, sk, h, d), rn(b, sk, h, d)
        rk, rv = rn(3, b, sk, h, d), rn(3, b, sk, h, d)
        px = ra.boxes_to_grid(boxes, hw, hw)
        c_boxes = (c.c_int * px.size)(*px.ravel().tolist())
        want = ra.region_attention_plain(q, gk, gv, rk, rv, px, (hw, hw))
        for which in range(VARIANTS):
            o = torch.empty_like(q)

            def go():
                return lib.region_variant(
                    which, q.data_ptr(), gk.data_ptr(), gv.data_ptr(),
                    rk.data_ptr(), rv.data_ptr(), o.data_ptr(), b, hw * hw,
                    h, d, hw, sk, 3, c_boxes, d ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
            rc = go()
            if rc == -1:
                continue
            if rc:
                raise RuntimeError(f'variant {which}: rc {rc}')
            torch.cuda.synchronize()
            print(f'({b},{hw}x{hw},{h},{d}) variant {which}: error '
                  f'{rel_err(o, want):.3e} of max|twin|, {ms(go):.4f} ms',
                  flush=True)
        args = (q, gk, gv, rk, rv, px, (hw, hw))
        got = ra.region_attention(*args)
        print(f'({b},{hw}x{hw},{h},{d}) shipped: error '
              f'{rel_err(got, want):.3e}, '
              f'{ms(lambda: ra.region_attention(*args)):.4f} ms', flush=True)


if __name__ == '__main__':
    main()
