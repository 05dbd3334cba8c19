"""K5 (csrc/flash_bwd_dkv.cu) at other query-tile sizes and blocks per SM,
against its twin and timed on the card, at the training path's
(2,4096,8,40) and (2,1024,8,80): builds tools/port_dkv_tiles.cu (which
includes the kernel source) with nvcc and calls its four variants a
head width (query tile and blocks an SM: see the .cu).

    python tools/port_dkv_tiles.py

Device milliseconds per call: CUDA events around 20 calls queued behind a
sleep kernel, after 3 warm-up calls.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
from mixofshow_tpu_torch.ops import _build  # noqa: E402
from mixofshow_tpu_torch.ops import flash_attention as fl  # noqa: E402


def build():
    so = os.path.join(tempfile.mkdtemp(), 'dkv_tiles.so')
    r = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-shared',
         '-I', str(_build.CSRC_DIR), '-o', so,
         os.path.join(ROOT, 'tools', 'port_dkv_tiles.cu')],
        capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if 'error' in line or 'Used' in line or 'spill' in line:
            print(line[:200])
    if r.returncode:
        raise RuntimeError(f'nvcc failed ({r.returncode})')
    lib = ctypes.CDLL(so)
    c = ctypes
    lib.dkv_variant.argtypes = ([c.c_int] + [c.c_void_p] * 8 + [c.c_int] * 5
                                + [c.c_float, c.c_void_p])
    return lib


def ms(fn, it=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(it):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / it


def main():
    lib = build()
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0))
    for b, s, h, d in [(2, 4096, 8, 40), (2, 1024, 8, 80)]:
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
                       .bfloat16() for _ in range(4))
        o, lse = fl.flash_fwd(q, k, v)
        dvec = fl.flash_dvec(do, o)
        rk, rv = fl.flash_bwd_dkv_plain(q, k, v, do, lse, dvec)
        for which in range(4):
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def go():
                rc = lib.dkv_variant(
                    which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), b, s, s, h, d, d ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f'variant {which}: rc {rc}')
            go()
            torch.cuda.synchronize()
            err = max(((dk.float() - rk.float()).abs().max() /
                       rk.float().abs().max()).item(),
                      ((dv.float() - rv.float()).abs().max() /
                       rv.float().abs().max()).item())
            print(f'D {d} variant {which}: error {err:.3e} of max|twin|, '
                  f'{ms(go):.4f} ms', flush=True)


if __name__ == '__main__':
    main()
