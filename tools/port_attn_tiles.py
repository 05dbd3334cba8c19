"""K1/K4 (csrc/attn_fwd.cu) at other tiles, against the twins and timed on
the card, at the sampling path's K1 shapes (4,4096,8,40) and (4,1024,8,80)
and the training path's K4 shapes (2,4096,8,40) and (2,1024,8,80): builds
tools/port_attn_tiles.cu (which includes the kernel source) with nvcc,
prints what ptxas says of every instantiation (registers, spills, wgmma
serialisation), then calls its five variants a head width (warpgroups a
block and ring stages: see the .cu) and the shipped dispatch.

    python tools/port_attn_tiles.py

Device milliseconds per call: CUDA events around 20 calls queued behind a
sleep kernel, after 3 warm-up calls.
"""
import ctypes
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
from mixofshow_tpu_torch.ops import _build  # noqa: E402
from mixofshow_tpu_torch.ops import flash_attention as fl  # noqa: E402
from mixofshow_tpu_torch.ops import fused_attention as fa  # noqa: E402

VARIANTS = 5
SHAPES = [('K1', (4, 4096, 8, 40)), ('K1', (4, 1024, 8, 80)),
          ('K4', (2, 4096, 8, 40)), ('K4', (2, 1024, 8, 80))]


def build():
    so = os.path.join(tempfile.mkdtemp(), 'attn_tiles.so')
    r = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-shared',
         '-I', str(_build.CSRC_DIR), '-o', so,
         os.path.join(ROOT, 'tools', 'port_attn_tiles.cu'),
         str(_build.CSRC_DIR / 'attn_wide.cu')],
        capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if any(w in line for w in ('error', 'Used', 'spill', 'wgmma',
                                   'Compiling entry')):
            print(line[:240])
    if r.returncode:
        raise RuntimeError(f'nvcc failed ({r.returncode})')
    lib = ctypes.CDLL(so)
    c = ctypes
    lib.attn_variant.argtypes = ([c.c_int] + [c.c_void_p] * 5
                                 + [c.c_int] * 6 + [c.c_longlong] * 8
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
    late = a.query()
    b.record()
    b.synchronize()
    assert not late, 'the host queued slower than the sleep'
    return a.elapsed_time(b) / it


def main():
    lib = build()
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for kernel, (b, s, h, d) in SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev)
                   .bfloat16() for _ in range(3))
        flash = kernel == 'K4'
        if flash:
            ref, rlse = fl.flash_fwd_plain(q, k, v)
            shipped = lambda: fl.flash_fwd(q, k, v)  # noqa: E731
        else:
            ref = fa.attn_fwd_plain(q, k, v)
            shipped = lambda: fa.attn_fwd(q, k, v)  # noqa: E731
        print(f'{kernel} {(b, s, h, d)}: shipped dispatch '
              f'{ms(shipped):.4f} ms', flush=True)
        for which in range(VARIANTS):
            o = torch.empty_like(q)
            lse = torch.empty((b, h, s), device=dev) if flash else None

            def go():
                rc = lib.attn_variant(
                    which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), None if lse is None else lse.data_ptr(),
                    b, s, s, h, d, s, *q.stride()[:2], *k.stride()[:2],
                    *v.stride()[:2], *o.stride()[:2], 1.0 / math.sqrt(d),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f'variant {which}: rc {rc}')
            go()
            torch.cuda.synchronize()
            # relative to max|twin|, and K4's LSE absolute
            err = ((o.float() - ref.float()).abs().max().item()
                   / ref.float().abs().max().item())
            err = f'o {err:.3e} of max|twin|'
            if flash:
                err += f', lse {(lse - rlse).abs().max().item():.3e}'
            print(f'{kernel} D {d} variant {which}: error {err}, '
                  f'{ms(go):.4f} ms', flush=True)


if __name__ == '__main__':
    main()
