"""K1/K4 (csrc/attn_fwd.cu) in its two designs and at other tiles, against
the twins and timed on the card, at every D 40 and D 80 shape of the
kernel table (PERF.md §6): builds tools/port_attn_tiles.cu (which includes
the kernel source) with nvcc, prints what ptxas says of every
instantiation (registers, spills, wgmma serialisation), then calls the
shipped route (`fwd_route`'s choice), each variant (the lock-step design
and seven ping-pong tilings: see the .cu) and SDPA. The variants at DP 80
with three consumer warpgroups spill (ptxas says so above the times).

    python tools/port_attn_tiles.py [--quick]

`--quick` takes the regional canvas's two rows only. Device milliseconds
per call: CUDA events around 20 calls queued behind a sleep kernel, after
3 warm-up calls. Where the twin's fp32 scores would not fit, it is held to
the first and last 512 query rows.
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
import torch.nn.functional as F  # noqa: E402
from mixofshow_tpu_torch.ops import _build  # noqa: E402
from mixofshow_tpu_torch.ops import flash_attention as fl  # noqa: E402
from mixofshow_tpu_torch.ops import fused_attention as fa  # noqa: E402

VARIANTS = 8
# (kernel, (B, Sq, H, D), Sk, kv_len)
SHAPES = [('K1', (2, 32768, 8, 40), 32768, 32768),
          ('K1', (2, 8192, 8, 80), 8192, 8192),
          ('K1', (4, 4096, 8, 40), 4096, 4096),
          ('K1', (4, 1024, 8, 80), 1024, 1024),
          ('K1', (8, 4096, 8, 40), 4096, 4096),
          ('K1', (8, 1024, 8, 80), 1024, 1024),
          ('K1', (2, 1000, 8, 40), 1100, 1037),
          ('K1', (4, 8192, 8, 40), 8192, 8192),
          ('K1', (4, 2048, 8, 80), 2048, 2048),
          ('K4', (2, 4096, 8, 40), 4096, 4096),
          ('K4', (2, 1024, 8, 80), 1024, 1024),
          ('K4', (4, 4096, 8, 40), 4096, 4096),
          ('K4', (4, 1024, 8, 80), 1024, 1024)]
TWIN_BYTES = 8 * 2 ** 30
TWIN_ROWS = 512


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
                                   'Compiling entry', 'setmaxnreg',
                                   'warning')):
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
    quick = '--quick' in sys.argv
    for kernel, (b, s, h, d), sk, kvl in SHAPES[:2] if quick else SHAPES:
        q = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, sk, h, d, generator=g, device=dev).bfloat16()
                for _ in range(2))
        flash = kernel == 'K4'
        rows = None
        if b * h * s * sk * 4 > TWIN_BYTES:
            rows = torch.cat([torch.arange(TWIN_ROWS),
                              torch.arange(s - TWIN_ROWS, s)]).to(dev)
        qs = q if rows is None else q[:, rows]
        if flash:
            ref, rlse = fl.flash_fwd_plain(qs, k, v)
            shipped = lambda: fl.flash_fwd(q, k, v)  # noqa: E731
            route = fl.launch_route(q, k, v)
        else:
            ref = fa.attn_fwd_plain(qs, k, v, kvl)
            shipped = lambda: fa.attn_fwd(q, k, v, kvl)  # noqa: E731
            route = fl.launch_route(q, k, v)
        kt, vt = k[:, :kvl].transpose(1, 2), v[:, :kvl].transpose(1, 2)
        qt = q.transpose(1, 2)
        sdpa = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        print(f'{kernel} {(b, s, h, d)} Sk {sk} kv_len {kvl}: shipped '
              f'route {route} {ms(shipped):.4f} ms, SDPA {sdpa:.4f} ms',
              flush=True)
        for which in range(VARIANTS):
            o = torch.empty_like(q)
            lse = torch.empty((b, h, s), device=dev) if flash else None

            def go():
                rc = lib.attn_variant(
                    which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), None if lse is None else lse.data_ptr(),
                    b, s, sk, h, d, kvl, *q.stride()[:2], *k.stride()[:2],
                    *v.stride()[:2], *o.stride()[:2], 1.0 / math.sqrt(d),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f'variant {which}: rc {rc}')
            go()
            torch.cuda.synchronize()
            got = o if rows is None else o[:, rows]
            # relative to max|twin|, and K4's LSE absolute
            err = ((got.float() - ref.float()).abs().max().item()
                   / ref.float().abs().max().item())
            err = f'o {err:.3e} of max|twin|'
            if flash:
                lg = lse if rows is None else lse[:, :, rows]
                err += f', lse {(lg - rlse).abs().max().item():.3e}'
            print(f'{kernel} D {d} variant {which}: error {err}, '
                  f'{ms(go):.4f} ms', flush=True)


if __name__ == '__main__':
    main()
