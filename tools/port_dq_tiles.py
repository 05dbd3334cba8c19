"""K6 (csrc/flash_bwd_dq.cu) at one and two warpgroups a block, against its
twin and timed on the card, at the training path's (2,4096,8,40) and
(2,1024,8,80), and, exploratory, at grids that fill few SMs: builds
tools/port_dq_tiles.cu (which includes the kernel source) with nvcc, prints
what ptxas says of every instantiation (registers, spills, wgmma
serialisation), then calls the variants and the shipped dispatch (two
warpgroups).

    python tools/port_dq_tiles.py

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

VARIANTS = 2
# the training path's two shapes; then, exploratory, grids of 8, 32 and 64
# blocks of 128 queries, which no training configuration gives (its batch 2
# and 8 heads make 128 blocks or more), where one warpgroup a block was
# tried
SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (1, 512, 2, 40),
          (1, 1024, 4, 40), (2, 1024, 4, 80)]


def build(name):
    """nvcc tools/<name>.cu into a library, ptxas's report printed."""
    so = os.path.join(tempfile.mkdtemp(), f'{name}.so')
    r = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-shared',
         '-I', str(_build.CSRC_DIR), '-o', so,
         os.path.join(ROOT, 'tools', f'{name}.cu')],
        capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if any(w in line for w in ('error', 'Used', 'spill', 'wgmma',
                                   'Compiling entry')):
            print(line[:240])
    if r.returncode:
        raise RuntimeError(f'nvcc failed ({r.returncode})')
    return ctypes.CDLL(so)


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


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def main():
    lib = build('port_dq_tiles')
    c = ctypes
    lib.dq_variant.argtypes = ([c.c_int] + [c.c_void_p] * 7 + [c.c_int] * 5
                               + [c.c_float, c.c_void_p])
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for b, s, h, d in SHAPES:
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
                       .bfloat16() for _ in range(4))
        o, lse = fl.flash_fwd(q, k, v)
        dvec = fl.flash_dvec(do, o)
        want = fl.flash_bwd_dq_plain(q, k, v, do, lse, dvec)
        for which in range(VARIANTS):
            dq = torch.empty_like(q)

            def go():
                rc = lib.dq_variant(
                    which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                    dq.data_ptr(), b, s, s, h, d, d ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f'variant {which}: rc {rc}')
            go()
            torch.cuda.synchronize()
            print(f'{(b, s, h, d)} variant {which}: error '
                  f'{rel_err(dq, want):.3e} of max|twin|, {ms(go):.4f} ms',
                  flush=True)
        got = fl.flash_bwd_dq(q, k, v, do, lse, dvec)
        print(f'{(b, s, h, d)} shipped: error {rel_err(got, want):.3e}, '
              f'{ms(lambda: fl.flash_bwd_dq(q, k, v, do, lse, dvec)):.4f} '
              'ms', flush=True)


if __name__ == '__main__':
    main()
