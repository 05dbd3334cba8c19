"""Time the port's K1 (attn_fwd), K3 (attention_block), K4 (flash_fwd), K5
(flash_bwd_dkv), K6 (flash_bwd_dq) and K7 (region_attention, the three
boxes of chip_smoke.py's REGIONS) at their main-path shapes, on the card,
for the copy of
`mixofshow_tpu_torch` under <root>: the repository itself, or an older
commit unpacked beside it.

    mkdir -p experiments/parent
    git archive <commit> mixofshow_tpu_torch | tar -x -C experiments/parent
    python tools/port_kernels_ab.py experiments/parent parent
    python tools/port_kernels_ab.py . change

Run the two in turns (parent, change, change, parent) on one card: a
package builds its kernels into its own `.torch_ext/`. Prints one line,
OLDNEW {json} with device milliseconds per call (CUDA events around 20
calls queued behind a sleep kernel, after 3 warm-up calls).
"""
import json
import os
import sys

sys.path.insert(0, os.path.abspath(sys.argv[1]))
import torch  # noqa: E402
from mixofshow_tpu_torch.ops import fused_attention as fa  # noqa: E402
from mixofshow_tpu_torch.ops import flash_attention as fl  # noqa: E402
from mixofshow_tpu_torch.ops import region_attention as ra  # noqa: E402

assert fa.__file__.startswith(os.path.abspath(sys.argv[1])), fa.__file__
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(0)


def rn(*s, scale=1.0):
    return (torch.randn(*s, generator=g, device=dev) * scale).bfloat16()


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
    assert not late
    return a.elapsed_time(b) / it


out = {'label': sys.argv[2], 'card': torch.cuda.get_device_name(0)}
x = rn(2, 4096, 512)
w = [rn(512, 512, scale=512 ** -0.5) for _ in range(4)]
bs = [rn(512, scale=0.1) for _ in range(4)]
args = (x, x, *w, bs[3], 1, *bs[:3])
out['K3 (2,4096,512)'] = ms(lambda: fa.attention_block(*args))
for (b, sq, h, d) in [(4, 4096, 8, 40), (4, 1024, 8, 80)]:
    q, k, v = (rn(b, sq, h, d) for _ in range(3))
    out[f'K1 {(b, sq, h, d)}'] = ms(lambda: fa.attn_fwd(q, k, v))
for (b, sq, h, d) in [(2, 4096, 8, 40), (2, 1024, 8, 80)]:
    q, k, v = (rn(b, sq, h, d) for _ in range(3))
    out[f'K4 {(b, sq, h, d)}'] = ms(lambda: fl.flash_fwd(q, k, v))
for (b, sq, h, d) in [(2, 4096, 8, 40), (2, 1024, 8, 80)]:
    q, k, v, do = (rn(b, sq, h, d) for _ in range(4))
    o, lse = fl.flash_fwd(q, k, v)
    dvec = fl.flash_dvec(do, o)
    out[f'K5 {(b, sq, h, d)}'] = ms(
        lambda: fl.flash_bwd_dkv(q, k, v, do, lse, dvec))
    out[f'K6 {(b, sq, h, d)}'] = ms(
        lambda: fl.flash_bwd_dq(q, k, v, do, lse, dvec))
# chip_smoke.py's REGIONS, as normalized (start_h, start_w, end_h, end_w)
boxes = [[0.02, 0.05, 0.95, 0.30], [0.02, 0.35, 0.95, 0.62],
         [0.02, 0.68, 0.95, 0.97]]
for hw, d in [(64, 40), (32, 80), (16, 160), (8, 160)]:
    b, h, sk = 4, 8, 77
    q, gk, gv = rn(b, hw * hw, h, d), rn(b, sk, h, d), rn(b, sk, h, d)
    rk, rv = rn(3, b, sk, h, d), rn(3, b, sk, h, d)
    args = (q, gk, gv, rk, rv, ra.boxes_to_grid(boxes, hw, hw), (hw, hw))
    out[f'K7 {(b, hw * hw, h, d)}'] = ms(lambda: ra.region_attention(*args))
print('OLDNEW', json.dumps(out), flush=True)
