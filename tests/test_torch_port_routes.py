"""The design that each K1 and K4 launch takes (ops/flash_attention.py
`fwd_route`), and the wrappers that pass it to csrc/attn_fwd.cu and count
launches by design, on the CPU.

The kernels run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phase 3); here the route function is held to the shapes of
the kernel table (PERF.md §6), and the wrappers' CUDA branch runs against a
fake of `_build.cuda_lib` that records what the one entry point,
`mos_attn_fwd`, is given.
"""
import contextlib

import pytest
import torch

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu_torch import ops
from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops import flash_attention as fl
from mixofshow_tpu_torch.ops import fused_attention as fa

BF16 = torch.bfloat16

# every K1 and K4 row of the kernel table: (kernel, (B, Sq, H, D), Sk,
# dtype, design)
TABLE_ROWS = [
    ('K1', (4, 4096, 8, 40), 4096, BF16, 'pingpong'),
    ('K1', (4, 1024, 8, 80), 1024, BF16, 'pingpong'),
    ('K1', (8, 4096, 8, 40), 4096, BF16, 'pingpong'),
    ('K1', (8, 1024, 8, 80), 1024, BF16, 'pingpong'),
    ('K1', (2, 1000, 8, 40), 1100, BF16, 'pingpong'),
    ('K1', (2, 256, 8, 160), 1024, BF16, 'lockstep'),
    ('K1', (4, 8192, 8, 40), 8192, BF16, 'pingpong'),
    ('K1', (4, 2048, 8, 80), 2048, BF16, 'pingpong'),
    ('K1', (2, 32768, 8, 40), 32768, BF16, 'pingpong'),
    ('K1', (2, 8192, 8, 80), 8192, BF16, 'pingpong'),
    ('K1', (2, 2048, 8, 160), 2048, BF16, 'lockstep'),
    ('K4', (2, 4096, 8, 40), 4096, BF16, 'pingpong'),
    ('K4', (2, 1024, 8, 80), 1024, BF16, 'pingpong'),
    ('K4', (2, 1024, 2, 32), 1100, torch.float32, 'fp32'),
    ('K4', (4, 4096, 8, 40), 4096, BF16, 'pingpong'),
    ('K4', (4, 1024, 8, 80), 1024, BF16, 'pingpong'),
]


def _meta(b, s, h, d, dtype=BF16):
    """A contiguous (B, S, H, D) tensor without storage (base address 0)."""
    return torch.empty(b, s, h, d, dtype=dtype, device='meta')


@pytest.mark.parametrize('kernel,shape,sk,dtype,design', TABLE_ROWS)
def test_every_table_row_maps_to_its_design(kernel, shape, sk, dtype,
                                            design):
    b, sq, h, d = shape
    q, k, v = _meta(b, sq, h, d, dtype), _meta(b, sk, h, d, dtype), \
        _meta(b, sk, h, d, dtype)
    assert fl.launch_route(q, k, v) == design
    assert fl.fwd_route(dtype, d, fl.tma_aligned(q, k, v)) == design


@pytest.mark.parametrize('d,aligned,design', [
    (16, True, 'pingpong'), (24, True, 'pingpong'), (64, True, 'pingpong'),
    (80, True, 'pingpong'), (40, False, 'lockstep'), (80, False, 'lockstep'),
    (96, True, 'lockstep'), (128, True, 'lockstep'), (160, True, 'lockstep'),
    (200, True, 'wide'), (512, True, 'wide')])
def test_head_width_and_alignment_pick_the_design(d, aligned, design):
    assert fl.fwd_route(BF16, d, aligned) == design
    assert fl.fwd_route(torch.float32, d, aligned) == 'fp32'


def test_unaligned_inputs_keep_the_lockstep_design():
    """TMA needs 16 B aligned bases and 16 B multiples for every stride
    but a single batch's; anything else goes to the lock-step kernel."""
    def route(q, k, v):
        return fl.fwd_route(q.dtype, q.shape[3], fl.tma_aligned(q, k, v))

    base = torch.zeros(2, 64, 4 * 40 + 8, dtype=BF16)
    q = base[..., :160].view(2, 64, 4, 40)          # token stride 168
    assert fl.tma_aligned(q) and route(q, q, q) == 'pingpong'
    shifted = base[..., 1:161].unflatten(-1, (4, 40))   # base 2 B off
    assert not fl.tma_aligned(shifted)
    assert route(shifted, q, q) == 'lockstep'
    odd = torch.zeros(2, 64, 4 * 40 + 4, dtype=BF16)[..., :160] \
        .unflatten(-1, (4, 40))                      # token stride 164
    assert not fl.tma_aligned(odd) and route(q, odd, q) == 'lockstep'
    narrow = torch.zeros(2, 64, 4, 36, dtype=BF16)   # head stride 72 B
    assert not fl.tma_aligned(narrow)
    assert route(narrow, narrow, narrow) == 'lockstep'
    # one batch: its stride is never stepped
    one = torch.zeros(1, 64, 4 * 40 + 4, dtype=BF16)[..., :160] \
        .unflatten(-1, (4, 40))
    assert one.stride(1) % 8 == 4 and not fl.tma_aligned(one)
    single = torch.zeros(1, 64, 4, 40, dtype=BF16).as_strided(
        (1, 64, 4, 40), (12, 160, 40, 1))
    assert fl.tma_aligned(single)


def test_an_unknown_route_is_refused():
    q = _meta(1, 128, 2, 40)
    with pytest.raises(ValueError, match='route'):
        fl.launch_route(q, q, q, 'persistent')


# mos_attn_fwd's arguments, in order
ENTRY_ARGS = ('q', 'k', 'v', 'o', 'lse', 'B', 'Sq', 'Sk', 'H', 'D', 'kv_len',
              'q_sb', 'q_ss', 'k_sb', 'k_ss', 'v_sb', 'v_ss', 'o_sb', 'o_ss',
              'scale', 'dtype', 'route', 'stream')


class _FakeLib:
    """Stands in for the built library: records the entry point's
    arguments, as ('attn', args) without an LSE and ('flash', args) with
    one, and returns `rc`."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def mos_attn_fwd(self, *args):
        assert len(args) == len(ENTRY_ARGS)
        lse = args[ENTRY_ARGS.index('lse')]
        self.calls.append(('attn' if lse is None else 'flash', args))
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, into a fake library."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, 'cuda_lib', lambda: lib)
    monkeypatch.setattr(_build, 'device_type', lambda *ts: 'cuda')
    monkeypatch.setattr(_build, 'stream', lambda t: 0)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


def _arg(call, name):
    """The argument `name` of a recorded call."""
    return call[1][ENTRY_ARGS.index(name)]


def _route_arg(call):
    """The route passed to the entry point, by its name."""
    return fl.ROUTES[_arg(call, 'route')]


@pytest.mark.parametrize('d,design', [(40, 'pingpong'), (80, 'pingpong'),
                                      (160, 'lockstep'), (512, 'wide')])
def test_attn_fwd_passes_and_counts_its_route(fake_card, d, design):
    q = torch.zeros(2, 64, 2, d, dtype=BF16)
    with torch.no_grad():
        fa.attn_fwd(q, q, q)
        fa.attn_fwd(q, q, q, 50)
    assert [_route_arg(c) for c in fake_card.calls] == [design, design]
    assert [c[0] for c in fake_card.calls] == ['attn', 'attn']
    assert [_arg(c, 'kv_len') for c in fake_card.calls] == [64, 50]
    assert [_arg(c, 'D') for c in fake_card.calls] == [d, d]
    assert fa.attn_fwd.launches == 2
    assert fa.attn_fwd.routes == {design: 2}


def test_attn_fwd_passes_an_explicit_route(fake_card):
    q = torch.zeros(2, 64, 2, 40, dtype=BF16)
    with torch.no_grad():
        fa.attn_fwd(q, q, q, _route='lockstep')
        fa.attn_fwd(q, q, q)
    assert [_route_arg(c) for c in fake_card.calls] == ['lockstep',
                                                        'pingpong']
    assert fa.attn_fwd.routes == {'lockstep': 1, 'pingpong': 1}
    ops.reset_launch_counts()
    assert fa.attn_fwd.routes == {} and fl.flash_fwd.routes == {}


@pytest.mark.parametrize('dtype,d,design', [(BF16, 40, 'pingpong'),
                                            (BF16, 80, 'pingpong'),
                                            (BF16, 128, 'lockstep'),
                                            (torch.float32, 40, 'fp32')])
def test_flash_fwd_passes_and_counts_its_route(fake_card, dtype, d,
                                               design):
    q = torch.zeros(2, 128, 2, d, dtype=dtype)
    o, lse = fl.flash_fwd(q, q, q)
    assert o.shape == q.shape and lse.shape == (2, 2, 128)
    assert [(c[0], _route_arg(c)) for c in fake_card.calls] == [
        ('flash', design)]
    call, = fake_card.calls
    assert _arg(call, 'lse') == lse.data_ptr()
    assert _arg(call, 'o') == o.data_ptr()
    assert _arg(call, 'kv_len') == _arg(call, 'Sk') == 128
    assert fl.flash_fwd.launches == 1 and fl.flash_fwd.routes == {design: 1}


def test_a_route_the_kernel_refuses_raises(fake_card):
    """The entry point returns -1 for a design its arguments do not allow
    (on the card: the ping-pong design past D 80 or on unaligned inputs,
    the wide core for K4); the wrapper raises and counts nothing."""
    fake_card.rc = -1
    q = torch.zeros(2, 64, 2, 160, dtype=BF16)
    with torch.no_grad(), pytest.raises(RuntimeError, match='pingpong'):
        fa.attn_fwd(q, q, q, _route='pingpong')
    with pytest.raises(RuntimeError, match='wide'):
        fl.flash_fwd(q, q, q, _route='wide')
    assert fa.attn_fwd.launches == 0 and fa.attn_fwd.routes == {}
    assert fl.flash_fwd.launches == 0 and fl.flash_fwd.routes == {}
