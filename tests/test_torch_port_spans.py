"""The port's spans (utils/profiling.span) on the CPU at tiny sizes, and the
benchmark's readers of them (bench_port/spans.py).

  * With no profiler running a span is one shared no-op and nothing is
    recorded, through a sampling request and a train step.
  * Under torch.profiler the spans are `mos.*` ranges of the profiler's
    host timeline and records with their parents and request ordinals:
    request ⊃ encode, denoise ⊃ n × (unet, solver), decode; the regional
    pipeline's adapter; a train step's forward ⊃ unet, backward and
    optimizer, and the loader's wait; a result read after the next request
    was queued keeps its own request's ordinal.
  * Nothing the program computes changes under the profiler: latents,
    images, the loss and the updated leaves are bitwise equal (one torch
    thread, tests/torch_port_threads.py: the CPU backward is not bitwise
    run to run with several).
  * The readers, on a hand-built trace and span list: idle time by the
    innermost span where a gap begins (also a span opened more than 64
    host operations before it, which the trace's own labeller misses),
    launch counts a span, per-request division, None for device ms on the
    CPU and for a program without spans.
"""
import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

import torch_port_threads  # noqa: F401  (one torch thread)
from bench_port import spans as readers
from bench_port.trace import Traced
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.data import DataLoader, TrainBatcher, \
    default_collate
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           RegionallyT2IAdapterPipeline)
from mixofshow_tpu_torch.pipelines.concepts import init_concepts
from mixofshow_tpu_torch.pipelines.trainer_edlora import (EDLoRATrainer,
                                                          make_optimizer)
from mixofshow_tpu_torch.utils import profiling
from mixofshow_tpu_torch.utils.profiling import SpanRecord

STEPS = 2
CONCEPTS = '<c1>+<c2>'
PROMPT = 'a photo of <c1> <c2>'
FINETUNE = {'text_embedding': {'enable_tuning': True, 'lr': 1e-3},
            'text_encoder': {'enable_tuning': True, 'lr': 1e-5,
                             'lora_cfg': {'rank': 2}},
            'unet': {'enable_tuning': True, 'lr': 1e-4,
                     'lora_cfg': {'rank': 2}}}


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.reset()
    yield
    profiling.reset()


def _tiny(seed=0):
    b = zoo.load_models('random:tiny', 'cpu', seed=seed)
    cfg, table = init_concepts(b.tokenizer, CONCEPTS, None,
                               b.text_encoder.token_embedding.weight)
    return b, cfg, table


@pytest.fixture(scope='module')
def pipe():
    b, cfg, table = _tiny()
    return EDLoRAPipeline(b.unet, b.text_encoder, b.vae, b.tokenizer, 'cpu',
                          torch.float32, new_concept_cfg=cfg,
                          concept_embedding=table)


@pytest.fixture(scope='module')
def regional():
    b, cfg, table = _tiny(1)
    return RegionallyT2IAdapterPipeline(
        b.unet, b.text_encoder, b.vae, b.tokenizer, 'cpu', torch.float32,
        new_concept_cfg=cfg, concept_embedding=table,
        keypose_adapter=zoo.load_t2i_adapter('keypose', 'tiny', 'cpu'))


def _latents(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, 4, 8, 8), generator=g)


def _submit(pipe, seed, output_type='uint8'):
    return pipe.submit([PROMPT], height=64, width=64,
                       num_inference_steps=STEPS, negative_prompt='blurry',
                       latents=_latents(seed), output_type=output_type)


class _Items:
    """Four 64×64 concept images with masks and captions."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        mask = np.zeros((8, 8, 1), np.float32)
        mask[2:6, 2:6] = 1.0
        return {'images': rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
                'masks': mask, 'img_masks': np.ones((64, 64, 1), np.float32),
                'prompts': PROMPT}


@pytest.fixture(scope='module')
def trainer():
    b = zoo.load_models('random:tiny', 'cpu', seed=2)
    tr = EDLoRATrainer(b.unet, b.text_encoder, b.vae, b.tokenizer, 'cpu',
                       new_concept_token=CONCEPTS,
                       initializer_token='<rand-0.013>+<rand-0.017>',
                       finetune_cfg=FINETUNE, attn_reg_weight=0.01,
                       reg_full_identity=False, noise_offset=0.01,
                       compute_dtype=torch.float32)
    return tr, TrainBatcher(tr.tokenizer, tr.new_concept_cfg)


def _train_step(trainer):
    """One step from a fresh state and a fresh loader: (loss dict, leaves
    after)."""
    tr, batcher = trainer
    loader = DataLoader(_Items(), batch_size=2, seed=0,
                        collate_fn=lambda it: batcher(default_collate(it)))
    state = tr.init_state(make_optimizer(FINETUNE, total_steps=10))
    batch = next(iter(loader))
    loss = tr.train_step(state, batch,
                         torch.Generator().manual_seed(3))
    leaves = [state.trainable['concept_embedding']] + [
        t for key in ('text_lora', 'unet_lora')
        for leaf in _flat(state.trainable[key]) for t in leaf]
    return ({k: v.detach().clone() for k, v in loss.items()},
            [t.detach().clone() for t in leaves])


def _flat(tree):
    if isinstance(tree, dict) and set(tree) == {'down', 'up'}:
        return [(tree['down'], tree['up'])]
    return [x for k in sorted(tree) for x in _flat(tree[k])]


def _kineto(prof):
    """[(start ns, end ns, name)] of the profile's mos.* host ranges."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith('mos.'))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _children(recs, parent):
    i = recs.index(parent)
    return [r for r in recs if r.parent == i]


# ------------------------------------------------------------------ off
def test_spans_are_one_shared_noop_without_a_profiler(pipe, trainer):
    assert profiling.span('unet', 'cpu') is profiling.OFF
    assert profiling.span('request', 'cpu', root=True) is profiling.OFF
    with profiling.span('x') as rec:
        assert rec is None
    _submit(pipe, 0).result()
    _train_step(trainer)
    assert profiling.spans() == [] and profiling.last_request() is None


# ------------------------------------------------------------------- on
def test_sampling_spans_nest_and_results_keep_their_request(pipe):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = _submit(pipe, 0)
        b = _submit(pipe, 1)           # queued before a is read
        a.result()
        b.result()
    recs = profiling.spans()
    roots = [r for r in recs if r.name == 'request']
    assert [r.request for r in roots] == [0, 1]
    assert all(r.parent is None for r in roots)
    for root in roots:
        kids = _children(recs, root)
        assert [k.name for k in kids] == ['encode', 'denoise', 'decode']
        assert all(k.request == root.request for k in kids)
        steps = _children(recs, kids[1])
        assert [k.name for k in steps] == ['unet', 'solver'] * STEPS
    results = [r for r in recs if r.name == 'result']
    assert [(r.request, r.parent) for r in results] == [(0, None),
                                                        (1, None)]
    assert recs.index(results[0]) > recs.index(roots[1])
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns and r.device_ms is None

    ranges = _kineto(prof)
    names = [n for _, _, n in ranges]
    for n, k in (('request', 2), ('encode', 2), ('denoise', 2),
                 ('unet', 2 * STEPS), ('solver', 2 * STEPS), ('decode', 2),
                 ('result', 2)):
        assert names.count('mos.' + n) == k, n
    by = {n: [r for r in ranges if r[2] == 'mos.' + n]
          for n in ('request', 'encode', 'denoise', 'unet', 'decode')}
    for n in ('encode', 'denoise', 'decode'):
        assert all(any(_inside(r, q) for q in by['request']) for r in by[n])
    assert all(any(_inside(r, q) for q in by['denoise'])
               for r in by['unet'])


def test_regional_request_has_an_adapter_span(regional):
    pose = Image.fromarray(np.full((64, 64, 3), 255, np.uint8))
    layout = [('two people', [('<c1> <c2>', '', [0.0, 0.0, 1.0, 0.5])])]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        regional(layout, keypose_adapter_input=pose, height=64, width=64,
                 num_inference_steps=STEPS, output_type='uint8')
    recs = profiling.spans()
    root = recs[0]
    assert root.name == 'request' and root.request == 0
    assert [k.name for k in _children(recs, root)] == [
        'encode', 'adapter', 'denoise', 'decode']
    assert [r.request for r in recs if r.name == 'result'] == [0]
    assert 'mos.adapter' in [n for _, _, n in _kineto(prof)]


def test_train_step_spans_and_the_loader_wait(trainer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train_step(trainer)
    recs = profiling.spans()
    wait = [r for r in recs if r.name == 'data.wait']
    root = [r for r in recs if r.name == 'train.step']
    assert len(root) == 1 and root[0].parent is None
    assert wait and all(r.parent is None and r.request == root[0].request
                        for r in wait)
    kids = _children(recs, root[0])
    assert [k.name for k in kids] == ['train.forward', 'train.backward',
                                      'train.optimizer']
    assert [k.name for k in _children(recs, kids[0])] == ['unet']
    names = {n for _, _, n in _kineto(prof)}
    assert {'mos.train.step', 'mos.train.forward', 'mos.train.backward',
            'mos.train.optimizer', 'mos.data.wait', 'mos.unet'} <= names


def test_the_profiler_changes_nothing_the_program_computes(pipe, trainer):
    def sample():
        return [_submit(pipe, 5, t).result() for t in ('latent', 'uint8')]

    plain, plain_step = sample(), _train_step(trainer)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, traced_step = sample(), _train_step(trainer)
    assert profiling.spans()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    assert plain_step[0].keys() == traced_step[0].keys()
    for k in plain_step[0]:
        assert torch.equal(plain_step[0][k], traced_step[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(plain_step[1],
                                                 traced_step[1]))


def test_trace_exports_the_spans_of_its_block(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span('request', root=True):
            pass
    with profiling.trace(str(tmp_path), 'cpu'):
        with profiling.span('data.wait'):
            torch.ones(4).sum()
    assert [r.name for r in profiling.spans()] == ['data.wait']
    assert 'mos.data.wait' in (tmp_path / 'trace.json').read_text()


# -------------------------------------------------------------- readers
def _rec(name, start, end, request=0, parent=None, device_ms=None):
    return SpanRecord(name, request, parent, start, end, device_ms)


def test_idle_time_goes_to_the_innermost_span_without_a_look_back():
    # a request [0, 10000) holding one UNet eval [1000, 9000) whose 100
    # aten ops end at 5990; the device runs [0, 1500) and [7000, 8000)
    ops = [(1000 + 50 * i, 1040 + 50 * i, 'aten::add') for i in range(100)]
    host = sorted([(0, 10000, 'mos.request'), (1000, 9000, 'mos.unet'),
                   (9000, 9500, 'mos.solver')] + ops)
    dev = [(0, 1500, 'k0'), (7000, 8000, 'k1')]
    t = Traced(dev, host, (0, 12000))
    # gaps [1500, 7000) and [8000, 12000) both begin inside the UNet span
    assert dict(readers.idle_by_span(t)) == {'mos.unet': 5500 + 4000}
    # the trace's own labeller, 64 operations back, loses the second
    assert dict(t.idle_gaps()) == {'aten::add': 5.5e-6,
                                   'no host operation': 4e-6}
    # a result span and a gap outside every span
    host = sorted(host + [(11000, 11500, 'mos.result')])
    dev += [(10500, 11000, 'k2'), (12000, 12500, 'k3')]
    t = Traced(sorted(dev), host, (0, 13000))
    assert dict(readers.idle_by_span(t)) == {
        'mos.unet': 5500 + 2500, 'mos.result': 1000, None: 500}
    assert readers.idle_in_unet_pct({'traced': t}) == pytest.approx(
        100 * 8000 / 9500)
    # a trace without spans (a program that has none) reads nothing
    assert readers.idle_in_unet_pct(
        {'traced': Traced(dev, ops, (0, 13000))}) is None


def test_launches_are_counted_inside_each_span():
    host = [(0, 100, 'mos.unet'), (200, 300, 'mos.unet')]
    host += [(10 * i, 10 * i + 5, 'cudaLaunchKernel') for i in range(4)]
    host += [(250, 255, 'cuLaunchKernel'), (260, 265, 'cudaLaunchKernelExC'),
             (150, 155, 'cudaLaunchKernel'), (270, 275, 'cudaMemcpyAsync')]
    t = Traced([], sorted(host), (0, 400))
    assert readers.launches_per_unet({'traced': t}) == (4 + 2) / 2
    assert readers.launches_per_unet({'traced': Traced([], [], (0, 1))}) \
        is None


def test_span_readers_divide_by_the_traced_requests():
    recs = [_rec('request', 0, 10 ** 7), _rec('encode', 0, 2 * 10 ** 6,
                                              parent=0),
            _rec('unet', 2 * 10 ** 6, 5 * 10 ** 6, parent=0),
            _rec('unet', 5 * 10 ** 6, 6 * 10 ** 6, parent=0),
            _rec('request', 10 ** 7, 2 * 10 ** 7, request=1),
            _rec('encode', 10 ** 7, 11 * 10 ** 6, request=1, parent=4),
            _rec('data.wait', 0, 4 * 10 ** 6)]
    ctx = {'spans': recs, 'trace_window': {'requests': 2}}
    assert readers.text_host_ms(ctx) == pytest.approx((2 + 1) / 2)
    assert readers.unet_host_ms(ctx) == pytest.approx((3 + 1) / 2)
    assert readers.data_wait_ms(ctx) == pytest.approx(4 / 2)
    assert readers.result_wait_ms(ctx) is None
    # on the CPU no record has device ms
    assert readers.unet_device_ms(ctx) is None
    assert readers.decode_device_ms(ctx) is None
    on_card = [_rec('unet', 0, 1, device_ms=3.0),
               _rec('unet', 1, 2, device_ms=5.0),
               _rec('decode', 2, 3, device_ms=8.0)]
    ctx = {'spans': on_card, 'trace_window': {'requests': 2}}
    assert readers.unet_device_ms(ctx) == 4.0
    assert readers.decode_device_ms(ctx) == 4.0
    # a program that keeps no span records
    none = {'spans': None, 'trace_window': {'requests': 2}}
    assert readers.forward_host_ms(none) is None


def test_span_readers_on_a_cpu_run_of_the_program(pipe):
    with profile(activities=[ProfilerActivity.CPU]):
        _submit(pipe, 0).result()
    ctx = {'trace_window': {'requests': 1}}
    assert readers.unet_host_ms(ctx) > 0 and readers.text_host_ms(ctx) > 0
    assert readers.result_wait_ms(ctx) > 0
    assert readers.unet_device_ms(ctx) is None
    assert readers.decode_device_ms(ctx) is None
