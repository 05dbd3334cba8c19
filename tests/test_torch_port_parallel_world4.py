"""Data parallelism of the port at world 4 on the CPU (gloo), and the card
tool's pieces that need no card.

Four gloo ranks at 1 row each against one process at the whole batch of 4
(tests/torch_port_ddp.py's batch: its own mask a sample, the third sample
without its subject token, so rank 2's found-subject count is 0 and every
rank's mask count and attention maxima differ). One spawn of four ranks
runs every scenario while this process computes the one-process runs.
Bound: the trainables after the updates within 1e-5 absolute of one
process's (tests/test_trainer.py's data-parallel bound), and bitwise equal
across the ranks.

`tools/port_ddp_cards.py` holds the same path on 1, 2 and 4 cards over
NCCL; here its NCCL trace classifier runs on a synthetic trace, and its
refusal to run on fewer cards than it needs is checked.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

import torch_port_ddp as ddp
import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu_torch import zoo

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ATOL = 1e-5
SCENARIOS = [
    # the sticky freeze sets after the first update (any norm >= 0) and
    # holds the embedding at the next two, while Adam's moments move
    {'name': 'freeze', 'steps': 3, 'trainer': {'emb_norm_threshold': 0.0}},
    {'name': 'accum', 'steps': 4, 'accum': 2,
     'trainer': {'reg_full_identity': True}},
]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{'ranks': the four ranks' records, 'one': one process's}."""
    root = tmp_path_factory.mktemp('ddp4')
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    mods = root / 'modules.pt'
    torch.save({'unet': b.unet.state_dict(), 'text': b.text_encoder
                .state_dict(), 'vae': b.vae.state_dict()}, mods)
    probe = ddp.build_trainer(str(mods), None)
    batches = [ddp.global_batch(probe, s) for s in range(4)]
    scenarios = [{'name': sc['name'], 'batches': batches[:sc['steps']],
                  'accum': sc.get('accum', 1), 'trainer': sc['trainer']}
                 for sc in SCENARIOS]
    ctx = ddp.spawn(WORLD, ddp.train_rank, str(root), str(mods), scenarios)
    one = {sc['name']: ddp.run_steps(
        ddp.build_trainer(str(mods), None, **sc['trainer']),
        sc['batches'], sc['accum']) for sc in scenarios}
    ddp.join(ctx)
    ranks = [torch.load(root / f'rank{r}.pt', weights_only=False)
             for r in range(WORLD)]
    return {'ranks': ranks, 'one': one}


@pytest.mark.parametrize('name', [sc['name'] for sc in SCENARIOS])
def test_four_ranks_give_one_process_update(runs, name):
    """'freeze': 3 updates, the embedding frozen after the first;
    'accum': accumulation over 2 micro-steps with reg_full_identity (the
    found-subject count reduced over the ranks). Every rank draws the
    global batch's noise from the seeded generator and keeps its row."""
    recs = [r[name] for r in runs['ranks']]
    one = runs['one'][name]
    assert runs['ranks'][0]['backend'] == 'gloo'
    assert runs['ranks'][0]['world'] == WORLD
    for r in recs[1:]:
        assert ddp.max_diff(r['final'], recs[0]['final']) == 0.0
        assert r['losses'] == recs[0]['losses']
    assert ddp.max_diff(recs[0]['final'], one['final']) <= ATOL
    for a, c in zip(recs[0]['losses'], one['losses']):
        for k in c:
            assert a[k] == pytest.approx(c[k], rel=1e-5, abs=1e-7)


def test_every_rank_reduces_every_gradient(runs):
    """reduce_grads packs the gradients that are not None into one buffer,
    so the ranks must agree on that set at every update, also when the
    freeze flips: every leaf has its gradient on every rank (AdamW with a
    zero gradient is not AdamW without one, so nothing is zero-filled)."""
    n_leaves = len(runs['one']['freeze']['final'])
    for name in ('freeze', 'accum'):
        counts = [r[name]['n_grads'] for r in runs['ranks']]
        assert counts == [runs['one'][name]['n_grads']] * WORLD
        assert set(counts[0]) == {n_leaves}
    frozen = [r['freeze']['frozen'] for r in runs['ranks']]
    assert frozen == [[True, True, True]] * WORLD


def test_frozen_embedding_holds_on_every_rank(runs):
    """After the first update the embedding stays where it was: the four
    ranks and one process hold the same rows."""
    one = runs['one']['freeze']
    for r in runs['ranks']:
        assert r['freeze']['norms'][1:] == [r['freeze']['norms'][0]] * 2
    assert one['norms'][1:] == [one['norms'][0]] * 2


# --------------------------------------------------- tools/port_ddp_cards
@pytest.fixture(scope='module')
def tool():
    sys.path.insert(0, str(ROOT / 'tools'))
    try:
        import port_ddp_cards
    finally:
        sys.path.remove(str(ROOT / 'tools'))
    return port_ddp_cards


def _event(cat, name, ts, dur, tid=1, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'tid': tid, 'pid': 1, 'args': args}


def test_nccl_classifier_tells_the_collectives_apart(tool, tmp_path):
    """Two steps: the all-reduce launched inside mos::reduce_grads is the
    gradients', the others are all_sums; all-gathers are all_max's forward
    and reduce-scatters its backward (launched from the autograd thread);
    a kernel whose name does not say its collective takes the kind of the
    c10d `nccl:<op>` range around its launch."""
    ev = []
    for step in range(2):
        t = 1000 * step
        ev += [
            _event('cuda_runtime', 'cudaLaunchKernelExC', t + 1, 1,
                   correlation=10 * step + 1),
            _event('kernel', 'ncclDevKernel_AllReduce_Sum_f32_RING_LL',
                   t + 5, 20, correlation=10 * step + 1),
            _event('user_annotation', 'nccl:_all_gather_base', t + 29, 5),
            _event('cuda_driver', 'cuLaunchKernelEx', t + 30, 1,
                   correlation=10 * step + 2),
            _event('kernel', 'ncclDevKernel_Generic_1', t + 40, 30,
                   correlation=10 * step + 2),
            _event('cuda_driver', 'cuLaunchKernelEx', t + 100, 1, tid=2,
                   correlation=10 * step + 3),
            _event('kernel', 'ncclDevKernel_ReduceScatter_Sum_f32_RING_LL',
                   t + 110, 40, correlation=10 * step + 3),
            _event('user_annotation', 'mos::reduce_grads', t + 200, 50),
            _event('cuda_runtime', 'cudaLaunchKernelExC', t + 210, 1,
                   correlation=10 * step + 4),
            _event('kernel', 'ncclDevKernel_AllReduce_Sum_f32_RING_LL128',
                   t + 220, 500, correlation=10 * step + 4),
            _event('kernel', 'ampere_sgemm', t + 300, 9,
                   correlation=10 * step + 5)]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': ev}))
    got = tool.nccl_per_step(path, 2)
    assert got == {'grads': [0.5, 1.0], 'all_sum': [0.02, 1.0],
                   'all_max': [0.03, 1.0], 'all_max_backward': [0.04, 1.0]}


@pytest.mark.parametrize('available,count', [(False, 0), (True, 1),
                                             (True, 2), (True, 3)])
def test_card_tool_refuses_fewer_than_four_cards(tool, monkeypatch,
                                                 available, count):
    """No world is dropped and nothing falls back to gloo or the CPU: with
    fewer cards than the largest world the tool raises before it runs."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: available)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: count)
    monkeypatch.setattr(sys, 'argv', ['port_ddp_cards.py'])
    with pytest.raises(RuntimeError, match='CUDA'):
        tool.main()
