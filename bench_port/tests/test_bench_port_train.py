"""The training cell driven through the harness on the CPU at tiny widths:
the program's first steps against the plain reference (to rounding in
float32, within the cell's limits in bfloat16), each control the cell's
file holds to its limits (the reference with float8 operands, the
reference on half of each batch), run through the harness in the
program's place, outside them, and the timed path broken
underneath (an update that leaves the state unchanged, half of the batch
left out, a gradient altered where it is made) read as not correct."""
from __future__ import annotations

import pytest
import torch

from bench_port import check, run
from bench_port import manifest as mf
from bench_port.tests.tiny import TinyManifest

M = mf.Manifest()
CELLS = [w['name'] for w in M.data['workloads']
         if M.traffic(w)['driver'] == 'edlora_train']
CPU = torch.device('cpu')
SEED = 2 ** 32 + 2 ** 31 + 23     # past 32 bits: the driver folds it


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def workload(tmp_path, cell):
    m = TinyManifest(tmp_path)
    w = m.cell(cell)
    cfg, mix = m.config(w), m.traffic(w)
    return m, cfg, mf.driver(mix['driver']).Workload(cfg, mix, SEED, CPU)


@pytest.mark.parametrize('cell', CELLS)
def test_float32_steps_are_the_reference(cell, tmp_path):
    """The reference's start, batches, loss, regularizer and AdamW are the
    program's: in float32 they agree to rounding."""
    _, _, w = workload(tmp_path, cell)
    w.setup(dtype=torch.float32)
    check.free_program(w)
    g = w.reference_gaps(SEED, CPU, [], 0)[0]
    w.close()
    assert g['loss_rel'] < 1e-5 and g['grad_max'] < 1e-4 and \
        g['change_max'] < 1e-3, g


@pytest.mark.parametrize('cell', CELLS)
def test_a_run_is_correct_and_reports_its_metrics(cell, tmp_path):
    m, _, _ = workload(tmp_path, cell)
    out = run.run_cell(m, cell, SEED, 0.5, 1, CPU)
    assert out['correct'], out['checks']
    assert out['attempted'] >= 1 and out['failed'] == 0
    assert 'train_step_s' not in out['metrics']
    assert {'loader_wait_ms.train', 'mfu.train'} <= set(out['metrics'])


CONTROLS = [(c, k) for c in CELLS
            for k in M.judgement(M.cell(c))['controls']]


@pytest.mark.parametrize('cell,control', CONTROLS)
def test_each_control_is_not_correct(cell, control, tmp_path):
    m, _, _ = workload(tmp_path, cell)
    out = run.run_cell(m, cell, SEED, 0.2, 0, CPU, control=control)
    assert not out['correct'], out['checks']


def _no_update(build_opt):
    def build_(self, trainable):
        opt, sched = build_opt(self, trainable)
        opt.step = lambda *a, **k: None
        return opt, sched
    return build_


def _half_batch(loss_fn):
    def loss(self, trainable, batch, generator=None, draws=None):
        half = {k: v[:max(1, len(v) // 2)] for k, v in batch.items()}
        return loss_fn(self, trainable, half, generator, draws)
    return loss


def _doubled(reduce):
    def reduce_(params, mesh):
        params = list(params)
        reduce(params, mesh)
        for p in params:
            if p.grad is not None:
                p.grad.mul_(2.0)
    return reduce_


def _patch(mp, name, wrap):
    from mixofshow_tpu_torch.pipelines import trainer_edlora as te
    owner, attr = {'build': (te.OptimizerConfig, 'build'),
                   'loss_fn': (te.EDLoRATrainer, 'loss_fn'),
                   'reduce_grads': (te, 'reduce_grads')}[name]
    mp.setattr(owner, attr, wrap(getattr(owner, attr)))


FAULTS = {'state_unchanged': ('build', _no_update),
          'half_of_the_batch': ('loss_fn', _half_batch),
          'gradient_altered': ('reduce_grads', _doubled)}


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('cell', CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path,
                                            monkeypatch):
    m, _, _ = workload(tmp_path, cell)
    _patch(monkeypatch, *FAULTS[fault])
    out = run.run_cell(m, cell, SEED, 0.2, 0, CPU)
    assert not out['correct'], out['checks']
